"""Copy of ``src/repro/models/config.py`` (the port imports nothing of
``repro``).

Model configuration system for the architecture zoo.

Every assigned architecture is a `ModelConfig`; `reduced()` produces the
CPU-smoke-test variant of the same family (same code paths, tiny sizes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden size
    capacity_factor: float = 1.25
    # sharding when n_experts doesn't divide the 'model' axis:
    # 'hidden_tp' (baseline) | 'token_parallel' (§Perf optimization)
    fallback: str = "hidden_tp"
    # dispatch implementation: 'gspmd' (baseline — sort/scatter left to
    # the SPMD partitioner) | 'shard_map' (§Perf: explicit expert-local
    # bucketing + one psum over 'model')
    dispatch: str = "gspmd"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64        # N (Mamba2 state / mLSTM head dim basis)
    conv_width: int = 4
    expand: int = 2
    chunk: int = 128           # chunked-scan block length
    n_heads: int = 8           # SSD / mLSTM heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense|ssm|moe|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"        # swiglu|geglu|gelu
    norm: str = "rms"          # rms|nonparametric
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Block pattern, tiled over depth.  Entries: 'attn' (own weights,
    # scanned), 'mamba', 'mlstm', 'slstm', 'attn_shared' (one set of
    # weights reused at every occurrence — zamba2).
    block_pattern: tuple = ("attn",)
    frontend: Optional[str] = None   # None|'audio_stub'|'vision_stub'
    n_patches: int = 256             # vlm stub: patch-embedding count
    subquadratic: bool = False       # can run long_500k
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # --- beyond-paper performance knobs (False/defaults = faithful
    # baseline recorded in EXPERIMENTS.md §Roofline; see §Perf) ---
    attn_mixed_precision: bool = False   # bf16 einsums w/ fp32 accum
    remat_policy: str = "full"           # full | dots | none
    attn_impl: str = "chunked"           # chunked | full (train/prefill)
    ssm_local_gla: bool = False          # batch-shard GLA inputs (no
                                         # per-chunk/step model-axis chatter)

    # ------------------------------------------------------------ derived
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def pattern_for_depth(self) -> tuple:
        """Tile block_pattern to exactly n_layers entries."""
        p = []
        while len(p) < self.n_layers:
            p.extend(self.block_pattern)
        return tuple(p[: self.n_layers])

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab
        total = v * d                                   # embedding
        if not self.tie_embeddings:
            total += v * d                              # lm head
        for kind in self.pattern_for_depth():
            if kind in ("attn", "attn_shared"):
                attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.moe is not None:
                    ff = self.moe.n_experts * 3 * d * self.moe.d_expert \
                        + d * self.moe.n_experts
                elif self.d_ff > 0:
                    mult = 3 if self.act in ("swiglu", "geglu") else 2
                    ff = mult * d * self.d_ff
                else:
                    ff = 0
                total += attn + ff
            elif kind == "mamba":
                di = self.ssm.expand * d
                total += 2 * d * di + di * d + di * (2 * self.ssm.state_dim)
            elif kind in ("mlstm", "slstm"):
                di = self.ssm.expand * d
                total += 2 * d * di + di * d + 3 * di
        return int(total)

    def active_params_per_token(self) -> int:
        """MoE-aware active parameter count (for MODEL_FLOPS = 6*N_active*D)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * (
            self.moe.n_experts * 3 * d * self.moe.d_expert)
        active_ff = self.n_layers * self.moe.top_k * 3 * d * self.moe.d_expert
        return int(dense + active_ff)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=max(2, len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_patches=4,
            remat=False,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=32)
        else:
            kw["moe"] = None
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_dim=8, conv_width=4, expand=2,
                                  chunk=8, n_heads=2)
        else:
            kw["ssm"] = None
        return ModelConfig(**kw)
