"""Generic decoder-only model (twin of ``repro/models/transformer.py``),
ported for the block kinds ``attn``, ``attn_shared``, ``mamba``,
``mlstm`` and ``slstm``, with a dense or token-choice MoE FFN and the
audio and vision stub frontends: the serving path of every config in the
registry.

A model is a ``block_pattern`` unit tiled over depth.  Parameters keep the
reference's layout: ``params["unit"][i]`` holds the weights of unit
position i stacked over the ``reps`` repetitions (axis 0),
``params["rem"]`` the remainder blocks, and ``attn_shared`` positions hold
``None`` because their weights live once, in ``params["shared_attn"]``
(zamba2), with one KV cache per occurrence.  The reference's
``lax.scan`` over repetitions is a Python loop here.  Its sharding
annotations are the same calls at the same sites
(``parallel/annotate.py``): on a device mesh they redistribute DTensor
activations, without one they return their argument unchanged.

Inputs (``_frontend_embed``): token ids; for the audio stub (musicgen)
precomputed frame embeddings instead; for the vision stub (paligemma)
patch embeddings put in front of the token embeddings, so a prompt of S
tokens fills ``n_patches + S`` positions.

Modes: 'train' (full-sequence forward, differentiated by ``lm_loss``),
'prefill' (the same forward, filling the decode state) and 'decode' (one
token against the carried state).  Train and prefill run attention through
the ``flash_attention`` kernel and the Mamba2 and mLSTM scans through
the ``mamba2_scan`` kernel; both backends default to "cuda" on the card
and "torch" (the plain versions) on the CPU.  Under autograd each kernel
runs forward and the plain version's gradient backward (the kernels'
``autograd.Function``s).  The sLSTM recurrence and the MoE's dispatch and
expert products are plain PyTorch on either.

Mixed precision is the reference's: each block casts its float32
matrices to the compute dtype at use (``cast_block_params``), the
embedding rows after the lookup and the head at the product, so a weight
used more than once (the shared attention, a tied embedding) gathers its
gradient in float32.  Serving casts once at load (``cast_params``), which
makes those casts no-ops.  Training (``lm_loss``) takes the float32
parameters as they are; with ``cfg.remat`` each repetition of the unit
runs under activation checkpointing, as the reference's
``jax.checkpoint`` over its scan body, and runs forward again in the
backward pass: all of it under policy "full" (``nothing_saveable``), all
but the matrix products without a batch dim under "dots"
(``dots_with_no_batch_dims_saveable``: the ``mm`` / ``addmm`` outputs
are kept, while ``bmm``, the kernels' Functions and the elementwise ops
run again).  ``cfg.attn_mixed_precision`` rounds the attention
probabilities to the compute dtype before their product with v in the
plain version (prefill, train and decode); the flash kernels compute
their fp32-P mode either way (``kernels/flash_attention/ops.py``).

State: decode writes the new token's K and V into the caches it is given,
in place, and prefill writes the prompt's (the reference returns updated
copies; here a cache copy per step is avoided).  SSD, mLSTM and sLSTM
states and conv tails are returned as new tensors, as in the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.device import resolve_device
from ..core.nn import keep_grad_layout, tree_map
from ..kernels.flash_attention import ops as fa_ops
from ..parallel.annotate import (BATCH, constrain, constrain_batch,
                                 replicate_like)
from .attention import decode_attention
from .common import (IGNORE_ID, apply_norm, apply_rope, cast_block_params,
                     cross_entropy_loss, dense_init, dtype_of, embed_init,
                     embed_lookup, softcap)
from .config import ModelConfig
from .mlp import dense_ffn, init_dense_ffn, init_moe_ffn, moe_ffn
from .ssm import (init_mamba2, init_mlstm, init_slstm, mamba2_forward,
                  mamba2_step, mlstm_forward, mlstm_step, slstm_forward,
                  slstm_init_state, slstm_step)

ATTN_KINDS = ("attn", "attn_shared")
SSM_INIT = {"mamba": init_mamba2, "mlstm": init_mlstm, "slstm": init_slstm}
PORTED_KINDS = ATTN_KINDS + tuple(SSM_INIT)
UNPORTED = "not ported to repro_torch yet (ROADMAP A11)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for parts of the model not ported."""
    kinds = sorted(set(cfg.block_pattern) - set(PORTED_KINDS))
    if kinds:
        raise NotImplementedError(f"{cfg.name}: block kinds {kinds} are "
                                  f"{UNPORTED}")


# ==================================================================== init
def _zeros(gen, *shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def _init_attn_block(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    p = {"wq": dense_init(gen, d, cfg.q_dim, dtype),
         "wk": dense_init(gen, d, cfg.kv_dim, dtype),
         "wv": dense_init(gen, d, cfg.kv_dim, dtype),
         "wo": dense_init(gen, cfg.q_dim, d, dtype)}
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, cfg.q_dim, dtype=dtype)
        p["bk"] = _zeros(gen, cfg.kv_dim, dtype=dtype)
        p["bv"] = _zeros(gen, cfg.kv_dim, dtype=dtype)
    if cfg.norm == "rms":
        p["ln1"] = _zeros(gen, d, dtype=dtype)
        p["ln2"] = _zeros(gen, d, dtype=dtype)
    if cfg.moe is not None:
        p["moe"] = init_moe_ffn(gen, d, cfg.moe, cfg.act, dtype)
    elif cfg.d_ff > 0:
        p["ffn"] = init_dense_ffn(gen, d, cfg.d_ff, cfg.act, dtype)
    return p


def _init_block(gen, kind: str, cfg: ModelConfig, dtype):
    if kind in ATTN_KINDS:
        return _init_attn_block(gen, cfg, dtype)
    norm = ({"ln1": _zeros(gen, cfg.d_model, dtype=dtype)}
            if cfg.norm == "rms" else {})
    return {**norm, "core": SSM_INIT[kind](gen, cfg.d_model, cfg.ssm, dtype)}


def unit_and_reps(cfg: ModelConfig):
    unit = tuple(cfg.block_pattern)
    reps = cfg.n_layers // len(unit)
    rem = cfg.pattern_for_depth()[reps * len(unit):]
    return unit, reps, rem


def _stack(trees):
    """Stack a list of like trees (dicts, tuples, tensors) on a new axis 0."""
    if not trees:
        raise ValueError("a model needs at least one repetition of its unit")
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(parts)) for parts in zip(*trees))
    return torch.stack(trees)


def init_params(cfg: ModelConfig, seed: int | torch.Generator = 0,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters in ``cfg.param_dtype``, drawn from ``seed`` (a
    torch generator, whose device they take, or an int seeding one on
    ``device``).  The draws are torch's, not the reference's;
    ``models/convert.py`` carries reference parameters across."""
    check_supported(cfg)
    gen = (seed if isinstance(seed, torch.Generator) else
           torch.Generator(resolve_device(device)).manual_seed(seed))
    dtype = dtype_of(cfg.param_dtype)
    unit, reps, rem = unit_and_reps(cfg)
    params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    if cfg.norm == "rms":
        params["final_norm"] = _zeros(gen, cfg.d_model, dtype=dtype)
    if "attn_shared" in unit or "attn_shared" in rem:
        params["shared_attn"] = _init_attn_block(gen, cfg, dtype)
    params["unit"] = [
        None if kind == "attn_shared"
        else _stack([_init_block(gen, kind, cfg, dtype) for _ in range(reps)])
        for kind in unit]
    params["rem"] = [None if kind == "attn_shared"
                     else _init_block(gen, kind, cfg, dtype) for kind in rem]
    return params


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """Cast once, at load, what the reference casts at every use:
    matrices to the compute dtype, vectors kept fp32 (the rule of
    ``cast_block_params``; unit leaves carry a leading repetition axis),
    so that ``model_apply``'s casts at use are no-ops.  The embedding and
    head are matrices too: the reference casts their rows at lookup and
    the whole matrix at the head, which gives the same values."""
    cdt = dtype_of(cfg.compute_dtype)
    out = {k: cast_block_params(v, cdt) for k, v in params.items()
           if k != "unit"}
    out["unit"] = [cast_block_params(p, cdt, stacked=True)
                   for p in params["unit"]]
    return out


# ================================================================== state
def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16,
                      device: str | torch.device = "cuda") -> dict:
    """Per-layer decode state, stacked like the params (unit/rem lists):
    (K cache, V cache) per attention occurrence, (SSD state, conv tail)
    per Mamba2 block, the (B, H, P + 1, P) matrix state per mLSTM block,
    (c, n, m, h) per sLSTM block.  Caches and tails in ``dtype``, the
    recurrent states fp32 (fp64 when ``dtype`` is)."""
    check_supported(cfg)
    device = resolve_device(device)
    unit, reps, rem = unit_and_reps(cfg)

    def one(kind, lead=()):
        z = lambda *s, dt=dtype: torch.zeros(*lead, batch, *s, dtype=dt,
                                             device=device)
        if kind in ATTN_KINDS:
            kv = (cache_len, cfg.n_kv_heads, cfg.head_dim)
            return (z(*kv), z(*kv))          # two buffers: written in place
        di = cfg.ssm.expand * cfg.d_model
        H, N = cfg.ssm.n_heads, cfg.ssm.state_dim
        P = di // H
        wide = torch.float64 if dtype == torch.float64 else torch.float32
        if kind == "mlstm":
            return z(H, P + 1, P, dt=wide)
        if kind == "slstm":
            return slstm_init_state((*lead, batch, H, cfg.d_model // H),
                                    wide, device)
        return (z(H, P, N, dt=wide), z(cfg.ssm.conv_width - 1, di))

    return {"unit": [one(kind, (reps,)) for kind in unit],
            "rem": [one(kind) for kind in rem]}


# ================================================================= blocks
def _attn_block_apply(p, cfg: ModelConfig, x, positions, mode, cache,
                      cache_pos, backend):
    """-> (x, cache, the MoE's aux loss or None)."""
    B, S, _ = x.shape
    h = apply_norm(cfg.norm, x, p.get("ln1"))

    def proj(w, b, heads):
        y = h @ p[w]
        if cfg.qkv_bias:
            y = y + p[b].to(h.dtype)
        return constrain(y.reshape(B, S, heads, cfg.head_dim),
                         BATCH, None, "model", None)

    q = apply_rope(proj("wq", "bq", cfg.n_heads), positions, cfg.rope_theta)
    k = apply_rope(proj("wk", "bk", cfg.n_kv_heads), positions,
                   cfg.rope_theta)
    v = proj("wv", "bv", cfg.n_kv_heads)

    if mode == "decode":
        kc, vc = cache
        if not 0 <= cache_pos < kc.shape[1]:
            raise IndexError(f"decode position {cache_pos} outside the "
                             f"{kc.shape[1]}-position KV cache")
        kc[:, cache_pos] = k[:, 0]
        vc[:, cache_pos] = v[:, 0]
        attn = decode_attention(q, kc, vc, cache_pos,
                                mixed=cfg.attn_mixed_precision)
    else:
        # both of the reference's train/prefill paths (attn_impl "full" and
        # "chunked") compute this one function
        attn = fa_ops.flash_attention(q, k, v, causal=True, backend=backend,
                                      mixed=cfg.attn_mixed_precision)
        if mode == "prefill":
            kc, vc = cache
            kc[:, :S] = k
            vc[:, :S] = v
    x = constrain_batch(x + attn.reshape(B, S, cfg.q_dim) @ p["wo"])
    if cfg.moe is None and cfg.d_ff <= 0:
        return x, cache, None
    h2 = apply_norm(cfg.norm, x, p.get("ln2"))
    if cfg.moe is not None:
        ff, aux = moe_ffn(p["moe"], h2, cfg.moe, cfg.act)
        return constrain_batch(x + ff), cache, aux
    return constrain_batch(x + dense_ffn(p["ffn"], h2, cfg.act)), cache, None


def _ssm_block_apply(kind, p, cfg: ModelConfig, x, mode, state, backend):
    h = apply_norm(cfg.norm, x, p.get("ln1"))
    local = cfg.ssm_local_gla
    if kind == "mlstm":
        if mode == "decode":
            y, st = mlstm_step(p["core"], h, cfg.ssm, state)
        else:
            y, st = mlstm_forward(p["core"], h, cfg.ssm, state,
                                  backend=backend, local_gla=local)
        return constrain_batch(x + y), st
    if kind == "slstm":
        if mode == "decode":
            y, st = slstm_step(p["core"], h, cfg.ssm, state)
        else:
            y, st = slstm_forward(p["core"], h, cfg.ssm, state,
                                  local_gla=local)
        return constrain_batch(x + y), st
    if mode == "decode":
        ssd, tail = state
        y, ssd, tail = mamba2_step(p["core"], h, cfg.ssm, ssd, tail)
        return x + y, (ssd, tail)
    y, ssd = mamba2_forward(p["core"], h, cfg.ssm,
                            state[0] if state is not None else None,
                            backend=backend, local_gla=local)
    y = constrain_batch(y)
    tail = state[1] if state is not None else None
    if mode == "prefill":
        di = cfg.ssm.expand * cfg.d_model
        W1, S = cfg.ssm.conv_width - 1, h.shape[1]
        tail = h[:, max(S - W1, 0):, :] @ p["core"]["w_in"][:, di:2 * di]
        # a prompt shorter than the conv's history: zeros before it, the
        # padding _causal_conv applies
        tail = F.pad(tail, (0, 0, W1 - tail.shape[1], 0))
    return x + y, (ssd, tail)


# ================================================================ forward
def _compute_dtype(params, cfg: ModelConfig) -> torch.dtype:
    """The dtype the model computes in: the config's, or float64 for a
    float64 copy of the parameters (a numerics reference)."""
    emb = params["embed"]
    return emb.dtype if emb.dtype == torch.float64 else dtype_of(
        cfg.compute_dtype)


def _frontend_embed(params, cfg: ModelConfig, batch: dict, cdt):
    """The model's input (B, S, D) in the compute dtype ``cdt``.  Audio
    stub: ``batch["frames"]`` (B, S, D), precomputed frame embeddings.
    Otherwise the embedded ``batch["tokens"]`` (rows looked up, then cast,
    as the reference does; scaled by sqrt(d_model) when the embedding is
    tied), and for the vision stub ``batch["patches"]`` (B, n_patches, D),
    when given, in front of them."""
    if cfg.frontend == "audio_stub":
        return batch["frames"].to(cdt)
    x = embed_lookup(params["embed"], batch["tokens"]).to(cdt)
    if cfg.tie_embeddings:
        scale = float(np.sqrt(np.float32(cfg.d_model)))   # fp32, as in jnp
        x = x * torch.tensor(scale, dtype=x.dtype)
    if cfg.frontend == "vision_stub" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def _lm_head(params, cfg: ModelConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return softcap(x @ w.to(x.dtype), cfg.logit_softcap)


def _unstack(tree, n: int) -> list:
    """The inverse of ``_stack``: one like tree per index of axis 0, as
    views (``unbind``: their gradients stack back in one copy)."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(t, n) for t in tree]
        return [type(tree)(p[r] for p in parts) for r in range(n)]
    return list(torch.unbind(tree))


# the matrix products without a batch dim: what "dots" keeps (``x @ w``
# on a (B, S, D) ``x`` is an ``mm`` on a view of it)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# the checkpoint's arguments of each policy
_REMAT_KWARGS = {
    "full": {},
    "dots": {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}}


def _remat(cfg: ModelConfig) -> dict | None:
    """The ``checkpoint`` arguments each repetition of the unit runs
    under (``cfg.remat`` with policy "full" or "dots", when a backward
    pass can follow), or None: no activation checkpointing."""
    if not (cfg.remat and cfg.remat_policy != "none"
            and torch.is_grad_enabled()):
        return None
    if cfg.remat_policy not in _REMAT_KWARGS:
        raise ValueError(f"{cfg.name}: unknown remat_policy "
                         f"{cfg.remat_policy!r}")
    return _REMAT_KWARGS[cfg.remat_policy]


def model_apply(params, cfg: ModelConfig, batch: dict, mode: str = "train",
                state=None, cache_pos: int | None = None,
                attn_backend: str | None = None,
                ssm_backend: str | None = None):
    """Returns (logits, new_state, aux_loss), the aux loss the sum of the
    MoE layers' (0 without MoE).  ``params``: float32 (``init_params``,
    cast at use) or as ``cast_params`` returns them (``launch/serve.py::
    load_model`` casts at load).  ``batch``: ``tokens`` (B, S) token ids
    (decode: (B, 1)); the audio stub's ``frames`` (B, S, D) instead; the
    vision stub's ``patches`` (B, n_patches, D) beside the tokens at train
    and prefill.  train: no state; prefill: ``state`` from
    ``init_decode_state``, caches filled from position 0; decode: the
    carried state, ``cache_pos`` the position of the token (after the
    patches, for the vision stub)."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    unit, reps, rem = unit_and_reps(cfg)
    cdt = _compute_dtype(params, cfg)
    x = constrain_batch(_frontend_embed(params, cfg, batch, cdt))
    B, S, _ = x.shape
    default = "cuda" if x.device.type == "cuda" else "torch"
    attn_backend = attn_backend or default
    ssm_backend = ssm_backend or default
    if mode == "decode":
        positions = torch.full((B, 1), cache_pos, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    shared = params.get("shared_attn")

    def block(kind, p, x, st):
        """One block, its weights cast at use -> (x, state, aux or None)."""
        if kind not in ATTN_KINDS:
            return (*_ssm_block_apply(kind, cast_block_params(p, cdt), cfg,
                                      x, mode, st, ssm_backend), None)
        w = shared if kind == "attn_shared" else p
        return _attn_block_apply(cast_block_params(w, cdt), cfg, x,
                                 positions, mode, st, cache_pos,
                                 attn_backend)

    def unit_rep(x, ps, sts):
        """One repetition of the unit -> (x, its states, the summed aux)."""
        aux = torch.zeros((), device=x.device)
        new = []
        for kind, p, st in zip(unit, ps, sts):
            x, st, a = block(kind, p, x, st)
            new.append(st)
            if a is not None:
                aux = aux + a
        return x, new, aux

    remat = None if state is not None else _remat(cfg)
    aux_total = torch.zeros((), device=x.device)
    unit_params = list(zip(*(_unstack(p, reps) for p in params["unit"])))
    new_unit = [[] for _ in unit]
    for r, ps in enumerate(unit_params):
        # on a mesh, each repetition's weight gradients are reduced as its
        # backward ends (the node made here runs just after it), not held
        # as partial sums until the stack of every repetition's is made
        ps = tree_map(keep_grad_layout, ps)
        if remat is not None:
            x, aux = checkpoint(
                lambda x, ps: unit_rep(x, ps, [None] * len(unit))[::2], x,
                ps, use_reentrant=False, **remat)
        else:
            sts = [None] * len(unit) if state is None else [
                tree_map(lambda t: t[r], st) for st in state["unit"]]
            x, sts, aux = unit_rep(x, ps, sts)
            for i, st in enumerate(sts):
                new_unit[i].append(st)
        aux_total = aux_total + aux
    new_rem = []
    for i, kind in enumerate(rem):
        st = None if state is None else state["rem"][i]
        x, st, aux = block(kind, params["rem"][i], x, st)
        if aux is not None:
            aux_total = aux_total + aux
        new_rem.append(st)

    new_state = None
    if state is not None:
        new_state = {"rem": new_rem, "unit": [
            state["unit"][i] if kind in ATTN_KINDS     # written in place
            else _stack(new_unit[i]) for i, kind in enumerate(unit)]}
    x = apply_norm(cfg.norm, x, params.get("final_norm"))
    logits = constrain(_lm_head(params, cfg, x), BATCH, None, "model")
    return logits, new_state, aux_total


# =================================================================== loss
def lm_loss(params, cfg: ModelConfig, batch: dict, aux_weight: float = 0.01,
            attn_backend: str | None = None,
            ssm_backend: str | None = None):
    """(ce + aux_weight * aux, (ce, aux)): the mean token cross-entropy of
    the train-mode logits against ``batch["labels"]`` (IGNORE_ID masked;
    the vision stub's patch positions prepended as ignored) and the MoE
    layers' summed aux loss.  ``params`` in float32, as ``init_params``
    gives them."""
    logits, _, aux = model_apply(params, cfg, batch, mode="train",
                                 attn_backend=attn_backend,
                                 ssm_backend=ssm_backend)
    labels = batch["labels"]
    if cfg.frontend == "vision_stub":
        pad = replicate_like(torch.full(
            (labels.shape[0], batch["patches"].shape[1]), IGNORE_ID,
            dtype=labels.dtype, device=labels.device), labels)
        labels = torch.cat([pad, labels], dim=1)
    ce = cross_entropy_loss(logits, labels, IGNORE_ID)
    return ce + aux_weight * aux, (ce, aux)
