"""Copy of ``src/repro/train/data.py`` (the port imports nothing of
``repro``; its unused ``import jax`` dropped), with the batches handed
out as torch tensors on a given device, or as the reference's numpy
arrays when no device is given.

Synthetic LM data pipeline.

Deterministic, seekable token stream (counter-based PRNG): batch `i` is
reproducible from (seed, i) alone, which is what makes checkpoint/restart
and elastic re-sharding exact — a restored job at step k regenerates batch
k regardless of worker count (the real-data analogue is a deterministic
index shuffle over a token archive; the interface is identical).

Straggler mitigation hook: `skip_ahead()` lets a late worker jump the
cursor to the fleet's step without replaying batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    vocab: int | None = None          # default: model vocab


class SyntheticTokenStream:
    """Structured synthetic tokens (Zipf-ish marginals + local repetition)
    so the LM loss actually decreases during smoke training.  ``device``:
    batches as torch tensors there (token ids and labels int64, frames
    and patches float32), or None for the reference's numpy arrays."""

    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.data = data
        self.device = None if device is None else resolve_device(device)
        self.vocab = data.vocab or cfg.vocab
        self.step = 0
        # Zipf-ish unigram distribution, fixed by seed
        rng = np.random.default_rng(data.seed)
        ranks = np.arange(1, self.vocab + 1)
        p = 1.0 / ranks ** 1.1
        self.p = p / p.sum()
        self._perm = rng.permutation(self.vocab)

    def _tokens_for(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.data.seed, step]))
        B, S = self.data.global_batch, self.data.seq_len
        toks = rng.choice(self.vocab, size=(B, S + 1), p=self.p)
        # local repetition structure: copy spans backwards with offset
        off = 7
        toks[:, off:] = np.where(rng.random((B, S + 1 - off)) < 0.5,
                                 toks[:, :-off], toks[:, off:])
        return self._perm[toks].astype(np.int32)

    def next_batch(self) -> dict:
        toks = self._tokens_for(self.step)
        self.step += 1
        batch = self._to_model_batch(toks)
        if self.device is None:
            return batch
        return {k: torch.from_numpy(v).to(
                    self.device, torch.float32 if v.dtype == np.float32
                    else torch.int64) for k, v in batch.items()}

    def _to_model_batch(self, toks: np.ndarray) -> dict:
        cfg = self.cfg
        inputs, labels = toks[:, :-1], toks[:, 1:]
        if cfg.frontend == "audio_stub":
            rng = np.random.default_rng(int(inputs[0, 0]))
            frames = rng.standard_normal(
                (*inputs.shape, cfg.d_model)).astype(np.float32) * 0.02
            return {"frames": frames,
                    "labels": (labels % cfg.vocab).astype(np.int32)}
        if cfg.frontend == "vision_stub":
            rng = np.random.default_rng(int(inputs[0, 0]))
            patches = rng.standard_normal(
                (inputs.shape[0], cfg.n_patches, cfg.d_model)
            ).astype(np.float32) * 0.02
            return {"patches": patches, "tokens": inputs % cfg.vocab,
                    "labels": (labels % cfg.vocab).astype(np.int32)}
        return {"tokens": inputs % cfg.vocab,
                "labels": (labels % cfg.vocab).astype(np.int32)}

    # ----------------------------------------------------- fault tolerance
    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def skip_ahead(self, fleet_step: int) -> int:
        """Straggler mitigation: jump to the fleet's current batch index."""
        skipped = max(0, fleet_step - self.step)
        self.step = max(self.step, fleet_step)
        return skipped
