"""Step functions (twin of ``repro/models/steps.py``): prefill and decode.

The reference jits these; PyTorch runs them eagerly.  ``batch`` is the
model's input dict (``model_apply``): tokens, or the audio stub's frames,
with the vision stub's patches beside the tokens at prefill.  Training
(``make_train_step``) is not ported yet (ROADMAP A11.4).
"""
from __future__ import annotations

from .config import ModelConfig
from .transformer import TRAINING_UNPORTED, model_apply


def make_prefill_step(cfg: ModelConfig, cache_len: int,
                      attn_backend: str | None = None,
                      ssm_backend: str | None = None):
    """prefill_step(params, batch, state) -> (last_logits, state).
    ``cache_len`` is set by the state's caches, as in the reference."""

    def prefill_step(params, batch, state):
        logits, state, _ = model_apply(params, cfg, batch, mode="prefill",
                                       state=state,
                                       attn_backend=attn_backend,
                                       ssm_backend=ssm_backend)
        return logits[:, -1, :], state

    return prefill_step


def make_decode_step(cfg: ModelConfig, attn_backend: str | None = None,
                     ssm_backend: str | None = None):
    """decode_step(params, batch, state, pos) -> (logits, state): one new
    token at position ``pos`` against the carried state."""

    def decode_step(params, batch, state, pos):
        logits, state, _ = model_apply(params, cfg, batch, mode="decode",
                                       state=state, cache_pos=pos,
                                       attn_backend=attn_backend,
                                       ssm_backend=ssm_backend)
        return logits[:, 0, :], state

    return decode_step


def make_train_step(*args, **kwargs):
    raise NotImplementedError(TRAINING_UNPORTED)
