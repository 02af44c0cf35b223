"""Step functions (twin of ``repro/models/steps.py``): train, eval, prefill
and decode, and the input specs of a shape cell.

The reference jits these; PyTorch runs them eagerly.  ``batch`` is the
model's input dict (``model_apply``): tokens, or the audio stub's frames,
with the vision stub's patches beside the tokens; train and eval add
``labels``.  The backends (``attn_backend``, ``ssm_backend``) default to
the kernels on the card and the plain versions on the CPU; under
autograd the kernels run forward and the plain versions' gradients
backward.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.nn import tree_map, value_and_grad
from ..train.optim import adamw_update, clip_by_global_norm
from .config import ModelConfig
from .transformer import init_decode_state, init_params, lm_loss, model_apply


# ------------------------------------------------------------ input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                kind: str) -> dict:
    """Stand-ins (``meta`` tensors: shape and dtype, no memory) for every
    model input of a shape cell, the reference's shapes and dtypes (int32
    ids, bf16 stub embeddings)."""
    B = global_batch
    i32, bf16 = torch.int32, torch.bfloat16
    if kind == "decode":
        if cfg.frontend == "audio_stub":
            return {"frames": _meta((B, 1, cfg.d_model), bf16)}
        return {"tokens": _meta((B, 1), i32)}
    batch = {}
    if cfg.frontend == "audio_stub":
        batch["frames"] = _meta((B, seq_len, cfg.d_model), bf16)
        batch["labels"] = _meta((B, seq_len), i32)
    elif cfg.frontend == "vision_stub":
        text_len = seq_len - cfg.n_patches
        batch["patches"] = _meta((B, cfg.n_patches, cfg.d_model), bf16)
        batch["tokens"] = _meta((B, text_len), i32)
        batch["labels"] = _meta((B, text_len), i32)
    else:
        batch["tokens"] = _meta((B, seq_len), i32)
        batch["labels"] = _meta((B, seq_len), i32)
    if kind == "prefill":
        batch.pop("labels", None)
    return batch


def _structs(make):
    """``make()``'s tensors as ``meta`` tensors, run on fake tensors (the
    counterpart of ``jax.eval_shape``: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = make()
    return tree_map(lambda t: _meta(tuple(t.shape), t.dtype), tree)


def param_structs(cfg: ModelConfig):
    """``init_params(cfg)``'s tree as ``meta`` tensors."""
    return _structs(lambda: init_params(cfg, 0, device="cpu"))


def decode_state_structs(cfg: ModelConfig, batch: int, cache_len: int):
    """``init_decode_state(cfg, batch, cache_len)``'s tree as ``meta``
    tensors."""
    return _structs(lambda: init_decode_state(cfg, batch, cache_len,
                                              device="cpu"))


def make_train_step(cfg: ModelConfig, lr_schedule: Callable | float = 3e-4,
                    weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                    grad_transform: Callable | None = None,
                    attn_backend: str | None = None,
                    ssm_backend: str | None = None):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics): the gradients of ``lm_loss`` at the float32 ``params``,
    clipped to a global norm of ``max_grad_norm``, through
    ``grad_transform`` if given, then one AdamW step at the schedule's lr.
    ``metrics``: ``loss`` (the cross-entropy), ``aux_loss``,
    ``grad_norm`` (before clipping) and ``lr``, as float32 tensors.  The
    new params and state are new tensors; the old ones are not
    changed."""

    def train_step(params, opt_state, batch, step):
        (_, (ce, aux)), grads = value_and_grad(
            lambda p: lm_loss(p, cfg, batch, attn_backend=attn_backend,
                              ssm_backend=ssm_backend),
            params, has_aux=True)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        if grad_transform is not None:
            grads = grad_transform(grads)
        lr = lr_schedule(step) if callable(lr_schedule) else lr_schedule
        params, opt_state = adamw_update(
            grads, opt_state, params, lr, weight_decay=weight_decay,
            max_grad_norm=None)
        metrics = {"loss": ce, "aux_loss": aux, "grad_norm": gnorm,
                   "lr": torch.tensor(np.float32(lr))}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, attn_backend: str | None = None,
                   ssm_backend: str | None = None):
    """eval_step(params, batch) -> {"loss": cross-entropy, "aux_loss"}."""

    def eval_step(params, batch):
        with torch.no_grad():
            _, (ce, aux) = lm_loss(params, cfg, batch,
                                   attn_backend=attn_backend,
                                   ssm_backend=ssm_backend)
        return {"loss": ce, "aux_loss": aux}

    return eval_step


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
