"""Optimizers over the port's parameter trees (twin of
``repro/train/optim.py``).

AdamW with decoupled weight decay, global-norm clipping, and LR
schedules, used for DOPPLER policy training (lr 1e-4 -> 1e-7 linear, per
paper §6.1).  Everything is float32 as in the reference: the moments and
parameters are float32 tensors, the bias corrections are
``1 - b ** step`` with ``step`` as float32, and the schedules return
float32 scalars (an eps of 0.2 in float64 against 0.2f flips a uniform
draw that falls between the two).

The fused engines (``core/train_fused.py``) replay one update as a CUDA
graph, so nothing there may be read back to the host or baked in at
capture: ``adamw_update_`` keeps the step as an int32 device tensor and
takes the lr as a float32 device tensor, and a schedule called with a
tensor computes on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.nn import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: int          # updates taken so far (the reference's int32 scalar;
                       # an int32 device tensor for ``adamw_update_``)
    mu: dict
    nu: dict


def adamw_init(params) -> AdamState:
    zeros = tree_map(torch.zeros_like, params)
    return AdamState(0, zeros, tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(grads, state: AdamState, params, lr,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 max_grad_norm: float | None = 1.0):
    """One AdamW step -> (new params, new state); nothing is updated in
    place.  ``lr`` is a float32 scalar (a schedule's value)."""
    if max_grad_norm is not None:
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    one, t = np.float32(1.0), np.float32(step)
    bc1 = float(one - np.float32(b1) ** t)
    bc2 = float(one - np.float32(b2) ** t)
    lr = float(np.float32(lr))

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        return p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)

    return tree_map(upd, params, mu, nu), AdamState(step, mu, nu)


@torch.no_grad()
def adamw_update_(grads, state: AdamState, params, lr: torch.Tensor,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: float = 0.0,
                  max_grad_norm: float | None = 1.0) -> None:
    """:func:`adamw_update` in place, with nothing read back to the host:
    ``params``, ``state.mu`` and ``state.nu`` are updated in place,
    ``state.step`` is an int32 device tensor incremented in place, ``lr``
    a float32 device tensor, and the bias corrections ``1 - b ** step``
    are computed on the device, as the reference's traced ``adamw_update``
    does.  The arithmetic is :func:`adamw_update`'s, operation for
    operation."""
    if max_grad_norm is not None:
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
    state.step.add_(1)
    t = state.step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(grads)):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(lr * (m / bc1 / (torch.sqrt(v / bc2) + eps)
                     + weight_decay * p))


def linear_schedule(lr0: float, lr1: float, n_steps: int) -> Callable:
    """``step`` -> float32 value.  A host ``step`` divides in float64 and
    casts, as the reference's schedule does on a Python int.  A tensor
    ``step`` (the fused engines' int32 episode counter) computes on its
    device what XLA compiles the reference's schedule to under ``jit``:
    the count cast to float32 times the float32 reciprocal of
    ``max(n_steps, 1)``, clipped to [0, 1], then ``lr0 + (lr1 - lr0) *
    frac`` as one fused multiply-add (the product exact in float64, the
    sum rounded to float32).  The two can differ in the last bit, and eps
    is compared with a uniform draw, so each path keeps the reference's
    bits."""
    inv = float(np.float32(1.0 / max(n_steps, 1)))
    a, d = float(np.float32(lr0)), float(np.float32(lr1 - lr0))

    def sched(step):
        if isinstance(step, torch.Tensor):
            frac = torch.clamp(step.float() * inv, 0.0, 1.0)
            return (frac.double() * d + a).float()
        frac = np.float32(np.clip(step / max(n_steps, 1), 0.0, 1.0))
        return np.float32(lr0) + np.float32(lr1 - lr0) * frac
    return sched


def cosine_schedule(lr0: float, lr_min: float, n_steps: int,
                    warmup: int = 0) -> Callable:
    def sched(step) -> np.float32:
        step = np.float32(step)
        warm = np.float32(lr0) * step / np.float32(max(warmup, 1))
        frac = np.clip((step - np.float32(warmup))
                       / np.float32(max(n_steps - warmup, 1)),
                       np.float32(0.0), np.float32(1.0))
        cos = np.float32(lr_min) + np.float32(0.5 * (lr0 - lr_min)) * (
            np.float32(1.0) + np.cos(np.float32(np.pi) * frac))
        return warm if step < warmup else cos
    return sched
