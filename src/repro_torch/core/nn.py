"""Minimal NN primitives on plain tensors (twin of ``repro/core/nn.py``).

Parameters are nested dicts/lists of tensors with the JAX pytree's
structure (``{"layers": [{"w", "b"}, ...]}`` per MLP); init functions
draw from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                scale: float | None = None):
    """Normal(0, 1) x 1/sqrt(d_in) weights, zero bias — the reference's
    distribution (it cannot match threefry's bits)."""
    s = scale if scale is not None else 1.0 / math.sqrt(max(d_in, 1))
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * s
    return {"w": w, "b": torch.zeros(d_out, device=gen.device)}


def apply_linear(p, x):
    return x @ p["w"] + p["b"]


def init_mlp(gen: torch.Generator, sizes: Sequence[int]):
    return {"layers": [init_linear(gen, a, b)
                       for a, b in zip(sizes[:-1], sizes[1:])]}


def apply_mlp(p, x, act=torch.relu, final_act=None):
    layers = p["layers"]
    for i, lp in enumerate(layers):
        x = apply_linear(lp, x)
        if i < len(layers) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def leaky_relu(x, alpha: float = 0.01):
    return torch.where(x >= 0, x, alpha * x)


def masked_log_softmax(logits, mask):
    """log softmax over the last axis where ``mask``.  Masked entries are
    filled with ``finfo.min`` (not -inf), as in the reference: sampling
    parity (``argmax(logp + gumbel)``) depends on it."""
    neg = torch.finfo(logits.dtype).min
    z = torch.where(mask, logits, torch.full_like(logits, neg))
    return torch.log_softmax(z, dim=-1)


def masked_entropy(logits, mask):
    logp = masked_log_softmax(logits, mask)
    p = torch.exp(logp)
    return -torch.where(mask, p * logp, torch.zeros_like(logp)).sum(-1)


def first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim``, 0 where there is none — what
    the reference's ``argmax`` over booleans returns, without relying on
    a tie rule."""
    L = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = L
    pos = torch.arange(L, device=mask.device).view(shape)
    first = torch.where(mask, pos, L).amin(dim)
    return torch.where(first < L, first, 0)


def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``argmax`` that returns the first of tied maxima on every device,
    as the reference's ``jnp.argmax`` does."""
    return first_true(x == x.amax(dim, keepdim=True), dim)


def argmin_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return first_true(x == x.amin(dim, keepdim=True), dim)


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves in ``jax.tree_util`` flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_size(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))
