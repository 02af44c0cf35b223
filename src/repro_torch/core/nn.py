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


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when it is float64: the model's
    upcasts to fp32, which a float64 run (a numerics reference for the
    fp32 paths) keeps in fp64."""
    return x if x.dtype == torch.float64 else x.float()


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
    """Leaves in ``jax.tree_util`` flatten order (dict keys sorted);
    ``None`` is an empty slot, no leaf, as in a JAX pytree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / lists / tuples, and over
    the matching leaves of ``rest`` (trees of the same structure), as
    ``jax.tree_util.tree_map``; ``None`` stays ``None`` (an empty slot,
    as in a JAX pytree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


class _GradInLayout(torch.autograd.Function):
    """The identity; its backward lays the gradient out as the input is
    (a partial sum reduce-scattered).  A Function, not a tensor hook: a
    hook on a view waits for the view's node, which waits for every
    use of the stacked tensor it was cut from."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def keep_grad_layout(t):
    """``t``, and when it is a DTensor that takes a gradient, that gradient
    laid out as ``t`` is as soon as it is made, as GSPMD lays out the
    reference's: no rank holds the whole model's partial sums at once."""
    if not (hasattr(t, "placements") and t.requires_grad):
        return t
    return _GradInLayout.apply(t)


def value_and_grad(loss_fn, params, has_aux: bool = False):
    """``jax.value_and_grad`` over a tree of tensors: (value, grads shaped
    like ``params``), the value detached; a leaf the loss does not reach
    gets a zero gradient, as in JAX.  With ``has_aux``, ``loss_fn``
    returns (loss, aux) and the value is that pair.  A DTensor leaf's
    gradient comes out laid out as the leaf."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    out = loss_fn(tree_map(keep_grad_layout, p))
    loss = out[0] if has_aux else out
    leaves = tree_leaves(p)
    gs = (torch.autograd.grad(loss, leaves, allow_unused=True)
          if loss.requires_grad else [None] * len(leaves))
    by_id = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, gs)}
    grads = tree_map(lambda x: by_id[id(x)], p)
    return tree_map(torch.Tensor.detach, out), grads


def tree_size(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


# A loop that the reference runs as one ``lax.scan``.  ``scan(fn, *args)``
# is ``fn(*args)``; while the graph importer (``graphs/fx_import.py``)
# traces, it sets ``SCAN_HOOK`` and records the call as one vertex forward
# and one backward, as the reference's jaxpr holds one ``scan`` equation.
SCAN_HOOK = None


def scan(fn, *args):
    """``fn(*args)`` (a tuple of tensors), recorded as one loop when the
    graph importer traces.  Put the argument whose gradient the reference's
    transposed scan returns first (its consts, then its carry) first."""
    if SCAN_HOOK is None:
        return fn(*args)
    return SCAN_HOOK(fn, args)


def tracing() -> bool:
    """Whether the graph importer is tracing the caller."""
    return SCAN_HOOK is not None
