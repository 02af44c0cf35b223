"""Activation sharding annotations (twin of ``repro/parallel/annotate.py``).

The reference applies ``with_sharding_constraint`` against the ambient
mesh (``jax.set_mesh``).  Here the ambient mesh is a ``DeviceMesh`` set by
:func:`use_mesh`, and a constraint redistributes a DTensor to the guarded
spec (a differentiable ``redistribute``: the collective it needs, if any,
is the one GSPMD would insert at the constraint).  Outside a mesh, or for
a plain tensor, ``constrain`` returns its argument unchanged, so the
models compute the same numbers and launch the same kernels as without
it.  Axes that do not exist or do not divide the dim are dropped
(long_500k's batch of 1, MQA's single KV head, ...), as in the reference.
"""
from __future__ import annotations

import contextlib

import numpy as np

BATCH = ("pod", "data")          # filtered against the ambient mesh
MODEL = "model"

_MESH = None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with dim names) the ambient mesh for
    the block: the counterpart of ``jax.set_mesh``."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def get_mesh():
    """The ambient mesh, or None."""
    return _MESH


def _axes_tuple(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _sizes():
    mesh = _MESH
    if mesh is None or not mesh.mesh_dim_names:
        return None
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_type())


def replicated(t, mesh):
    """``t``, a plain tensor that every rank holds alike, as a replicated
    DTensor on ``mesh`` (a DTensor is returned as it is)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return _dtensor_type().from_local(t, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)


def replicate_like(t, like):
    """``t``, a plain tensor that every rank computes alike (a constant, a
    position table), as a replicated DTensor on the mesh of the DTensor
    ``like``; ``t`` as it is when ``like`` is a plain tensor.  DTensor
    refuses to mix the two kinds in one operator."""
    if t is None or not is_dtensor(like):
        return t
    return replicated(t, like.device_mesh)


def unsplit(x, dim: int):
    """The DTensor ``x`` with no mesh dim splitting ``dim`` (gathered
    there, its other placements kept); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def _apply(x, clean: list):
    """Redistribute the DTensor ``x`` to the spec ``clean``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .sharding import to_placements
    placements = to_placements(clean, _MESH)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(_MESH, placements)


def guard_spec(shape, spec, sizes: dict) -> list:
    """The reference's guard: per dim, the entry's axes that exist in the
    mesh, kept when their product divides the dim and is at most the dim;
    None otherwise; dims past the spec None."""
    clean = []
    for dim, entry in zip(shape, spec):
        axes = tuple(a for a in _axes_tuple(entry) if a in sizes)
        total = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if axes and dim % total == 0 and dim >= total:
            clean.append(axes if len(axes) > 1 else axes[0])
        else:
            clean.append(None)
    return clean + [None] * (len(shape) - len(clean))


def constrain(x, *spec):
    sizes = _sizes()
    if sizes is None:
        return x
    return _apply(x, guard_spec(tuple(x.shape), spec, sizes))


def constrain_batch(x):
    """(B, S, ...) residual-stream activation: batch over ('pod','data')
    and, for sequence-bearing tensors, sequence over 'model'
    (Megatron-style sequence parallelism).  Decode (S=1) and non-divisible
    lengths fall back through the divisibility guard."""
    if x.ndim >= 3:
        return constrain(x, BATCH, MODEL, *([None] * (x.ndim - 2)))
    return constrain(x, BATCH, *([None] * (x.ndim - 1)))


def first_spec(shape, axis: str, dims, sizes: dict) -> list:
    """``constrain_first``'s spec: ``axis`` on the first of ``dims`` that
    it divides (and does not exceed), None elsewhere."""
    spec = [None] * len(shape)
    if axis not in sizes:
        return spec
    size = sizes[axis]
    for d in dims:
        if shape[d] % size == 0 and shape[d] >= size:
            spec[d] = axis
            break
    return spec


def constrain_first(x, axis, dims):
    """Shard ``axis`` over the FIRST dim in ``dims`` that divides it; others
    None.  Used by the MoE dispatch: experts over 'model' when the expert
    count divides (EP), else capacity over 'model' (token-parallel — the
    granite-40-experts fallback)."""
    sizes = _sizes()
    if sizes is None or axis not in sizes:
        return x
    return _apply(x, first_spec(tuple(x.shape), axis, dims, sizes))
