"""Kernel calls on DTensors: each rank runs the kernel on its local shard.

A kernel computes rows of its batch dim and its heads independently of
one another, so a DTensor split on those dims is computed shard by shard
with no collective: the wrapper lays its inputs out so (``layout``),
runs the kernel (or, on CPU shards, its plain version) on each rank's
local tensors and returns a DTensor of the same placements
(``wrap``).  ``to_local`` and ``from_local`` carry the gradients, so the
kernels' autograd Functions run as they do on plain tensors: the kernel
forward, the plain version's gradient backward, both on the local shard.
This is the counterpart of the reference's Pallas calls under GSPMD,
which partition the same two dims.
"""
from __future__ import annotations

import torch


def is_shard(p, dim: int) -> bool:
    from torch.distributed.tensor import Shard
    return isinstance(p, Shard) and p.dim == dim


def layout(x, keep: tuple, to: int) -> list:
    """Placements of the DTensor ``x`` that a kernel can run on: a split
    of one of the ``keep`` dims stays; a split of another dim moves to dim
    ``to`` where ``to``'s local extent divides it, else the mesh dim is
    replicated; a partial sum is reduced (replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    local = list(x.shape)
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim in keep:
            local[p.dim] //= mesh.size(i)
    out = []
    for i, p in enumerate(x.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim in keep:
            out.append(p)
        elif isinstance(p, Shard) and local[to] % n == 0 and local[to] >= n:
            local[to] //= n
            out.append(Shard(to))
        else:
            out.append(Replicate())
    return out


def laid_out(x, placements):
    """``x`` redistributed to ``placements`` (no-op when it has them)."""
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def block(mesh, placements, dim: int, size: int) -> tuple[int, int]:
    """(offset, extent) of this rank's block of tensor dim ``dim`` (of
    ``size``) under ``placements``: the mesh dims that split it, in mesh
    order, the first the major (DTensor's order)."""
    coord = mesh.get_coordinate()
    off, ext = 0, size
    for i, p in enumerate(placements):
        if is_shard(p, dim):
            ext //= mesh.size(i)
            off += coord[i] * ext
    return off, ext


def contiguous_stride(shape) -> tuple:
    st, acc = [], 1
    for d in reversed(shape):
        st.append(acc)
        acc *= max(int(d), 1)
    return tuple(reversed(st))


def wrap(local, mesh, placements, shape):
    """A rank's local result as the DTensor of global ``shape`` (made
    contiguous: DTensor's reshape rules view the local tensor)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def on_shards(fn, x):
    """``fn`` on the DTensor ``x``'s local shard, each output a DTensor of
    ``x``'s placements (a partial sum reduced first): for an ``fn`` that
    keeps every split dim whole (elementwise, or a split along a dim no
    mesh dim splits).  ``fn(x)`` for a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils import _pytree as pytree
    if not isinstance(x, DTensor):
        return fn(x)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = laid_out(x, pl)

    def wrapped(o):
        shape = list(o.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
        return wrap(o, mesh, pl, shape)
    return pytree.tree_map_only(torch.Tensor, wrapped, fn(x.to_local()))
