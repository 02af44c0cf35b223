"""Operators that ran whole on a device mesh, counted.

DTensor runs an operator it cannot shard on gathered inputs: its
strategy redistributes a split input to ``Replicate`` and the result is
replicated, with no error.  ``count_replicated()`` counts such calls by
operator while a step runs: a call whose DTensor input is split (``Shard``)
over a mesh dim of more than one rank, with every DTensor output
replicated over that mesh dim.  A reduction over a split dim (a
``Partial`` output) and the reduction of a partial sum are not counted:
no rank computes on the whole tensor there.  This is the real run's
counterpart of the dry-run walker's ``fallbacks``; it is a
``TorchDispatchMode`` that sees each operator below autograd, forward and
backward, and adds one Python call to each.
"""
from __future__ import annotations

import collections
import contextlib

from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


def _split_dims(t) -> set:
    """Mesh dims (of more than one rank) that split the DTensor ``t``."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    return {i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and mesh.size(i) > 1}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        out = func(*args, **(kwargs or {}))
        if not any(issubclass(t, DTensor) for t in types):
            return out
        split = set()
        for a in pytree.tree_leaves((args, kwargs)):
            if isinstance(a, DTensor):
                split |= _split_dims(a)
        outs = [o for o in pytree.tree_leaves(out) if isinstance(o, DTensor)]
        if split and outs and any(
                all(isinstance(o.placements[i], Replicate) for o in outs)
                for i in split):
            self.counts[func.overloadpacket.__name__] += 1
        return out


@contextlib.contextmanager
def count_replicated():
    """Count the operators that run whole in the block -> a Counter
    ({operator name: calls}), filled as the block runs."""
    mode = _Counter()
    with mode:
        yield mode.counts
