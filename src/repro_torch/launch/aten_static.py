"""Static cost walker over a dispatch-level trace (twin of
``repro/launch/hlo_static.py``).

The reference walks the post-SPMD HLO of a compiled step.  Here the step
runs once on fake tensors (``FakeTensorMode``: shapes, no memory) under a
``TorchDispatchMode`` that sees every ATen operator below autograd.  On a
device mesh the arguments are DTensors: the walker lets DTensor's own
dispatch pick each operator's sharding (it returns the DTensor call to
``DTensor``'s dispatcher with itself still on the stack), so what it
records is one device's LOCAL work, and the functional collectives
(``_c10d_functional.*``, ``_dtensor.shard_dim_alltoall``) that DTensor
inserts.  Each device of an SPMD program runs the same work, so one
device's trace is the per-device cost, as the reference's per-device HLO.

Cost model per operator, the reference's:
  mm / bmm / addmm / baddbmm   2 * out_elems * contracted size
  reductions                   input elems (sort, topk: n * log2 n)
  data movement                0 flops (copies, casts, gathers, cat,
                               where, clamp, fills: the reference's
                               ``_MOVE_ONLY``); views and aliases cost
                               nothing at all
  everything else              out elems
  bytes                        at operator boundaries: each input read
                               once (a broadcast view at its storage's
                               size), each output written once.  The
                               reference prices the boundaries of XLA's
                               fusions (on the CPU backend, beside f32
                               copies of bf16 buffers); an eager trace
                               has no fusions; the two differ
                               (``tests/test_torch_dryrun.py`` prints the
                               ratio)
  collectives                  ring model: all-gather / reduce-scatter /
                               all-to-all X*(g-1)/g, all-reduce
                               2*X*(g-1)/g, permute X, where X = the larger
                               of the input and output bytes and g the
                               group's size

The reference multiplies a ``while`` body by its trip count.  Its
counterpart here is the caller's: trace the step at one and at two
repetitions of the model's unit and extrapolate linearly to the full
depth (``dryrun.py``), as ``graphs/model_zoo.py`` tiles one unit.

Where DTensor's own rule would gather a whole tensor and GSPMD would
partition the work (``logsumexp`` over a sharded vocabulary, a gather's
gradient, an embedding's lookup and its gradient, a slice of a sharded
sequence, views of two sharded dims),
``_RULES`` run the operator on the local shards.  An operator that
DTensor cannot shard (no sharding rule, or a view it cannot split) runs
replicated: its DTensor inputs are gathered in full
(the collectives are recorded), it runs on the full tensors, and its
outputs are replicated.  ``fallbacks`` counts these by operator; GSPMD
would pick a layout of its own there.

Memory: every storage an operator allocates is counted live until it is
freed (a weak reference on the storage), so ``peak_bytes`` is the peak of
the step's own allocations on top of its arguments.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import weakref

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..parallel.local_shards import contiguous_stride as _contiguous_stride
from .aten_analysis import collective_bytes

_MATMULS = frozenset(("mm", "bmm", "addmm", "baddbmm"))
_REDUCTIONS = frozenset(("sum", "mean", "amax", "amin", "max", "min", "prod",
                         "argmax", "argmin", "any", "all", "cumsum",
                         "cumprod", "logcumsumexp", "logsumexp", "var",
                         "std", "norm", "linalg_vector_norm", "nansum"))
_SORTS = frozenset(("sort", "topk", "argsort"))
_FREE = frozenset((
    "view", "_unsafe_view", "_reshape_alias", "reshape", "unsqueeze",
    "squeeze", "expand", "permute", "transpose", "t", "slice", "select",
    "split", "split_with_sizes", "unbind", "diagonal", "as_strided",
    "unfold", "chunk", "narrow", "alias", "detach", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "device", "wait_tensor", "_local_scalar_dense",
    "view_as_real", "view_as_complex", "_to_copy_no_op", "set_",
    "resize_", "sym_size", "sym_stride", "sym_numel", "is_same_size",
    "_has_compatible_shallow_copy_type", "stride", "size", "dim",
    "view_as", "expand_as", "reshape_as", "swapaxes", "movedim"))
_MOVE_ONLY = frozenset((
    "clone", "copy", "copy_", "_to_copy", "to", "contiguous", "cat",
    "stack", "index", "index_select", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index_put", "index_put_", "index_add",
    "slice_scatter", "select_scatter", "as_strided_scatter",
    "constant_pad_nd", "flip", "roll", "repeat", "expand_copy", "zeros",
    "ones", "full", "fill", "fill_", "zero_", "zeros_like", "ones_like",
    "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "arange", "where", "clamp", "clamp_min", "clamp_max", "masked_fill",
    "embedding", "embedding_dense_backward", "tril", "triu",
    "_unsafe_index", "_unsafe_index_put", "_index_put_impl_",
    "lift_fresh_copy", "tensor_split", "masked_scatter"))
# the reference's HLO for these runs their equations (softmax: reduce max,
# subtract, exp, reduce sum, divide): their flops a multiple of the output
_COMPOSITE = {"_softmax": 5.0, "_log_softmax": 5.0,
              "_softmax_backward_data": 4.0,
              "_log_softmax_backward_data": 4.0,
              "native_layer_norm": 8.0, "native_layer_norm_backward": 10.0}
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _elems(t: torch.Tensor) -> float:
    return float(np.prod(t.shape, dtype=np.float64)) if t.dim() else 1.0


def _nbytes(t: torch.Tensor) -> float:
    return _elems(t) * float(t.element_size())


def _read_bytes(t: torch.Tensor) -> float:
    """What reading ``t`` moves: its elements, or its storage when that is
    smaller (a broadcast / expanded view)."""
    try:
        st = float(t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return _nbytes(t)
    return min(_nbytes(t), st) if st > 0 else _nbytes(t)


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_size(args, default: int) -> int:
    import torch.distributed.distributed_c10d as c10d
    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                continue
    ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
    return ints[-1] if ints else default


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    matmul_flops: float = 0.0
    mem_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    n_ops: float = 0.0

    def add(self, other: "Cost", mult: float = 1.0) -> "Cost":
        self.flops += other.flops * mult
        self.matmul_flops += other.matmul_flops * mult
        self.mem_bytes += other.mem_bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        self.n_ops += other.n_ops * mult
        for mine, theirs in ((self.coll_by_kind, other.coll_by_kind),
                             (self.coll_counts, other.coll_counts)):
            for k, v in theirs.items():
                mine[k] += v * mult
        return self

    def as_dict(self) -> dict:
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "mem_bytes": self.mem_bytes,
                "collective_bytes": self.coll_bytes,
                "collective_by_kind": dict(self.coll_by_kind),
                "collective_counts": {k: int(round(v)) for k, v in
                                      self.coll_counts.items()},
                "n_ops": int(round(self.n_ops))}


def op_cost(name: str, args, kwargs, out, n_devices: int = 1) -> Cost:
    """One operator's cost on one device (``name``: the ATen overload
    packet's name; ``args`` / ``out`` its local tensors)."""
    c = Cost()
    if name in _FREE:
        return c
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    out_elems = sum(_elems(o) for o in outs)
    in_bytes = sum(_read_bytes(t) for t in ins)
    out_bytes = sum(_nbytes(o) for o in outs)
    c.n_ops = 1.0
    kind = _COLLECTIVE_KIND.get(name)
    if kind is not None:
        x = max(out_bytes, in_bytes)
        g = _group_size(list(args) + list(kwargs.values()), n_devices)
        factor = (g - 1) / g if g > 1 else 0.0
        traffic = x * factor * (2.0 if kind == "all-reduce" else 1.0)
        if kind == "collective-permute":
            traffic = x
        c.coll_bytes = traffic
        c.coll_by_kind[kind] += traffic
        c.coll_counts[kind] += 1
        c.mem_bytes = in_bytes + out_bytes
        return c
    c.mem_bytes = in_bytes + out_bytes
    if name in _MATMULS:
        a = ins[1] if name in ("addmm", "baddbmm") else ins[0]
        c.flops = c.matmul_flops = 2.0 * _elems(outs[0]) * float(a.shape[-1])
    elif name == "convolution":
        c.flops = 2.0 * out_elems
    elif name in _SORTS:
        n = _elems(ins[0]) if ins else out_elems
        c.flops = n * math.log2(max(n, 2.0))
    elif name in _REDUCTIONS:
        c.flops = _elems(ins[0]) if ins else out_elems
    elif name in _COMPOSITE:
        c.flops = _COMPOSITE[name] * _elems(outs[0])
    elif name in _MOVE_ONLY:
        pass
    else:
        c.flops = out_elems
    return c


class Walker(TorchDispatchMode):
    """Records every ATen operator on plain (local) tensors below autograd;
    DTensor operators go to DTensor's dispatch with the walker on the
    stack, so their local operators and collectives are what it records.
    Use inside a ``FakeTensorMode``."""

    def __init__(self, n_devices: int = 1):
        super().__init__()
        self.n_devices = n_devices
        self.cost = Cost()
        self.fallbacks: collections.Counter = collections.Counter()
        self.live = 0.0
        self.peak = 0.0
        self._seen: set = set()
        self._declined = None
        self.errors: dict = {}
        self.paused = 0
        self.records: list = []       # one a collective

    # ------------------------------------------------------------- memory
    def _track(self, outs, ins) -> None:
        own = {id(t.untyped_storage()) for t in ins if _has_storage(t)}
        for o in outs:
            if not _has_storage(o):
                continue
            st = o.untyped_storage()
            key = id(st)
            if key in own or key in self._seen:
                continue
            nb = float(st.nbytes())
            self._seen.add(key)
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, nb)

    def _free(self, key, nb) -> None:
        self._seen.discard(key)
        self.live -= nb

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if self.paused:
            return out
        outs, ins = _tensors(out), _tensors((args, kwargs))
        name = func.overloadpacket.__name__
        c = op_cost(name, args, kwargs, out, self.n_devices)
        if c.n_ops:
            self.cost.add(c)
            if c.coll_counts:
                self.records.append({
                    "kind": next(iter(c.coll_counts)),
                    "out_bytes": sum(_nbytes(o) for o in outs),
                    "group_size": _group_size(
                        list(args) + list(kwargs.values()), self.n_devices)})
        self._track(outs, ins)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """A DTensor operator: DTensor's dispatch runs it (this mode
        declines the one call, ``NotImplemented``, and stays on the
        stack for the local operators); an operator DTensor cannot shard
        runs replicated instead, its partial record dropped."""
        if self._declined is func:
            self._declined = None
            return NotImplemented
        rule = _RULES.get(func.overloadpacket.__name__)
        if rule is not None:
            with self:
                out = rule(func, args, kwargs)
            if out is not None:
                return out
        snap = (Cost().add(self.cost), len(self.records))
        try:
            self._declined = func
            with self:
                out = func(*args, **kwargs)
            _hint(out)
            masked = _masked_dims(out)
            if masked:
                # a vocab-parallel lookup's masked partial result: reduce
                # it where it is made (the all-reduce GSPMD inserts after
                # a gather from a sharded table); DTensor's later views
                # of such a partial lose track of its shape
                with self:
                    out = _unshard(out, masked)
            return out
        except (NotImplementedError, RuntimeError, AssertionError,
                ValueError, IndexError) as e:
            if "data-dependent" in str(e).lower():
                raise
            self.cost = snap[0]
            del self.records[snap[1]:]
            self.fallbacks[func.overloadpacket.__name__] += 1
            self.errors.setdefault(func.overloadpacket.__name__,
                                   (str(e).splitlines()
                                    or [type(e).__name__])[0][:200])
            with self:
                return _replicated(func, args, kwargs)
        finally:
            self._declined = None


def _logsumexp(func, args, kwargs):
    """``logsumexp`` over dims that ``x`` is sharded on, as GSPMD computes
    it: the local max and sum of exponentials, each all-reduced over the
    sharded mesh dims (DTensor's own rule gathers ``x`` whole: a
    vocab-sharded logits tensor, gigabytes a device).  None when ``x`` is
    not sharded on a reduced dim (DTensor's rule then applies)."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, dims = args[0], args[1]
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    if not isinstance(x, DTensor):
        return None
    dims = sorted(d % x.ndim for d in dims)
    mesh, pl = x.device_mesh, list(x.placements)
    red = [i for i, p in enumerate(pl)
           if isinstance(p, Shard) and p.dim in dims]
    if not red or any(not (isinstance(p, (Shard, Replicate))) for p in pl):
        return None
    local = x.to_local()
    m = local.amax(dims, keepdim=True)
    for i in red:
        m = all_reduce(m, "max", (mesh, i))
    e = torch.exp(local - m).sum(dims, keepdim=True)
    for i in red:
        e = all_reduce(e, "sum", (mesh, i))
    out = m + torch.log(e)
    new = []
    for i, p in enumerate(pl):
        if i in red or not isinstance(p, Shard):
            new.append(Replicate())
        else:
            new.append(Shard(p.dim - (0 if keepdim else
                                      sum(d < p.dim for d in dims))))
    if not keepdim:
        out = out.squeeze(dims)
    return DTensor.from_local(out, mesh, new, run_check=False)


_HINTS: dict = {}


def _hint(out) -> None:
    """Remember the layout of the latest DTensor of each global shape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(out, DTensor) and all(
            isinstance(p, (Shard, Replicate)) for p in out.placements):
        _HINTS[(tuple(out.shape), id(out.device_mesh))] = tuple(
            out.placements)


def _scatter_add(func, args, kwargs):
    """``scatter_add(self, dim, index, src)`` into a ``self`` sharded on
    ``dim`` (a gather's gradient into vocab-sharded logits): each device
    adds the entries whose index falls in its block, the others masked,
    as GSPMD partitions a scatter; DTensor's own rule gathers ``self``.
    None unless index and src match ``self`` off ``dim`` and are
    replicated on the mesh dims that split it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if len(args) != 4 or kwargs:
        return None
    x, dim, index, src = args
    if not all(isinstance(t, DTensor) for t in (x, index, src)):
        return None
    dim = dim % x.ndim
    red = [i for i, p in enumerate(x.placements)
           if isinstance(p, Shard) and p.dim == dim]
    if not red:
        return None
    for i, p in enumerate(x.placements):
        want = Replicate() if i in red else p
        if index.placements[i] != want or src.placements[i] != want:
            return None
    local = x.to_local()
    n = local.shape[dim]
    # this device's block of ``dim`` (split over its mesh dims in order,
    # the first the major)
    coord = x.device_mesh.get_coordinate()
    offset, extent = 0, x.shape[dim]
    for i in red:
        extent //= x.device_mesh.size(i)
        offset += coord[i] * extent
    idx = index.to_local() - offset
    inside = (idx >= 0) & (idx < n)        # this device's block
    out = func(local, dim, torch.where(inside, idx, 0),
               torch.where(inside, src.to_local(), 0))
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _index(func, args, kwargs):
    """``index(self, [index])`` with one integer index (the embedding's
    lookup, the MoE dispatch's gathers): ``self`` laid out so that no
    mesh dim splits the indexed dim 0 (a split of it moves, by an
    all-to-all, to the largest other dim that it divides, else it is
    gathered), the index gathered over the mesh dims that split ``self``
    and kept split over the others; the lookup is then local, and the
    output split as ``self`` and the index are.  This is the layout
    torch 2.13's DTensor picks; pinned here, the walker records the same
    work on every torch version (2.11 gathers the table).  None for
    another form."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, indices = args[0], args[1]
    if kwargs or not (isinstance(x, DTensor) and len(indices) == 1
                      and isinstance(indices[0], torch.Tensor)
                      and indices[0].dtype not in (torch.bool, torch.uint8)):
        return None
    index = indices[0]
    if any(not isinstance(p, (Shard, Replicate)) for p in x.placements) or (
            isinstance(index, DTensor) and any(
                not isinstance(p, (Shard, Replicate))
                for p in index.placements)):
        return None
    mesh, lead = x.device_mesh, index.ndim
    local = list(x.shape)
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim > 0:
            local[p.dim] //= mesh.size(i)
    pl = []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == 0:
            n = mesh.size(i)
            fits = [d for d in range(1, x.ndim) if local[d] % n == 0
                    and local[d] >= n]
            if fits:
                d = max(fits, key=lambda d: local[d])
                local[d] //= n
                p = Shard(d)
            else:
                p = Replicate()
        pl.append(p)
    if list(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    out_pl = [Shard(p.dim - 1 + lead) if isinstance(p, Shard) else p
              for p in pl]
    shape = tuple(index.shape) + tuple(x.shape[1:])
    if isinstance(index, DTensor):
        # the index stays split where ``self`` is replicated (the output
        # split alike), and is gathered where ``self`` is split
        want = [q if isinstance(p, Replicate) else Replicate()
                for p, q in zip(pl, index.placements)]
        out_pl = [q if isinstance(p, Replicate) else o
                  for p, q, o in zip(pl, want, out_pl)]
        if list(index.placements) != want:
            index = index.redistribute(mesh, want)
        index = index.to_local()
    out = func(x.to_local(), [index])
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _index_put(func, args, kwargs):
    """``index_put(self, [index], values, accumulate=True)`` (and the
    in-place ``_index_put_impl_``) into a ``self`` sharded on the indexed
    dim 0 (the embedding's gradient into a vocab-sharded table): each
    device adds the entries whose index falls in its block of rows, the
    others masked, on its local shard, as GSPMD partitions a scatter.
    Per mesh dim: where ``self`` is split by rows, the index and
    ``values`` are gathered; where by another dim, ``values`` is split
    alike; where ``self`` is replicated and the index and ``values`` are
    split by the same index dim, each device adds its own entries, the
    result a partial sum there (``self``'s own values counted once).
    This runs the same work whether or not the installed torch has a
    DTensor strategy for the operator.  None for another form (DTensor's
    rule or the replicated fallback then apply)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x, indices, values = args[0], args[1], args[2]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                          False)
    if not (isinstance(x, DTensor) and isinstance(values, DTensor)
            and accumulate and len(indices) == 1
            and isinstance(indices[0], DTensor)
            and indices[0].dtype != torch.bool):
        return None
    index = indices[0]
    lead = values.ndim - (x.ndim - 1)       # the index's dims in values
    if lead != index.ndim or any(
            not isinstance(p, (Shard, Replicate))
            for p in (*x.placements, *values.placements, *index.placements)):
        return None
    red = [i for i, p in enumerate(x.placements)
           if isinstance(p, Shard) and p.dim == 0]
    if not red:
        return None
    mesh = x.device_mesh
    want_v, want_i, partial = [], [], []
    for i, p in enumerate(x.placements):
        v, ix = values.placements[i], index.placements[i]
        if isinstance(p, Shard) and p.dim > 0:
            want_v.append(Shard(p.dim - 1 + lead))
            want_i.append(Replicate())
        elif (isinstance(p, Replicate) and isinstance(v, Shard)
              and v.dim < lead and ix == v):
            want_v.append(v)
            want_i.append(ix)
            partial.append(i)
        else:
            want_v.append(Replicate())
            want_i.append(Replicate())
    if list(values.placements) != want_v:
        values = values.redistribute(mesh, want_v)
    if list(index.placements) != want_i:
        index = index.redistribute(mesh, want_i)
    local = x.to_local()
    coord = mesh.get_coordinate()
    if any(coord[i] for i in partial):
        local = torch.zeros_like(local)    # self counted on one device
    offset, extent = 0, x.shape[0]
    for i in red:
        extent //= mesh.size(i)
        offset += coord[i] * extent
    idx = index.to_local() - offset
    inside = (idx >= 0) & (idx < local.shape[0])       # this device's rows
    vals = values.to_local()
    vals = torch.where(inside.reshape(inside.shape + (1,) * (vals.ndim
                                                             - lead)),
                       vals, 0)
    out = func(local, [torch.where(inside, idx, 0)], vals, *args[3:],
               **kwargs)
    pl = [Partial() if i in partial else p
          for i, p in enumerate(x.placements)]
    res = DTensor.from_local(out, mesh, pl, run_check=False, shape=x.shape,
                             stride=x.stride())
    if func.overloadpacket.__name__.endswith("_"):     # in place
        if partial:
            res = res.redistribute(mesh, x.placements)
            x.to_local().copy_(res.to_local())
        return x
    return res


def _on_replicas(func, args, kwargs):
    """An operator DTensor has no rule for (``searchsorted``: the MoE
    plan's expert boundaries in its sorted choices), on inputs replicated
    over the whole mesh: every device runs it on its own copies, the
    outputs replicated.  The same work as the replicated fallback, which
    would gather nothing here; None for a sharded input."""
    from torch.distributed.tensor import DTensor, Replicate
    dts = [a for a in pytree.tree_leaves((args, kwargs))
           if isinstance(a, DTensor)]
    if not dts or any(not isinstance(p, Replicate)
                      for d in dts for p in d.placements):
        return None
    mesh = dts[0].device_mesh
    la, lk = pytree.tree_map(
        lambda a: a.to_local() if isinstance(a, DTensor) else a,
        (args, kwargs))
    return pytree.tree_map(
        lambda o: DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        if isinstance(o, torch.Tensor) else o, func(*la, **lk))


def _new_factory(func, args, kwargs):
    """``x.new_zeros(size)`` (and ``new_empty`` / ``new_ones`` /
    ``new_full``) sharded as ``x`` is on the dims where ``size`` keeps
    ``x``'s extent (an autograd rule's zeros of its input's shape: a
    gather's gradient), replicated elsewhere; DTensor's own rule makes it
    replicated at the full global size."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = args[0]
    if not isinstance(x, DTensor):
        return None
    size = list(args[1])
    mesh, pl = x.device_mesh, []
    local = list(size)
    like = _HINTS.get((tuple(size), id(mesh)))
    if like is not None:
        for i, p in enumerate(like):
            if isinstance(p, Shard):
                if local[p.dim] % mesh.size(i):
                    return None
                local[p.dim] //= mesh.size(i)
        out = func(x.to_local(), local, *args[2:], **kwargs)
        return DTensor.from_local(out, mesh, list(like), run_check=False)
    for p in x.placements:
        if (isinstance(p, Shard) and p.dim < len(size)
                and p.dim < x.ndim and size[p.dim] == x.shape[p.dim]):
            n = mesh.size(len(pl))
            if local[p.dim] % n:
                return None
            local[p.dim] //= n
            pl.append(p)
        else:
            pl.append(Replicate())
    out = func(x.to_local(), local, *args[2:], **kwargs)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _view_groups(src, dst):
    """Group the dims of a view: [(in dims, out dims)], each group's
    sizes multiplying to the same extent (size-1 dims on their own)."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        if i < len(src) and src[i] == 1 and (j >= len(dst) or dst[j] != 1):
            groups.append(([i], []))
            i += 1
            continue
        if j < len(dst) and dst[j] == 1 and (i >= len(src) or src[i] != 1):
            groups.append(([], [j]))
            j += 1
            continue
        gi, gj = [i], [j]
        a, b = src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= src[i]
                gi.append(i)
                i += 1
            else:
                b *= dst[j]
                gj.append(j)
                j += 1
        groups.append((gi, gj))
    return groups


_MERGES: dict = {}
_EXACT = [False]


def _view(func, args, kwargs):
    """A view of a DTensor, laid out without strided shards: merged dims
    keep every mesh dim that split them (the merged dim sharded over all
    of them, the outer first); a split dim gives each mesh dim back to
    the dim it split before the merge, or else to the first part its
    size divides.  The local shape is the local tensor's, so the costs
    that follow are a device's; DTensor's own rule makes a strided shard
    that it can neither compute with nor redistribute on fake tensors.
    A run for values (``trace_cost(..., exact=True)``) gathers the inner
    dims before such a merge instead: the relabelled rows are not in the
    merged dim's order once a collective moves them.  None (DTensor's
    rule) for a layout it does not cover."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = args[0]
    if not isinstance(x, DTensor) or kwargs:
        return None
    src = tuple(x.shape)
    dst = list(args[1])
    if -1 in dst:
        k = dst.index(-1)
        rest = int(np.prod([d for d in dst if d != -1], dtype=np.int64))
        dst[k] = int(np.prod(src, dtype=np.int64)) // max(rest, 1)
    dst = tuple(int(d) for d in dst)
    if int(np.prod(src, dtype=np.int64)) != int(np.prod(dst, dtype=np.int64)):
        return None
    mesh, pl = x.device_mesh, list(x.placements)
    if any(not isinstance(p, (Shard, Replicate, Partial)) for p in pl):
        return None
    by_dim: dict = {}
    for m, p in enumerate(pl):
        if isinstance(p, Shard):
            by_dim.setdefault(p.dim, []).append(m)
    new = [p if not isinstance(p, Shard) else None for p in pl]
    groups = _view_groups(src, dst)
    # dims no mesh dim splits, kept as they are: where a split dim's mesh
    # dim fits none of its parts, the cost trace moves it to one of these
    free = [gj[0] for gi, gj in groups if len(gi) == len(gj) == 1
            and not by_dim.get(gi[0])]
    for gi, gj in groups:
        ms = [m for d in gi for m in by_dim.get(d, [])]
        if not ms:
            continue
        if not gj:
            return None
        if len(gj) == 1:                       # kept or merged
            inner = [m for m in ms if pl[m].dim != gi[0]]
            if _EXACT[0] and len(gi) > 1 and inner:
                # real values: gather the inner dims first (what GSPMD
                # does at such a reshape), so the rows stay in order
                return _view(func, (_unshard(x, inner),) + tuple(args[1:]),
                             kwargs)
            for m in ms:
                new[m] = Shard(gj[0])
            if len(gi) > 1:
                key = (dst[gj[0]], tuple(src[d] for d in gi))
                _MERGES[key] = {m: gi.index(pl[m].dim) for m in ms}
            continue
        if len(gi) != 1:
            return None
        parts = tuple(dst[d] for d in gj)
        known = _MERGES.get((src[gi[0]], parts))
        left = list(parts)
        for m in ms:
            n = mesh.size(m)
            if known is not None and m in known and left[known[m]] % n == 0:
                k = known[m]
            else:
                k = next((k for k in range(len(left)) if left[k] % n == 0),
                         None)
            if k is None:
                # e.g. 64 query heads over 16 split as 8 KV heads x 8:
                # 'model' fits neither part (GSPMD splits it over both,
                # which no DTensor placement says).  For values, gather
                # it; for costs, shard a free dim the local size divides
                # (the same local elements: the same work)
                j = next((j for j in free if dst[j] % n == 0), None)
                if _EXACT[0] or j is None:
                    return _view(func, (_unshard(x, [m]),) + tuple(
                        args[1:]), kwargs)
                free.remove(j)
                new[m] = Shard(j)
                continue
            left[k] //= n
            new[m] = Shard(gj[k])
    local = list(dst)
    for m, p in enumerate(new):
        if isinstance(p, Shard):
            if local[p.dim] % mesh.size(m):
                return None
            local[p.dim] //= mesh.size(m)
    lx = x.to_local()
    if int(np.prod(local, dtype=np.int64)) != lx.numel():
        return None
    out = lx.reshape(local)
    return DTensor.from_local(out, mesh, new, run_check=False, shape=dst,
                              stride=_contiguous_stride(dst))


def _pointwise(func, args, kwargs):
    """An elementwise operator DTensor has no rule for (``log_sigmoid``'s
    forward and backward): on the local tensors, every non-empty DTensor
    argument (all of one shape) laid out as the most sharded one, partial
    sums reduced, the outputs alike (an empty buffer output
    replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dts = [a for a in pytree.tree_leaves((args, kwargs))
           if isinstance(a, DTensor) and a.numel() > 0]
    if not dts:
        return None
    if any(tuple(d.shape) != tuple(dts[0].shape) for d in dts):
        return None
    # a partial sum is reduced first (the operator is not linear)
    pick = [[p if isinstance(p, (Shard, Replicate)) else Replicate()
             for p in d.placements] for d in dts]
    mesh = dts[0].device_mesh
    target = max(pick, key=lambda pl: np.prod(
        [mesh.size(i) for i, p in enumerate(pl) if isinstance(p, Shard)]))

    def local(a):
        if not isinstance(a, DTensor):
            return a
        if a.numel() > 0 and list(a.placements) != target:
            a = a.redistribute(a.device_mesh, target)
        return a.to_local()
    la, lk = pytree.tree_map(local, (args, kwargs))
    out = func(*la, **lk)
    ref = dts[0]

    def wrap(o):
        if not isinstance(o, torch.Tensor):
            return o
        if o.numel() == 0:
            return DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        return DTensor.from_local(o, mesh, target, run_check=False,
                                  shape=ref.shape, stride=ref.stride())
    return pytree.tree_map(wrap, out)


def _slice(func, args, kwargs):
    """A slice along a sharded dim (a chunk loop's ``q[:, c0:c0 + L]``
    over a sequence split on 'model'): the L rows gathered to every
    device, an all-gather of L rows, not of the whole dim as DTensor's
    rule does (it gathers, then slices).  Costs only: the rows gathered
    are each device's first ones; for values DTensor's rule runs."""
    from torch.distributed._functional_collectives import all_gather_tensor
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if _EXACT[0] or kwargs:
        return None
    x, dim = args[0], args[1] if len(args) > 1 else 0
    start = args[2] if len(args) > 2 else None
    end = args[3] if len(args) > 3 else None
    step = args[4] if len(args) > 4 else 1
    if not isinstance(x, DTensor) or step != 1:
        return None
    dim = dim % x.ndim
    red = [i for i, p in enumerate(x.placements)
           if isinstance(p, Shard) and p.dim == dim]
    if not red or any(not isinstance(p, (Shard, Replicate))
                      for p in x.placements):
        return None
    n_dim = x.shape[dim]
    start = 0 if start is None else (start + n_dim if start < 0 else start)
    end = n_dim if end is None else min(end + n_dim if end < 0 else end,
                                        n_dim)
    length = max(end - start, 0)
    groups = 1
    for i in red:
        groups *= x.device_mesh.size(i)
    if length == 0 or length % groups:
        return None
    piece = x.to_local().narrow(dim, 0, length // groups).contiguous()
    for i in reversed(red):
        piece = all_gather_tensor(piece, dim, (x.device_mesh, i))
    pl = [Replicate() if i in red else p for i, p in enumerate(x.placements)]
    shape = list(x.shape)
    shape[dim] = length
    return DTensor.from_local(piece, x.device_mesh, pl, run_check=False,
                              shape=tuple(shape),
                              stride=_contiguous_stride(shape))


_RULES = {"logsumexp": _logsumexp, "scatter_add": _scatter_add,
          "index": _index, "index_put": _index_put,
          "_index_put_impl_": _index_put,
          "searchsorted": _on_replicas,
          "slice": _slice, "log_sigmoid_forward": _pointwise,
          "log_sigmoid_backward": _pointwise,
          "view": _view, "_unsafe_view": _view, "reshape": _view,
          "new_zeros": _new_factory,
          "new_empty": _new_factory, "new_ones": _new_factory,
          "new_full": _new_factory}


def _masked_dims(out) -> list:
    """Mesh dims on which a DTensor result is a masked partial."""
    from torch.distributed.tensor import DTensor
    if not isinstance(out, DTensor):
        return []
    return [i for i, p in enumerate(out.placements)
            if type(p).__name__ == "_MaskPartial"]


def _unshard(x, mesh_dims):
    """``x`` replicated over ``mesh_dims`` (its other placements kept)."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if i in mesh_dims else p
          for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, pl)


def _has_storage(t: torch.Tensor) -> bool:
    try:
        t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return False
    return True


def _replicated(func, args, kwargs):
    """``func`` on the full tensors of its DTensor arguments (gathered),
    its outputs replicated DTensors on the first argument's mesh.  An
    in-place operator writes the local shard of its result back."""
    from torch.distributed.tensor import DTensor, Replicate
    dts = [a for a in pytree.tree_leaves((args, kwargs))
           if isinstance(a, DTensor)]
    mesh = dts[0].device_mesh
    full = {id(a): a.full_tensor() for a in dts}
    la, lk = pytree.tree_map(
        lambda a: full[id(a)] if isinstance(a, DTensor) else a,
        (args, kwargs))
    out = func(*la, **lk)
    schema = func._schema
    if schema.arguments and schema.arguments[0].alias_info is not None \
            and schema.arguments[0].alias_info.is_write \
            and isinstance(args[0], DTensor):
        target = args[0]
        res = DTensor.from_local(full[id(target)], mesh,
                                 [Replicate()] * mesh.ndim, run_check=False)
        local = res.redistribute(mesh, target.placements).to_local()
        target.to_local().copy_(local)
        return target
    return pytree.tree_map(
        lambda o: DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        if isinstance(o, torch.Tensor) else o, out)


class _PrefixLoop(torch.autograd.Function):
    """A marked loop (``core/nn.py::scan``) over the time dim (dim 1) of
    its last argument, costed from its first one and two steps: the cost
    of T steps is c1 + (T - 1) * (c2 - c1), forward and backward alike
    (the sLSTM's time loop: 4,096 steps at train_4k, each a few DTensor
    operators).  Its outputs are the two-step run's, a per-step output
    (dim 1 of length 2) widened to T; its gradients are zeros of the
    inputs' shapes (the trace computes no values).  What the loop saves
    for its backward past the first steps is not in the peak."""

    @staticmethod
    def forward(ctx, walker, fn, *args):
        ctx.set_materialize_grads(False)
        ctx.walker, ctx.fn = walker, fn
        ctx.save_for_backward(*args)
        head, xs = args[:-1], args[-1]
        T = xs.shape[1]
        runs = _extrapolate(walker, T, lambda k: fn(*head, xs[:, :k]))
        ctx.timed = [o1.shape != o2.shape for o1, o2 in zip(*runs)]
        return tuple(_widen(walker, o, T) if t else o
                     for o, t in zip(runs[1], ctx.timed))

    @staticmethod
    def backward(ctx, *gouts):
        walker, fn, args = ctx.walker, ctx.fn, ctx.saved_tensors
        T = args[-1].shape[1]
        need = ctx.needs_input_grad[2:]

        def both(k):
            ins = [a.detach().requires_grad_(n) for a, n in zip(args, need)]
            with torch.enable_grad():
                outs = fn(*ins[:-1], ins[-1][:, :k])
                gs = [(torch.zeros_like(o) if g is None else
                       (g[:, :k] if t else g))
                      for o, g, t in zip(outs, gouts, ctx.timed)]
                torch.autograd.grad(
                    outs, [a for a, n in zip(ins, need) if n], gs,
                    allow_unused=True)
            return outs

        def forward_only(k):
            with torch.no_grad():
                return fn(*args[:-1], args[-1][:, :k])

        before = Cost().add(walker.cost)
        _extrapolate(walker, T, both)
        fb = Cost().add(walker.cost).add(before, -1.0)
        walker.cost = Cost().add(before)
        _extrapolate(walker, T, forward_only)
        fwd = Cost().add(walker.cost).add(before, -1.0)
        walker.cost = Cost().add(before).add(fb).add(fwd, -1.0)
        walker.paused += 1
        try:
            grads = [torch.zeros_like(a) if n else None
                     for a, n in zip(args, need)]
        finally:
            walker.paused -= 1
        walker._track([g for g in grads if g is not None], [])
        return (None, None, *grads)


def _extrapolate(walker, T: int, run):
    """Run ``run(k)`` for k = 1 and 2 under ``walker`` and leave its cost
    at the one-step run's plus (T - 1) times the second step's ->
    (outputs of run(1), outputs of run(2))."""
    base, n0 = Cost().add(walker.cost), len(walker.records)
    out1 = run(1)
    c1 = Cost().add(walker.cost).add(base, -1.0)
    r1 = collections.Counter(_key(r) for r in walker.records[n0:])
    walker.cost = Cost().add(base)
    del walker.records[n0:]
    out2 = run(min(2, T))
    c2 = Cost().add(walker.cost).add(base, -1.0)
    r2 = collections.Counter(_key(r) for r in walker.records[n0:])
    del walker.records[n0:]
    walker.cost = Cost().add(base).add(c1).add(
        Cost().add(c2).add(c1, -1.0), float(T - 1))
    for k, n in (r1 + collections.Counter(
            {k: (T - 1) * v for k, v in (r2 - r1).items()})).items():
        walker.records.append({"kind": k[0], "out_bytes": k[1],
                               "group_size": k[2], "weight": n})
    return out1, out2


def _key(rec) -> tuple:
    return (rec["kind"], rec["out_bytes"], rec["group_size"])


def _widen(walker, o, T: int):
    """A per-step output of the two-step run at T steps (dim 1)."""
    walker.paused += 1
    try:
        shape = list(o.shape)
        shape[1] = T
        full = o.narrow(1, 0, 1).expand(shape).contiguous()
    finally:
        walker.paused -= 1
    walker._track([full], [])
    return full


def _loop_hook(walker, prefix_loops):
    """``core/nn.py``'s ``SCAN_HOOK`` while the walker traces: the loops
    that ``prefix_loops(fn)`` picks are costed by ``_PrefixLoop``, the
    others run as they are."""
    def hook(fn, args):
        if prefix_loops(fn) and args[-1].shape[1] > 2:
            return _PrefixLoop.apply(walker, fn, *args)
        return fn(*args)
    return hook


def trace_cost(fn, *args, n_devices: int = 1, exact: bool = False,
               prefix_loops=None) -> dict:
    """Run ``fn(*args)`` under a fresh walker -> {"cost": Cost,
    "peak_bytes", "collectives" (``collective_bytes`` of
    the recorded collectives), "fallbacks", "errors", "out"}.  Fake (or
    DTensor-of-fake) arguments run inside their ``FakeTensorMode``; real
    ones compute real values; with ``exact`` the rules keep the values
    (a run on a real process group then gives the single-device
    numbers), without it they keep each device's local work.
    ``prefix_loops(fn)`` picks the marked loops to cost from their first
    steps (``_PrefixLoop``)."""
    fake = _fake_mode_of(args) or contextlib.nullcontext()
    w = Walker(n_devices)
    _HINTS.clear()
    _MERGES.clear()
    _EXACT[0] = exact
    from ..core import nn
    hook = nn.SCAN_HOOK
    if prefix_loops is not None:
        nn.SCAN_HOOK = _loop_hook(w, prefix_loops)
    try:
        with fake, _on_mesh(w), w:
            out = fn(*args)
    finally:
        _EXACT[0] = False
        nn.SCAN_HOOK = hook
    return {"cost": w.cost, "peak_bytes": w.peak,
            "collectives": collective_bytes(w.records),
            "fallbacks": dict(w.fallbacks), "errors": dict(w.errors),
            "out": out}


def _fake_mode_of(args):
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    for t in _tensors(args):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, FakeTensor):
            return t.fake_mode
    return None


@contextlib.contextmanager
def _gpu_collectives():
    """DTensor's Shard -> Shard redistribution as the all-to-all it is on
    cards (NCCL): on a 'cpu' mesh ``shard_dim_alltoall`` takes gloo's
    all-gather + chunk.  Replaced in every module that holds it by name,
    the group named by ``_resolve_group_name``, which torch 2.11 and 2.13
    both have (2.11 lacks ``_group_or_group_name``: ROADMAP C10), so the
    walker records the same collectives on either version."""
    import importlib
    import torch.distributed._functional_collectives as funcol

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))

    patched = []
    for name in ("_collective_utils", "placement_types", "_redistribute"):
        mod = importlib.import_module(f"torch.distributed.tensor.{name}")
        if hasattr(mod, "shard_dim_alltoall"):
            patched.append((mod, mod.shard_dim_alltoall))
            mod.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for mod, fn in patched:
            mod.shard_dim_alltoall = fn


@contextlib.contextmanager
def _unrecorded_propagation(walker):
    """DTensor infers an operator's output shapes by running it on fake
    tensors of the GLOBAL shapes, once per new input layout: that is not
    any device's work, so the walker pauses for it."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:
        yield
        return
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        yield
        return

    def paused(self, *a, **k):
        walker.paused += 1
        try:
            return orig(self, *a, **k)
        finally:
            walker.paused -= 1

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def _on_mesh(walker):
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), _gpu_collectives(), \
            _unrecorded_propagation(walker):
        yield
