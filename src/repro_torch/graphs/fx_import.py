"""PyTorch function -> DataflowGraph importer (twin of
``repro/graphs/jaxpr_import.py``).

Traces any PyTorch function (one layer of ``repro_torch/models``, or its
training step under ``torch.autograd.grad``) on fake tensors and returns a
:class:`DataflowGraph` whose vertices carry FLOP / byte costs estimated
from the ATen operators it dispatches.  Nothing is allocated on any
device: the arguments become ``FakeTensor``s of their shapes and dtypes
(pass tensors on the ``meta`` device to describe them), so a 110B-
parameter layer imports with no weights in memory, as the reference's
``jax.eval_shape`` does.

Cost model (per operator), the reference's:
  mm / bmm / addmm / baddbmm:  2 * prod(output) * contracted size
  convolution:                 kind ``matmul``, prod(output)
  reductions:                  input size
  everything else:             output size
Bytes: the outputs' sizes (dtype-aware, never a zero itemsize).

Granularity.  A jaxpr and an ATen trace cut the same function
differently; the importer reads the trace at the reference's grain:

* Pure aliases make no vertex (``detach``, ``alias``, ``lift_fresh``);
  a constant tensor made from host data is an input ``const{i}``, a 0-d
  one a literal (no vertex).
* View operators are held back.  Consumed by a matrix product they are
  its dimension numbers and make no vertex (the ``t`` / ``permute`` /
  ``unsqueeze`` / ``view`` around ``mm`` and ``bmm``, and the reshape of a
  product's result back to its batch shape); consumed by anything else,
  a chain of views becomes one vertex (``reshape``, ``transpose`` or
  ``slice``: what one ``jnp`` call lowers to).
* ``torch.einsum`` is lowered as ``jnp.einsum``: opt_einsum's order, one
  ``dot_general`` a pair (a product without a contracted name included)
  and a transpose where the result's order needs one.  A product of the
  backward pass ends in a transpose, as the reference's transpose rule.
* Functions the reference's jaxpr holds as one ``jit`` (``where``,
  ``clip``, ``silu``, ``log_sigmoid``, ``cumsum``, ...) are one vertex,
  and so is each one's gradient, which reads the forward vertex (the
  jit's residuals); ``_softmax`` and ``gelu``, which it inlines, are its
  equations (max, subtract, exp, sum, divide; the tanh form's chain).
* A loop that the reference runs as one ``lax.scan`` is one vertex
  forward and one backward, at the reference's scan cost (the elements
  of its first output; the bytes of all outputs, and forward also of what
  the loop saves for the backward: the reference's residuals).  The model
  marks such a loop with ``core/nn.py::scan``; while this module traces,
  the mark runs the loop unrecorded.

``_fuse_cheap`` is the reference's, bit for bit (numpy only).
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import nn
from ..core.graph import DataflowGraph

# The reference's hints and kinds (``jaxpr_import.py:23-49``), over ATen
# operator names: convert_element_type is ``_to_copy``, logistic
# ``sigmoid``, select_n ``where``, iota ``arange``.
_ELEMWISE_HINT = ("add", "sub", "mul", "div", "exp", "log", "tanh", "sigmoid",
                  "max", "min", "pow", "rsqrt", "sqrt", "neg", "erf",
                  "where", "_to_copy", "silu", "gelu")

_KIND_MAP = {
    "mm": "matmul",
    "bmm": "matmul",
    "addmm": "matmul",
    "baddbmm": "matmul",
    "convolution": "matmul",
    "sum": "sum_reduction",
    "mean": "sum_reduction",
    "amax": "max_reduction",
    "max": "max_reduction",
    "argmax": "max_reduction",
    "amin": "min_reduction",
    "min": "min_reduction",
    "prod": "product_reduction",
    "view": "squeezer",
    "reshape": "squeezer",
    "squeeze": "squeezer",
    "unsqueeze": "squeezer",
    "expand": "squeezer",
    "permute": "squeezer",
    "transpose": "squeezer",
    "cat": "select",
    "slice": "select",
    "select": "select",
    "split": "select",
    "index": "select",
    "gather": "select",
    "scatter": "select",
    "scatter_add": "select",
    "index_put": "select",
    "arange": "fill",
    "cumsum": "sum_reduction",
    "logcumsumexp": "sum_reduction",
}

_MATMULS = frozenset(("mm", "bmm", "addmm", "baddbmm"))
_REDUCTIONS = frozenset(("sum", "mean", "amax", "amin", "max", "min", "prod",
                         "cumsum", "cumprod", "logcumsumexp", "any", "all"))
_ALIASES = frozenset(("detach", "alias", "lift_fresh", "lift_fresh_copy"))
# the view operators that reach the dispatcher (reshape, flatten, chunk,
# narrow ... decompose into these above it)
_RESHAPES = frozenset(("view", "_unsafe_view", "_reshape_alias", "unsqueeze",
                       "squeeze", "expand"))
_TRANSPOSES = frozenset(("permute", "transpose", "t"))
_SELECTS = frozenset(("slice", "select", "split", "split_with_sizes",
                      "unbind", "diagonal", "as_strided", "unfold"))
_VIEWS = _RESHAPES | _TRANSPOSES | _SELECTS
# ``jax.nn`` / ``jnp`` functions the reference's jaxpr holds as one ``jit``
# equation: forward one vertex, and the gradient one vertex (the jit's
# transpose) that reads the forward one (its residuals)
_JITS = frozenset(("where", "clamp", "log_sigmoid_forward", "silu",
                   "softplus", "cumsum", "tril", "var"))
# and the ones it inlines, which the trace holds as one operator: run as
# PyTorch's decomposition (softmax: reduce_max, sub, exp, reduce_sum, div)
# or, where that computes in another dtype, as the reference's equations
_DECOMPOSED = ("_softmax", "_softmax_backward_data")


def _gelu_tanh(x, approximate="none"):
    """``jax.nn.gelu`` (tanh form), equation by equation in x's dtype."""
    if approximate != "tanh":
        raise NotImplementedError("the models use gelu's tanh form")
    k = float(np.sqrt(2 / np.pi))
    return x * ((torch.tanh((x + x ** 3 * 0.044715) * k) + 1.0) * 0.5)


def _gelu_tanh_backward(g, x, approximate="none"):
    """Its gradient: the residuals (x², tanh, 1 - tanh²) and the chain."""
    if approximate != "tanh":
        raise NotImplementedError("the models use gelu's tanh form")
    k = float(np.sqrt(2 / np.pi))
    x2 = x * x
    t = torch.tanh((x + x2 * x * 0.044715) * k)
    dt = 1.0 - t * t
    d_inner = (x2 * (3 * 0.044715) + 1.0) * k
    return g * ((t + 1.0) * 0.5 + x * 0.5 * dt * d_inner)


_INLINED = {"gelu": _gelu_tanh, "gelu_backward": _gelu_tanh_backward}


def _nbytes(t: torch.Tensor) -> float:
    """Size of ``t`` in bytes; an itemsize the dtype does not give is
    taken as 4 bytes, never 0."""
    elems = float(np.prod(t.shape, dtype=np.float64)) if t.dim() else 1.0
    itemsize = getattr(t.dtype, "itemsize", None) or 4
    return elems * float(itemsize)


def _elems(t: torch.Tensor) -> float:
    return float(np.prod(t.shape, dtype=np.float64)) if t.dim() else 1.0


def _kind_of(name: str) -> str:
    if name in _KIND_MAP:
        return _KIND_MAP[name]
    if any(h in name for h in _ELEMWISE_HINT):
        return "straight_elemwise"
    return "input_elemwise"


def _flops_of(name: str, ins: list, outs: list) -> float:
    out_elems = _elems(outs[0])
    if name in _MATMULS:
        a = ins[1] if name in ("addmm", "baddbmm") else ins[0]
        return 2.0 * out_elems * float(a.shape[-1])
    if name in _REDUCTIONS and ins:
        return _elems(ins[0])
    return out_elems


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _optimal_path(inputs: list, output: frozenset, sizes: dict) -> list:
    """opt_einsum's ``optimal`` contraction order (the reference's
    ``jnp.einsum`` takes it for up to four operands): a depth-first search
    over pair contractions, the first cheapest path found; as a linear
    path of position pairs."""
    best = {"flops": float("inf"), "path": ()}

    def size(idx):
        return int(np.prod([sizes[i] for i in idx], dtype=np.int64)) \
            if idx else 1

    def visit(path, remaining, sets, flops):
        if len(remaining) == 1:
            best["flops"], best["path"] = flops, path
            return
        for i, j in itertools.combinations(sorted(remaining), 2):
            either, shared = sets[i] | sets[j], sets[i] & sets[j]
            keep = frozenset.union(output, *(sets[r] for r in remaining
                                             if r not in (i, j)))
            k12 = either & keep
            cost = size(either) * (2 if shared - keep else 1)
            if flops + cost >= best["flops"]:
                continue
            visit(path + ((i, j),), (remaining - {i, j}) | {len(sets)},
                  sets + (k12,), flops + cost)

    visit((), frozenset(range(len(inputs))), tuple(inputs), 0)
    ids, linear = list(range(len(inputs))), []
    for ssa in best["path"]:                     # ssa -> linear positions
        pos = sorted(ids.index(s) for s in ssa)
        for k in reversed(pos):
            ids.pop(k)
        ids.append(len(inputs) + len(linear))
        linear.append(tuple(pos))
    return linear


class _DotGeneral(torch.autograd.Function):
    """One ``lax.dot_general`` of the reference's ``jnp.einsum``: x and y
    indexed by ``xn`` and ``yn``, batch names ``bn`` and contracted names
    ``cn``; the result is indexed batch, x's free names, y's free names.
    Forward one product vertex; backward, for each operand that needs it,
    the transpose rule's product and its transpose."""

    @staticmethod
    def forward(ctx, rec, x, y, xn, yn, bn, cn):
        free = lambda n: "".join(c for c in n if c not in bn + cn)
        out = bn + free(xn) + free(yn)
        with rec.pause():
            res = torch.einsum(f"{xn},{yn}->{out}", x, y)
        k = float(np.prod([x.shape[xn.index(c)] for c in cn],
                          dtype=np.float64)) if cn else 1.0
        rec.bind(res, rec.add("matmul", "dot_general",
                              2.0 * _elems(res) * k, _nbytes(res), res.shape,
                              [rec.resolve(x, True), rec.resolve(y, True)]))
        ctx.rec, ctx.names = rec, (xn, yn, free(xn), free(yn))
        ctx.save_for_backward(x, y)
        return res

    @staticmethod
    def backward(ctx, g):
        rec, (x, y), (xn, yn, xf, yf) = ctx.rec, ctx.saved_tensors, ctx.names
        grads = []
        for need, a, an, other, on, of in ((ctx.needs_input_grad[1], x, xn,
                                            y, yn, yf),
                                           (ctx.needs_input_grad[2], y, yn,
                                            x, xn, xf)):
            if not need:
                grads.append(None)
                continue
            k = float(np.prod([other.shape[on.index(c)] for c in of],
                              dtype=np.float64)) if of else 1.0
            with rec.pause():
                ga = torch.zeros_like(a)
            v = rec.add("matmul", "dot_general", 2.0 * _elems(a) * k,
                        _nbytes(a), a.shape, [rec.resolve(g, True),
                                              rec.resolve(other, True)])
            rec.bind(ga, rec.add("squeezer", "permute", _elems(a),
                                 _nbytes(a), a.shape, [v]))
            grads.append(ga)
        return (None, *grads, None, None, None, None)


class _EinsumAsJax(TorchFunctionMode):
    """Routes ``torch.einsum`` to :meth:`_Recorder.einsum` while the
    recorder traces (not inside a marked loop)."""

    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.functional.einsum and not self.rec.paused:
            eq, *ops = args
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = list(ops[0])
            return self.rec.einsum(eq, ops)
        return func(*args, **kwargs)


class _View:
    """A held-back view: ``root`` (the tensor whose storage it reads) and
    the chain of view calls from it, each ``(call id, operator name)``."""
    __slots__ = ("root", "chain", "out_bytes")

    def __init__(self, root, chain, out_bytes):
        self.root, self.chain, self.out_bytes = root, chain, out_bytes


class _Recorder(TorchDispatchMode):
    """Records every ATen call below autograd as a graph vertex."""

    def __init__(self, name: str):
        super().__init__()
        self.g = DataflowGraph(name)
        self.vid: dict[int, int] = {}        # id(tensor) -> vertex
        self.views: dict[int, _View] = {}    # id(tensor) -> held-back view
        self.keep: list = []                 # keeps ids unique while tracing
        self.matmul_vids: set[int] = set()
        self.materialized: dict[tuple, int] = {}
        self.calls = itertools.count()
        self.consts: dict[int, torch.Tensor] = {}   # not yet read
        self.jit_outs: list = []             # (forward output, vertex)
        self.jit_nodes: dict = {}            # its autograd node -> vertex
        self.jit_bwd: dict = {}              # node -> its gradient vertex
        self.meta = 0
        self.n_const = 0
        self.paused = False

    # ------------------------------------------------------------ vertices
    def add(self, kind, label, flops, out_bytes, shape, preds) -> int:
        v = self.g.add_vertex(kind, flops=flops, out_bytes=out_bytes,
                              meta_op=self.meta, role="shard", label=label,
                              out_shape=tuple(shape))
        self.meta += 1
        for p in preds:
            self.g.add_edge(p, v)
        return v

    def bind(self, t: torch.Tensor, v: int) -> None:
        self.keep.append(t)
        self.views.pop(id(t), None)
        self.vid[id(t)] = v

    def add_input(self, t: torch.Tensor, label: str) -> int:
        v = self.g.add_vertex("input", out_bytes=_nbytes(t), label=label,
                              out_shape=tuple(t.shape))
        self.bind(t, v)
        return v

    def root_vid(self, t: torch.Tensor) -> int | None:
        """The vertex that last wrote ``t`` (a non-view tensor)."""
        v = self.vid.get(id(t))
        if v is None and id(t) in self.consts:
            del self.consts[id(t)]
            v = self.add_input(t, f"const{self.n_const}")
            self.n_const += 1
        elif v is None and t.dim() > 0:
            v = self.add_input(t, "captured")
        return v

    def resolve(self, t: torch.Tensor, for_matmul: bool = False):
        """The vertex whose output ``t`` is, materializing a held-back view
        unless a matrix product absorbs it; None for a literal."""
        view = self.views.get(id(t))
        if view is None:
            return self.root_vid(t)
        base = self.root_vid(view.root)
        if for_matmul or base is None:
            return base
        chain = view.chain
        if base in self.matmul_vids:
            # the product's own output shape: dot_general writes it
            # directly, without the matmul's reshape back
            skip = 0
            while skip < len(chain) and chain[skip][1] in ("_unsafe_view",
                                                            "view"):
                skip += 1
            chain = chain[skip:]
        if not chain:
            return base
        key = (base, tuple(c for c, _ in chain))
        if key not in self.materialized:
            names = [n for _, n in chain]
            label = next((n for n in names if n in _TRANSPOSES),
                         next((n for n in names if n in _SELECTS),
                              names[-1]))
            label = {"t": "permute", "_unsafe_view": "view",
                     "_reshape_alias": "view"}.get(label, label)
            self.materialized[key] = self.add(
                _kind_of(label), label, _elems(t), view.out_bytes,
                t.shape, [base])
        return self.materialized[key]

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if not self.paused and name in _DECOMPOSED:
            from torch._decomp import decomposition_table
            with self:
                return decomposition_table[func](*args, **kwargs)
        if not self.paused and name in _INLINED:
            with self:
                return _INLINED[name](*args, **kwargs)
        out = func(*args, **kwargs)
        if self.paused:
            return out
        outs = _tensors(out)
        if not outs:
            return out
        ins = _tensors((args, kwargs))
        inplace = name.endswith("_") and ins and outs[0] is ins[0]
        base_name = name[:-1] if inplace else name
        if base_name in _ALIASES or (base_name == "to" and ins
                                     and outs[0] is ins[0]):
            self.alias(outs[0], ins[0] if ins else None)
        elif base_name in _VIEWS and not inplace:
            self.view(base_name, ins[0], outs)
        else:
            self.op("_to_copy" if base_name == "to" else base_name, ins,
                    outs, inplace)
        return out

    def jit_forward(self, node):
        """The forward vertex of a jit whose gradient ``node`` computes."""
        if node not in self.jit_nodes and self.jit_outs:
            for t, v in self.jit_outs:
                if t.grad_fn is not None:
                    self.jit_nodes[t.grad_fn] = v
            self.jit_outs = []
        return self.jit_nodes.get(node)

    def alias(self, out: torch.Tensor, src) -> None:
        if src is None or (id(src) not in self.vid
                           and id(src) not in self.views):
            # a constant made from host data: an input once it is read
            # (its conversions fold into it, made on the host), or a
            # literal
            if out.dim() > 0:
                self.keep.append(out)
                self.consts[id(out)] = out
            return
        self.keep.append(out)
        if id(src) in self.views:
            self.views[id(out)] = self.views[id(src)]
        else:
            self.vid[id(out)] = self.vid[id(src)]

    def view(self, name: str, src: torch.Tensor, outs: list) -> None:
        call = next(self.calls)
        held = self.views.get(id(src))
        root, chain = (held.root, held.chain) if held else (src, ())
        total = sum(_nbytes(o) for o in outs)
        for o in outs:
            self.keep.append(o)
            self.vid.pop(id(o), None)
            self.views[id(o)] = _View(root, chain + ((call, name),), total)

    def op(self, name, ins, outs, inplace) -> None:
        if (name == "_to_copy" and len(ins) == 1 and id(ins[0]) in self.consts
                and id(ins[0]) not in self.views):
            del self.consts[id(ins[0])]
            self.keep.append(outs[0])
            self.consts[id(outs[0])] = outs[0]
            return
        mm = name in _MATMULS
        preds = [self.resolve(t, for_matmul=mm) for t in ins]
        preds = [p for p in preds if p is not None]
        node = torch._C._current_autograd_node()
        fwd = self.jit_forward(node) if node is not None else None
        if fwd is not None:
            # the gradient of a jit: one vertex that reads the forward one
            v = self.jit_bwd.get(node)
            if v is None:
                v = self.jit_bwd[node] = self.add(
                    "input_elemwise", self.g.vertices[fwd].label,
                    _elems(outs[0]), _nbytes(outs[0]), outs[0].shape,
                    [fwd])
            for p in preds:
                if p != v:
                    self.g.add_edge(p, v)
            vx = self.g.vertices[v]
            vx.flops = max(vx.flops, _elems(outs[0]))
            vx.out_bytes = max(vx.out_bytes, _nbytes(outs[0]))
        else:
            v = self.add(_kind_of(name), name, _flops_of(name, ins, outs),
                         sum(_nbytes(o) for o in outs), outs[0].shape,
                         preds)
            if name in _JITS and node is None:
                self.jit_outs.append((outs[0], v))
        if mm:
            self.matmul_vids.add(v)
            if node is not None:
                # a product of the backward pass: the reference's
                # dot_general transpose rule ends in a transpose
                v = self.add("squeezer", "permute", _elems(outs[0]),
                             _nbytes(outs[0]), outs[0].shape, [v])
                self.matmul_vids.add(v)
        if inplace:
            target = outs[0]
            root = self.views[id(target)].root if id(target) in self.views \
                else target
            self.bind(root, v)
            return
        for o in outs:
            self.bind(o, v)

    # -------------------------------------------------------------- einsum
    def einsum(self, eq: str, ops: list) -> torch.Tensor:
        """``jnp.einsum``'s lowering: opt_einsum's path, then per pair the
        singleton filter, the sums of names only one side holds, one
        ``dot_general`` (the orientation that needs no transpose when one
        does) and the transpose to the result's order."""
        ins, out = eq.replace(" ", "").split("->")
        names = ins.split(",")
        sizes: dict = {}
        for nm, t in zip(names, ops):
            for c, d in zip(nm, t.shape):
                sizes[c] = max(sizes.get(c, 1), int(d))
        sets = [frozenset(n) for n in names]
        path = (_optimal_path(sets, frozenset(out), sizes) if len(ops) > 2
                else [tuple(range(len(ops)))])
        ops, names = list(ops), list(names)
        for cnum, pos in enumerate(path):
            pos = sorted(pos, reverse=True)
            rest = [st for i, st in enumerate(sets) if i not in pos]
            idx = frozenset.union(*(sets[i] for i in pos))
            new = frozenset(out).union(*rest) & idx
            removed = sorted(idx - new)
            sets = rest + [new]
            tmp = [names.pop(i) for i in pos]
            xs = [ops.pop(i) for i in pos]
            if cnum == len(path) - 1:
                result = out
            else:
                allin = "".join(tmp)
                result = "".join(sorted(new, key=allin.find))
            names.append(result)
            ops.append(self._einsum_step(xs, tmp, removed, result))
        return ops[0]

    @staticmethod
    def _sum_uniques(x, n, uniques):
        if uniques:
            x = x.sum(dim=[n.index(c) for c in uniques])
            n = "".join(c for c in n if c not in uniques)
        return x, n

    def _einsum_step(self, xs, tmp, removed, result):
        if len(xs) == 1:
            (x,), (n,) = xs, tmp
            x, n = self._sum_uniques(x, n, [c for c in removed
                                            if n.count(c) == 1])
        else:
            (x, y), (xn, yn) = xs, tmp

            def squeeze(a, an, b, bn):       # jax's filter_singleton_dims
                drop = [i for i, c in enumerate(an) if a.shape[i] == 1
                        and c in bn and b.shape[bn.index(c)] != 1]
                if drop:
                    a = a.squeeze(drop)
                return a, "".join(c for i, c in enumerate(an)
                                  if i not in drop)

            x, xn = squeeze(x, xn, y, yn)
            y, yn = squeeze(y, yn, x, xn)
            x, xn = self._sum_uniques(x, xn, [c for c in removed
                                              if c in xn and c not in yn])
            y, yn = self._sum_uniques(y, yn, [c for c in removed
                                              if c in yn and c not in xn])
            cn = "".join(c for c in removed if c in xn or c in yn)
            bn = "".join(c for c in result if c in xn and c in yn)
            free = lambda a: "".join(c for c in a if c not in bn + cn)
            if bn + free(yn) + free(xn) == result:
                x, xn, y, yn = y, yn, x, xn
            x = _DotGeneral.apply(self, x, y, xn, yn, bn, cn)
            n = bn + free(xn) + free(yn)
        if n != result:
            x = x.permute([n.index(c) for c in result])
        return x

    # --------------------------------------------------------------- scans
    def scan(self, fn, args):
        return _ScanLeaf.apply(self, fn, *args)

    @contextlib.contextmanager
    def pause(self):
        was, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = was

    def scan_vertex(self, ins, outs, res_bytes=0.0, extra=()) -> int:
        preds = [self.resolve(t) for t in ins if isinstance(t, torch.Tensor)]
        v = self.add("input_elemwise", "scan", _elems(outs[0]),
                     sum(_nbytes(o) for o in outs) + res_bytes,
                     outs[0].shape,
                     [p for p in list(preds) + list(extra) if p is not None])
        for o in outs:
            self.bind(o, v)
        return v


class _ScanLeaf(torch.autograd.Function):
    """One marked loop as one vertex forward and one backward.  Forward:
    the loop runs unrecorded; its outputs, and under autograd the tensors
    it saves for the backward (the reference's residuals, which its
    forward scan outputs), are the vertex's.  Backward: the gradients of
    all its floating inputs, in argument order, are the vertex's outputs
    (tensors of their shapes: the trace is fake)."""

    @staticmethod
    def forward(ctx, rec, fn, *args):
        ctx.set_materialize_grads(False)
        needs = ctx.needs_input_grad[2:]
        saved: dict = {}

        def pack(t):                         # held: ids stay unique
            base = t if t._base is None else t._base
            saved[id(base)] = base
            return t

        # autograd is off inside a Function's forward: run the loop on
        # detached inputs with it on, to see what it saves
        ins = [a.detach().requires_grad_(need) if need else a
               for a, need in zip(args, needs)]
        with rec.pause(), torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            outs = tuple(o.detach() for o in fn(*ins))
        own = {id(a) for a in ins}
        res = sum(_nbytes(t) for i, t in saved.items() if i not in own)
        ctx.rec, ctx.fwd = rec, rec.scan_vertex(args, outs, res)
        ctx.save_for_backward(*args)
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        rec, args = ctx.rec, ctx.saved_tensors
        with rec.pause():                    # fake: shapes are all it takes
            grads = [torch.zeros_like(a) for a in args
                     if a.is_floating_point()]
        rec.scan_vertex(list(args) + [g for g in gouts if g is not None],
                        grads, extra=[ctx.fwd])
        it = iter(grads)
        out = [next(it) if a.is_floating_point() else None for a in args]
        return (None, None, *[g if need else None for g, need
                              in zip(out, ctx.needs_input_grad[2:])])


def _fake_args(fake_mode, example_args):
    """Fake copies of the example arguments' tensors (shape, dtype and
    ``requires_grad`` kept; on the CPU, whatever device they name, so the
    plain versions of the kernels are what is traced)."""
    def fake(x):
        if not isinstance(x, torch.Tensor):
            return x
        with fake_mode:
            t = torch.empty(tuple(x.shape), dtype=x.dtype)
        return t.requires_grad_(x.requires_grad)
    return pytree.tree_map(fake, example_args)


def fx_to_graph(fn, *example_args, name: str = "fx",
                fuse_cheap: bool = True, cheap_flops: float = 1e4,
                arg_labels=None) -> DataflowGraph:
    """Trace ``fn`` on example args (pytrees of tensors; ``meta`` tensors
    describe shapes without memory) and import the trace as a
    DataflowGraph.

    fuse_cheap: absorb near-zero-cost vertices into their one consumer
    (:func:`_fuse_cheap`, the reference's).  Vertex labels are the ATen
    operator names (``mm``, ``_to_copy`` ...), ``scan`` for a marked loop.

    arg_labels: input-vertex labels, one per flattened tensor leaf of the
    arguments (``torch.utils._pytree`` order: dicts in insertion order);
    falls back to ``arg{i}``.  The outputs are ``fn``'s flattened tensor
    results."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = _fake_args(fake_mode, example_args)
    rec = _Recorder(name)
    for i, t in enumerate(_tensors(args)):
        lbl = (arg_labels[i] if arg_labels is not None
               and i < len(arg_labels) else f"arg{i}")
        rec.add_input(t, lbl)
    hook, nn.SCAN_HOOK = nn.SCAN_HOOK, rec.scan
    try:
        with fake_mode, rec, _EinsumAsJax(rec):
            result = fn(*args)
    finally:
        nn.SCAN_HOOK = hook
    g = rec.g
    outs = [rec.resolve(t) for t in _tensors(result)]
    g.outputs = [v for v in outs if v is not None]
    g.freeze()
    if fuse_cheap:
        g = _fuse_cheap(g, cheap_flops)
    return g


def _fuse_cheap(g: DataflowGraph, cheap_flops: float) -> DataflowGraph:
    """Collapse vertices with negligible cost and exactly one consumer into
    that consumer (kernel-granularity view).

    The surviving root keeps its own (stable) label — or, for graphs from
    other sources whose roots may be unlabeled, inherits the label of the
    topo-first absorbed vertex that has one — and absorbs the fused
    vertices' flops so the graph's total compute is conserved.

    Fully vectorized (pointer-jumping root resolution + np.add.at flop
    accumulation in topo order) so fusing a 100k-vertex tiled graph is
    milliseconds, with outputs bit-identical to the per-vertex loops it
    replaced."""
    n = g.n
    flops = g.flops_array()
    out_deg = np.array([len(g.succs[v]) for v in range(n)])
    absorbed = (~g.input_mask()) & (flops <= cheap_flops) & (out_deg == 1)
    nxt = np.arange(n, dtype=np.int64)
    av = np.flatnonzero(absorbed)
    nxt[av] = np.array([g.succs[v][0] for v in av.tolist()],
                       dtype=np.int64) if len(av) else av
    root_of = nxt.copy()                 # pointer jumping to the fixpoint
    while True:
        hop = root_of[root_of]
        if (hop == root_of).all():
            break
        root_of = hop

    # flop accumulation + label inheritance in topo order (np.add.at adds
    # in element order, matching the sequential loop bit-for-bit; earliest
    # absorbed label per root wins)
    topo = np.asarray(g.topo_order, dtype=np.int64)
    sel = topo[absorbed[topo]]
    extra = np.zeros(n)
    np.add.at(extra, root_of[sel], flops[sel])
    lab_sel = sel[[bool(g.vertices[v].label) for v in sel.tolist()]]
    rr = root_of[lab_sel]
    uniq_r, first = np.unique(rr, return_index=True)
    inherited_label = {int(r): g.vertices[int(lab_sel[i])].label
                       for r, i in zip(uniq_r, first)}

    keep = np.flatnonzero(~absorbed)
    remap = np.full(n, -1, dtype=np.int64)
    remap[keep] = np.arange(len(keep))
    kl = keep.tolist()
    E = g.edge_array().astype(np.int64)
    if len(E):
        rs, rd = root_of[E[:, 0]], root_of[E[:, 1]]
        m = rs != rd
        K = len(keep)
        keys = np.unique(remap[rs[m]] * K + remap[rd[m]])   # sorted+dedup
        new_edges = np.stack([keys // K, keys % K], axis=1)
    else:
        new_edges = np.zeros((0, 2), dtype=np.int64)
    return DataflowGraph.from_arrays(
        g.name,
        [g.vertices[v].kind for v in kl],
        flops[keep] + extra[keep],
        g.out_bytes_array()[keep],
        meta_op=[g.vertices[v].meta_op for v in kl],
        roles=[g.vertices[v].role for v in kl],
        labels=[g.vertices[v].label or inherited_label.get(v, "")
                for v in kl],
        out_shapes=[g.vertices[v].out_shape for v in kl],
        edges=new_edges,
        # an absorbed output's value is produced (cost-model-wise) by
        # its root
        outputs=[int(remap[root_of[v]]) for v in g.outputs])
