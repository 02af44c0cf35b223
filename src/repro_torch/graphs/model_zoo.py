"""Real-model workload zoo (twin of ``repro/graphs/model_zoo.py``):
registry configs -> placement-ready graphs.

For each architecture of the registry (``repro_torch/configs``) this
module traces ONE repetition of the model's block pattern (its "layer",
the unit that is replicated over depth and whose per-block assignment the
paper scales out in Appendix I) from the port's own models
(``repro_torch/models``) through :func:`repro_torch.graphs.fx_import.
fx_to_graph`, yielding a :class:`DataflowGraph` with FLOP / byte costs at
the published widths.

The trace is fully abstract (parameters and activations are fake tensors
of their shapes), so importing the 110B-parameter qwen config allocates no
weights.  Cheap-vertex fusion keeps the graphs at kernel granularity
(~100-500 vertices a layer).

Every model is addressable through the workload registry::

    from repro_torch.graphs.workloads import get_workload
    g = get_workload("model:gemma_2b")        # any registry arch id/alias

Input vertices carry the reference's labels (``block0.attn.wq``,
``shared_attn.wq``, ``x``, ``positions`` ...), operator vertices the ATen
operator's name.
"""
from __future__ import annotations

import collections
import functools
import os
import sys

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from ..configs.registry import ALIASES, ARCH_IDS, get_config
from ..core.graph import DataflowGraph
from ..core.nn import tree_map
from ..models.common import cast_block_params, dtype_of
from ..models.transformer import (ATTN_KINDS, _attn_block_apply,
                                  _init_attn_block, _init_block,
                                  _ssm_block_apply)
from .fx_import import fx_to_graph

DEFAULT_SEQ = 256


def zoo_model_names() -> tuple:
    """All importable architecture ids (the registry's ARCH_IDS)."""
    return ARCH_IDS


def canonical_arch(name: str) -> str:
    """Normalize an arch id/alias ('gemma-2b' -> 'gemma_2b')."""
    arch = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown model {name!r}; have {ARCH_IDS}")
    return arch


def _clean_path(path) -> str:
    """pytree key path -> dotted label: [0][2]['core']['w_in'] ->
    0.2.core.w_in"""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _tensor_leaves(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _block_apply(kind, p, shared, cfg, x, positions):
    """One block in train mode, its weights cast at use (the reference's
    ``_block_apply``; plain backends: the trace is on the CPU)."""
    cdt = dtype_of(cfg.compute_dtype)
    if kind in ATTN_KINDS:
        w = shared if kind == "attn_shared" else p
        return _attn_block_apply(cast_block_params(w, cdt), cfg, x,
                                 positions, "train", None, None, "torch")[0]
    return _ssm_block_apply(kind, cast_block_params(p, cdt), cfg, x,
                            "train", None, "torch")[0]


def layer_spec(cfg, *, seq: int = DEFAULT_SEQ, batch: int = 1,
               unit_blocks: int | None = None):
    """(fn, example_args, arg_labels) for one pattern-unit forward pass.

    The parameters are ``meta`` tensors of the blocks' shapes, as
    ``(blocks, shared)`` (the reference's tree); ``arg_labels`` name them
    as the reference does (``block{i}.{kind}.…``, ``shared_attn.…``), in
    PyTorch's flattening order, then ``x`` and ``positions``.
    `unit_blocks` truncates long pattern units (xlstm's is 8 blocks) to
    the first k entries — a representative sub-layer for cheap sweeps."""
    unit = tuple(cfg.block_pattern)
    if unit_blocks is not None:
        unit = unit[:max(1, unit_blocks)]
    dtype = dtype_of(cfg.param_dtype)
    with FakeTensorMode():              # shapes only: no weights drawn
        gen = torch.Generator().manual_seed(0)
        blocks = [None if kind == "attn_shared"
                  else _init_block(gen, kind, cfg, dtype) for kind in unit]
        shared = (_init_attn_block(gen, cfg, dtype)
                  if "attn_shared" in unit else None)
    params = tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                            device="meta"), (blocks, shared))

    def layer(blocks_and_shared, x, positions):
        blocks, shared = blocks_and_shared
        for i, kind in enumerate(unit):
            x = _block_apply(kind, blocks[i], shared, cfg, x, positions)
        return x

    labels = []
    for path, leaf in pytree.tree_flatten_with_path(params)[0]:
        if not isinstance(leaf, torch.Tensor):
            continue
        head, *rest = _clean_path(path).split(".", 2)
        if head == "0":        # (blocks, shared): [0][i]... is block i
            lbl = f"block{rest[0]}.{unit[int(rest[0])]}"
            rest = rest[1:]
        else:
            lbl = "shared_attn"
        labels.append(".".join([lbl, *rest]))
    x = torch.empty(batch, seq, cfg.d_model,
                    dtype=dtype_of(cfg.compute_dtype), device="meta")
    pos = torch.empty(1, seq, dtype=torch.int32, device="meta")
    return layer, (params, x, pos), labels + ["x", "positions"]


def import_model(name: str, *, seq: int = DEFAULT_SEQ, batch: int = 1,
                 unit_blocks: int | None = None, fuse_cheap: bool = True,
                 cheap_flops: float = 1e4, **full_kwargs) -> DataflowGraph:
    """Trace one layer of registry model `name` into a DataflowGraph.

    ``<arch>:full`` names dispatch to :func:`import_model_full` — the
    full-depth training-step graph (forward + backward of every layer,
    tiled across microbatches).

    Graphs are cached per (arch, shape) — they are frozen/immutable, so
    sharing is safe; aliases hit the same cache entry."""
    if name.endswith(FULL_SUFFIX):
        return import_model_full(name[:-len(FULL_SUFFIX)], seq=seq,
                                 batch=batch, unit_blocks=unit_blocks,
                                 fuse_cheap=fuse_cheap,
                                 cheap_flops=cheap_flops, **full_kwargs)
    if full_kwargs:
        raise TypeError(f"unexpected kwargs for a single-block import: "
                        f"{sorted(full_kwargs)}")
    return _import_model(canonical_arch(name), seq, batch, unit_blocks,
                         fuse_cheap, cheap_flops)


@functools.lru_cache(maxsize=64)
def _import_model(arch: str, seq: int, batch: int,
                  unit_blocks: int | None, fuse_cheap: bool,
                  cheap_flops: float) -> DataflowGraph:
    cfg = get_config(arch)
    fn, args, labels = layer_spec(cfg, seq=seq, batch=batch,
                                  unit_blocks=unit_blocks)
    return fx_to_graph(fn, *args, name=f"model:{arch}",
                       fuse_cheap=fuse_cheap, cheap_flops=cheap_flops,
                       arg_labels=labels)


def import_all(**kwargs) -> dict[str, DataflowGraph]:
    """{arch: graph} for the full registry — the scenario zoo."""
    return {a: import_model(a, **kwargs) for a in ARCH_IDS}


# ------------------------------------------------------------- full models
FULL_SUFFIX = ":full"


def train_step_spec(cfg, *, seq: int = DEFAULT_SEQ, batch: int = 1,
                    unit_blocks: int | None = None):
    """(fn, example_args, arg_labels) for one pattern-unit *training step*.

    The unit computes the layer forward pass plus its backward pass
    (``torch.autograd.grad``, the twin of the reference's ``jax.vjp``) and
    returns ``(y, g_x, g_params)`` — the activation fed to the next
    repetition, the input cotangent fed to the previous one, and the
    parameter gradients (exits).  Tiling these units forward (``y -> x``)
    and backward (``g_x -> g_out``) yields the dataflow graph of a full
    training step."""
    layer, (params, x, pos), labels = layer_spec(cfg, seq=seq, batch=batch,
                                                 unit_blocks=unit_blocks)

    def unit(params, x, g_out, positions):
        leaves = _tensor_leaves(params)
        with torch.enable_grad():
            y = layer(params, x, positions)
            grads = torch.autograd.grad(y, [x] + leaves, g_out,
                                        allow_unused=True)
        g_params = [torch.zeros_like(p) if g is None else g
                    for p, g in zip(leaves, grads[1:])]
        return y, grads[0], g_params

    params = tree_map(lambda t: t.requires_grad_(), params)
    # layer_spec labels end with ["x", "positions"]; the unit's flattened
    # arguments are (params..., x, g_out, positions)
    return (unit, (params, x.requires_grad_(), x.detach(), pos),
            labels[:-2] + ["x", "g_out", "positions"])


def import_model_full(name: str, *, seq: int = DEFAULT_SEQ, batch: int = 1,
                      microbatches: int = 2, n_layers: int | None = None,
                      unit_blocks: int | None = None,
                      fuse_cheap: bool = True,
                      cheap_flops: float = 1e4) -> DataflowGraph:
    """Full-depth training-step graph for registry model `name`.

    One block-pattern unit's forward+backward is traced ONCE and tiled
    structurally (``graphs/partition.tile_graph``) across the model's
    depth — repetition i's ``x`` comes from repetition i-1's activation,
    its ``g_out`` from repetition i+1's input cotangent — and then
    across ``microbatches`` parallel copies sharing the parameter
    vertices.  A 16-layer model imports in seconds regardless of depth,
    and the result carries the replication structure that lets
    ``coarsen`` tile segment labels instead of re-coarsening ~10k
    vertices."""
    return _import_model_full(canonical_arch(name), seq, batch,
                              int(microbatches), n_layers, unit_blocks,
                              fuse_cheap, cheap_flops)


class _ByteLRUCache:
    """LRU cache budgeted in estimated graph bytes, not entry count.

    Full-depth training-step graphs range from a few MB (olmo_1b) to
    several hundred MB at 100k+ vertices; an entry-count LRU of 16 can
    hold multiple GB and OOM a benchmark sweep.  This cache charges each
    graph its :meth:`DataflowGraph.nbytes_estimate` and evicts least-
    recently-used entries until under budget.  Budget comes from the
    ``REPRO_ZOO_CACHE_BYTES`` env var (default 2 GiB); a single graph
    larger than the whole budget is returned uncached.  Evictions are
    logged to stderr so sweeps that thrash are visible."""

    DEFAULT_BYTES = 2 << 30

    def __init__(self, fn):
        self.fn = fn
        self._data: "collections.OrderedDict[tuple, DataflowGraph]" = \
            collections.OrderedDict()
        self.hits = self.misses = self.evictions = 0
        functools.update_wrapper(self, fn)

    @property
    def max_bytes(self) -> int:
        return int(os.environ.get("REPRO_ZOO_CACHE_BYTES",
                                  self.DEFAULT_BYTES))

    def cur_bytes(self) -> int:
        return sum(g.nbytes_estimate() for g in self._data.values())

    def __call__(self, *key):
        if key in self._data:
            self.hits += 1
            self._data.move_to_end(key)
            return self._data[key]
        self.misses += 1
        g = self.fn(*key)
        budget = self.max_bytes
        size = g.nbytes_estimate()
        if size > budget:
            return g                      # bigger than the whole budget
        self._data[key] = g
        total = self.cur_bytes()
        while total > budget and len(self._data) > 1:
            old_key, old_g = self._data.popitem(last=False)
            freed = old_g.nbytes_estimate()
            total -= freed
            self.evictions += 1
            print(f"[model_zoo] cache evict {old_key[0]!r} "
                  f"(~{freed / 1e6:.0f} MB, {total / 1e6:.0f} MB held, "
                  f"budget {budget / 1e6:.0f} MB)", file=sys.stderr)
        return g

    def cache_info(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._data),
                "bytes": self.cur_bytes(), "max_bytes": self.max_bytes}

    def cache_clear(self) -> None:
        self._data.clear()
        self.hits = self.misses = self.evictions = 0


@_ByteLRUCache
def _import_model_full(arch: str, seq: int, batch: int, microbatches: int,
                       n_layers: int | None, unit_blocks: int | None,
                       fuse_cheap: bool, cheap_flops: float) -> DataflowGraph:
    from .partition import tile_graph
    cfg = get_config(arch)
    fn, args, labels = train_step_spec(cfg, seq=seq, batch=batch,
                                       unit_blocks=unit_blocks)
    unit = fx_to_graph(fn, *args, name=f"model:{arch}:unit",
                       fuse_cheap=fuse_cheap, cheap_flops=cheap_flops,
                       arg_labels=labels)
    unit_len = len(cfg.block_pattern)
    if unit_blocks is not None:
        unit_len = min(unit_len, max(1, unit_blocks))
    depth = n_layers if n_layers is not None else cfg.n_layers
    reps = max(1, -(-depth // unit_len))            # ceil division
    name = f"model:{arch}:full"
    g = tile_graph(unit, reps, chains=(("x", 0, 1), ("g_out", 1, -1)),
                   shared_labels=("positions",),
                   name=name if microbatches <= 1 else f"{name}:chain")
    if microbatches > 1:
        per_mb = {"x", f"r{reps - 1}.g_out"} if reps > 1 else {"x", "g_out"}
        shared = [v.label for v in g.vertices
                  if g.is_input(v.vid) and v.label not in per_mb]
        g = tile_graph(g, microbatches, chains=(), shared_labels=shared,
                       rep_prefix="mb", name=name)
    return g
