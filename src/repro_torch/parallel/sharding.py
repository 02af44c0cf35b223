"""Sharding rules (twin of ``repro/parallel/sharding.py``): parameter,
optimizer, data and decode-state partition specs, and their DTensor
placements.

Baseline layout, the reference's:

  * batch           -> ('pod', 'data') when the pod axis exists, else 'data'
  * params          -> FSDP over 'data' x tensor-parallel over 'model'
  * optimizer state -> same spec as its parameter (ZeRO)
  * MoE experts     -> expert-parallel over 'model' when divisible,
                       else hidden-dim TP fallback (granite's 40 experts)
  * KV caches       -> kv-heads over 'model' when divisible, else sequence
                       dim over 'model' (sequence-parallel decode — gemma/
                       paligemma MQA)

Every rule is divisibility-guarded: a dim that does not divide the mesh
axis falls back (next rule or replication).  The rules read only the
mesh's axis sizes, so ``mesh`` is anything :func:`mesh_sizes` reads: a
``DeviceMesh`` with dim names, a ``{name: size}`` mapping, or an object
with such a ``shape``.  The port keeps the reference's parameter layout
(``unit`` leaves stacked on axis 0), so the rules reach the same leaves by
the same paths ("unit/0/wq", "embed", ...).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..models.config import ModelConfig


class PartitionSpec(tuple):
    """One entry per dim: None (replicated), an axis name, or a tuple of
    axis names (the dim split over their product, the first major), as
    ``jax.sharding.PartitionSpec`` (which, as here, stores a one-axis
    tuple as the axis name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, a mapping or an object with
    a ``shape`` mapping; {} for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def batch_axis_size(mesh) -> int:
    return int(np.prod([axis_size(mesh, a) for a in batch_axes(mesh)]))


def _ok(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    total = int(np.prod([axis_size(mesh, a) for a in axes]))
    return dim % total == 0


def guarded(mesh, shape, *spec) -> P:
    """PartitionSpec with divisibility guard per dim (None on failure)."""
    return P(*(axes if _ok(dim, mesh, axes) else None
               for dim, axes in zip(shape, spec)))


# ------------------------------------------------------------- parameters
def _leaf_spec(path: str, shape, mesh, cfg: ModelConfig,
               fsdp: bool = True) -> P:
    d = "data" if fsdp else None
    nd = len(shape)
    stacked = path.startswith("unit/") and nd >= 1
    core = tuple(shape[1:]) if stacked else tuple(shape)

    def wrap(spec: P) -> P:
        return P(None, *spec) if stacked else spec

    name = path.split("/")[-1]
    # ---- embeddings / head
    if name == "embed":
        return guarded(mesh, shape, "model", d)
    if name == "head":
        return guarded(mesh, shape, d, "model")
    # ---- 1D (norm scales, biases, gates)
    if len(core) == 1:
        if name in ("bq", "bk", "bv"):
            return wrap(guarded(mesh, core, "model"))
        return wrap(P(None))
    # ---- MoE
    if "/moe/" in path or path.endswith("/router"):
        if name == "router":
            return wrap(guarded(mesh, core, d, None))
        E = core[0]
        if _ok(E, mesh, "model"):
            if name == "w_down":
                return wrap(guarded(mesh, core, "model", None, d))
            return wrap(guarded(mesh, core, "model", d, None))
        # fallback when E does not divide 'model' (granite's 40 experts)
        if cfg.moe is not None and cfg.moe.fallback == "token_parallel":
            return wrap(guarded(mesh, core, None, d, None))
        # baseline: hidden-dim tensor parallelism
        if name == "w_down":
            return wrap(guarded(mesh, core, None, "model", d))
        return wrap(guarded(mesh, core, None, d, "model"))
    # ---- attention
    if name in ("wq", "wk", "wv"):
        return wrap(guarded(mesh, core, d, "model"))
    if name == "wo":
        return wrap(guarded(mesh, core, "model", d))
    # ---- dense FFN / SSM projections
    if name in ("w_gate", "w_up", "w_in", "w_q", "w_k", "w_v", "w_if",
                "w_gates"):
        return wrap(guarded(mesh, core, d, "model"))
    if name in ("w_down", "w_out"):
        return wrap(guarded(mesh, core, "model", d))
    if name == "conv":
        return wrap(guarded(mesh, core, None, "model"))
    return wrap(P(*([None] * len(core))))    # r_gates (H, P, 4P) and rest


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts / lists / tuples (NamedTuples
    kept), paths joined with "/" as the reference's ``_path_str``; None
    stays None (an empty slot, as in a JAX pytree)."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, join(i)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return None if tree is None else fn(path, tree)


def param_specs(params: Any, mesh, cfg: ModelConfig, fsdp: bool = True):
    """Spec tree mirroring ``params`` (tensors of any device, or anything
    with a ``shape``)."""
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), mesh, cfg,
                                      fsdp), params)


def opt_specs(opt_state, pspecs):
    """AdamState(step, mu, nu) -> (P(), pspecs, pspecs)."""
    from ..train.optim import AdamState
    return AdamState(P(), pspecs, pspecs)


# ------------------------------------------------------------------- data
def data_specs(batch: dict, mesh):
    ba = batch_axes(mesh)

    def spec_of(path, leaf):
        b = leaf.shape[0]
        first = ba if _ok(b, mesh, ba) else None
        return P(first, *([None] * (len(leaf.shape) - 1)))

    return tree_map_with_path(spec_of, batch)


# ----------------------------------------------------------- decode state
def decode_state_specs(state: Any, mesh, cfg: ModelConfig):
    """KV caches (..., B, T, Hkv, hd): kv-heads over 'model' if divisible
    else sequence over 'model'; batch over data axes if divisible.
    SSM states (..., B, H, P, N): heads over 'model' when divisible."""
    ba = batch_axes(mesh)
    m = axis_size(mesh, "model")

    def spec_of(path, leaf):
        stacked = path.startswith("unit/")
        shape = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd >= 1 and _ok(shape[0], mesh, ba):
            spec[0] = ba
        if nd == 4:                       # (B, T, Hkv, hd) KV cache
            if _ok(shape[2], mesh, "model") and shape[2] >= m:
                spec[2] = "model"
            elif _ok(shape[1], mesh, "model"):
                spec[1] = "model"         # sequence-parallel KV
        elif nd == 3 and _ok(shape[1], mesh, "model") and shape[1] >= m:
            spec[1] = "model"             # (B, H, P) slstm state
        elif nd >= 3:                     # (B, H, P, N) GLA/mamba state
            if _ok(shape[1], mesh, "model") and shape[1] >= m:
                spec[1] = "model"
        out = P(*spec)
        return P(None, *out) if stacked else out

    return tree_map_with_path(spec_of, state)


# --------------------------------------------------------------- DTensor
def to_placements(spec, device_mesh) -> list:
    """A spec as DTensor placements on ``device_mesh`` (one per mesh dim):
    ``Shard(d)`` on the mesh dims that dim d is split over, ``Replicate()``
    elsewhere.  A dim over two axes (('pod', 'data')) takes both mesh
    dims; DTensor splits a dim sharded on several mesh dims in mesh-dim
    order, the first the major, which is JAX's order of the tuple as long
    as the tuple lists its axes in mesh order (the rules' batch axes do).
    A mesh dim of one rank splits nothing and stays ``Replicate()``
    (DTensor's view rules refuse to merge a "split" dim of size 1)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(device_mesh.mesh_dim_names)
    sizes = mesh_sizes(device_mesh) if hasattr(device_mesh, "shape") else {}
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in mesh order {names}")
        for i in idx:
            if sizes.get(names[i], 2) > 1:
                out[i] = Shard(d)
    return out


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec`` (every rule divides evenly, so every shard is alike)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        out[d] //= int(np.prod([sizes.get(a, 1) for a in axes]))
    return tuple(out)


def spec_leaves(specs) -> list:
    """Spec leaves in ``core.nn.tree_leaves`` order (dict keys sorted; a
    spec is a tuple, not a subtree)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [x for t in specs for x in spec_leaves(t)]
    return []


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree; the structure
    (NamedTuples included) is kept, None stays None."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_specs(fn, v, specs[i]) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return None if tree is None else fn(tree, specs)


def shard_tree(tree, specs, device_mesh):
    """Every leaf of ``tree`` laid out by its spec (``shard_array``)."""
    return map_with_specs(lambda x, sp: shard_array(x, device_mesh, sp),
                          tree, specs)


def shard_array(x, device_mesh, spec):
    """``x`` (one process's full copy, as every rank holds it) as a
    DTensor laid out by ``spec``; the counterpart of ``device_put``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, device_mesh, to_placements(spec, device_mesh))
