"""Copy of ``src/repro/graphs/partition.py`` (the port imports nothing of ``repro``).

Deterministic graph coarsening + structural replication for hierarchical
placement (coarsen -> place -> refine).

DOPPLER's SEL/PLC rollout is O(steps x vertices), so flat placement caps
out at block-pattern units (~100-500 vertices).  Full multi-layer models
(thousands to tens of thousands of operations) are placed hierarchically:

* :func:`coarsen` contracts a flat :class:`DataflowGraph` into a
  segment-level ``DataflowGraph`` of roughly ``n_segments`` compute
  segments (plus one input segment per distinct consumer set).  The dual
  policy then places *segments*; :meth:`Partition.expand` maps a segment
  assignment back to a flat one, and ``core/hierarchy.py`` refines the
  boundary vertices on the flat graph.
* :func:`tile_graph` replicates a traced block-pattern unit across model
  depth (and microbatches) in graph space — no re-tracing, no re-fusion —
  and records the replication structure so :func:`coarsen` only has to
  coarsen the *unit* once and tile the segment labels (full models
  compile in seconds).

Conservation contract (mirrors ``jaxpr_import._fuse_cheap`` and enforced
by tests/test_properties.py): a segment's ``flops`` is the exact sum of
its members' flops; the per-member byte totals are recoverable through
``vertex_segment``; and a segment edge (s, t) exists iff some flat edge
crosses s -> t (reachability is conserved, never invented).  The segment
vertex's ``out_bytes`` is its *boundary-transfer* total: the bytes of
members whose results cross the segment boundary — what a segment-level
transfer actually has to move.

Coarsening is deterministic (pure numpy / ordered python — no RNG), so
the same graph always yields the same partition; checkpoints store the
``vertex_segment`` map and can verify it on resume.

Acyclicity: contraction alternates two provably-safe passes on the
current quotient DAG — merging a cluster into its *unique successor*
(clusters form in-trees: every external out-edge leaves from the root,
so a quotient cycle would imply a cycle in the pass-start DAG) and the
symmetric unique-predecessor pass — then falls back to packing clusters
in topological order (edges only go forward across bins).  The segment
graph's ``freeze()`` re-validates acyclicity at the end.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graph import DataflowGraph

__all__ = ["Partition", "Replication", "MultilevelPartition", "coarsen",
           "coarsen_multilevel", "tile_graph"]


# ---------------------------------------------------------------------------
# Replication metadata (attached to tiled graphs)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Replication:
    """How a flat graph was tiled from a repeated unit.

    ``unit_vid[v]`` is the unit vertex that flat vertex ``v`` instantiates
    and ``rep_of[v]`` the repetition index (shared vertices — e.g. the
    position ids every layer reads — count as repetition 0).

    ``phase`` (per *unit* vertex) marks the chain phase when the tiling
    has a backward chain: 1 for vertices reachable from a negative-step
    chain input (the backward pass), else 0.  Tiled cross-repetition
    edges run phase0(i) -> phase0/1(i+1) and phase1(i+1) -> phase1(i),
    and no backward vertex ever feeds a forward one (reachability from
    the cotangent input is successor-closed) — so any coarsening that
    never merges across phases tiles into an acyclic segment quotient.
    """
    unit: DataflowGraph
    n_rep: int
    unit_vid: np.ndarray            # (n_flat,) -> unit vertex id
    rep_of: np.ndarray              # (n_flat,) -> repetition index
    phase: np.ndarray | None = None  # (unit.n,) chain phase, or None


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Partition:
    """A coarsening of ``flat`` into ``seg_graph`` segments."""
    flat: DataflowGraph
    seg_graph: DataflowGraph
    vertex_segment: np.ndarray      # (n_flat,) -> segment id
    seg_flops: np.ndarray           # (S,) exact sum of member flops
    seg_bytes: np.ndarray           # (S,) sum of member out_bytes
    boundary_bytes: np.ndarray      # (S,) member bytes crossing the boundary
    cross_bytes: np.ndarray         # (seg_graph.m,) bytes per segment edge

    @property
    def n_segments(self) -> int:
        return self.seg_graph.n

    def members(self, s: int) -> np.ndarray:
        return np.flatnonzero(self.vertex_segment == s)

    def expand(self, seg_assignment) -> np.ndarray:
        """Segment assignment(s) -> flat assignment(s).

        Accepts a single ``(S,)`` row or a batch ``(K, S)``; the trailing
        axis is expanded to ``flat.n`` through the vertex->segment map."""
        a = np.asarray(seg_assignment)
        if a.shape[-1] != self.n_segments:
            raise ValueError(f"segment assignment has {a.shape[-1]} entries,"
                             f" expected {self.n_segments}")
        return a[..., self.vertex_segment]


# ---------------------------------------------------------------------------
# Multi-level partitions (METIS-style V-cycle)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MultilevelPartition:
    """A stack of :class:`Partition` levels: ``levels[0]`` coarsens the
    flat graph, ``levels[k]`` coarsens ``levels[k-1].seg_graph``; the top
    level's segment graph is what the policy places.

    Duck-types the single-:class:`Partition` surface that
    ``core/hierarchy.py`` and the trainer consume (``flat``,
    ``seg_graph``, ``vertex_segment``, ``expand``, ``members``,
    ``n_segments``), with ``vertex_segment`` the *composed* flat->top
    map — so a one-level stack is indistinguishable from the Partition
    it wraps.  ``level_stats`` records per-level contraction bookkeeping
    (vertex counts and coarsen seconds) for the scalability benchmarks.
    """
    levels: list[Partition]
    level_stats: list[dict] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.levels:
            raise ValueError("MultilevelPartition needs >= 1 level")
        composed = self.levels[0].vertex_segment
        for part in self.levels[1:]:
            composed = part.vertex_segment[composed]
        self.vertex_segment = composed

    @property
    def flat(self) -> DataflowGraph:
        return self.levels[0].flat

    @property
    def seg_graph(self) -> DataflowGraph:
        return self.levels[-1].seg_graph

    @property
    def n_segments(self) -> int:
        return self.seg_graph.n

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_graph(self, k: int) -> DataflowGraph:
        """Graph at level ``k``: 0 = flat, ``n_levels`` = the top segment
        graph (level ``k``'s graph is what ``levels[k]`` coarsens *into*
        for k >= 1)."""
        return self.flat if k == 0 else self.levels[k - 1].seg_graph

    def members(self, s: int) -> np.ndarray:
        return np.flatnonzero(self.vertex_segment == s)

    def expand(self, seg_assignment, to_level: int = 0) -> np.ndarray:
        """Top-level segment assignment(s) -> assignment(s) at
        ``to_level`` (default: all the way down to the flat graph)."""
        a = np.asarray(seg_assignment)
        if a.shape[-1] != self.n_segments:
            raise ValueError(f"segment assignment has {a.shape[-1]} entries,"
                             f" expected {self.n_segments}")
        if to_level == 0:
            return a[..., self.vertex_segment]
        for part in reversed(self.levels[to_level:]):
            a = part.expand(a)
        return a


def coarsen_multilevel(graph: DataflowGraph, n_segments: int,
                       cap_factor: float = 2.0, max_ratio: float = 16.0,
                       max_levels: int = 16) -> MultilevelPartition:
    """Coarsen ``graph`` level by level until it fits ``n_segments``.

    Each level contracts by at most ``max_ratio`` (compute vertices), the
    METIS-style bounded-contraction V-cycle: one-shot contraction ratios
    in the thousands destroy partition quality (Mayer et al.), so a
    131k-vertex graph reaches a 64-segment top through ~3 intermediate
    levels instead of one 2000x jump, and refinement can later walk back
    down the same stack level by level.

    Graphs within ``max_ratio`` of the target produce a single level
    that is exactly ``coarsen(graph, n_segments, cap_factor)``.
    Deterministic like :func:`coarsen`; stops early when a level stops
    making progress."""
    import time as _time
    n_segments = max(1, int(n_segments))
    max_ratio = max(1.5, float(max_ratio))
    levels: list[Partition] = []
    stats: list[dict] = []
    g = graph
    for _ in range(max(1, int(max_levels))):
        n_compute = int((~g.input_mask()).sum())
        target = max(n_segments, -(-n_compute // int(max_ratio)))
        t0 = _time.perf_counter()
        part = coarsen(g, target, cap_factor)
        dt = _time.perf_counter() - t0
        if levels and part.seg_graph.n >= g.n:
            break                           # no progress: keep the stack
        levels.append(part)
        stats.append({"level": len(levels), "n_in": g.n,
                      "n_out": part.seg_graph.n, "target": target,
                      "seconds": dt})
        g = part.seg_graph
        if int((~g.input_mask()).sum()) <= n_segments:
            break
    return MultilevelPartition(levels, stats)


# ---------------------------------------------------------------------------
# Coarsening
# ---------------------------------------------------------------------------
def coarsen(graph: DataflowGraph, n_segments: int,
            cap_factor: float = 2.0) -> Partition:
    """Contract ``graph`` toward ``n_segments`` compute segments.

    ``cap_factor`` bounds segment imbalance: no contraction may grow a
    segment past ``cap_factor * total_flops / n_segments`` (packing's
    final bin may exceed it when the target forces it).

    Tiled graphs (see :func:`tile_graph`) take the structural fast path:
    the unit is coarsened once and its labels are tiled across every
    repetition, so cost is independent of model depth.
    """
    n_segments = max(1, int(n_segments))
    rep = getattr(graph, "replication", None)
    if rep is not None and n_segments < graph.n and rep.n_rep > 1:
        per_unit = max(1, int(round(n_segments / rep.n_rep)))
        unit_labels = _coarsen_labels(rep.unit, per_unit, cap_factor,
                                      phase=rep.phase)
        width = int(unit_labels.max()) + 1
        labels = unit_labels[rep.unit_vid] + rep.rep_of * width
        return _partition_from_labels(graph, labels)
    return _partition_from_labels(
        graph, _coarsen_labels(graph, n_segments, cap_factor))


def _coarsen_labels(g: DataflowGraph, target: int, cap_factor: float,
                    phase: np.ndarray | None = None) -> np.ndarray:
    """(n,) raw cluster labels: compute-vertex contraction + input grouping.

    Input vertices never mix with compute clusters (they are free and
    resident everywhere in the WC engines); each distinct consumer-cluster
    set becomes one input cluster.  When ``phase`` is given (chain-tiled
    units, see :class:`Replication`), clusters never span phases — the
    invariant that keeps the tiled segment quotient acyclic."""
    n = g.n
    is_input = g.input_mask()
    compute = np.flatnonzero(~is_input)
    flops = g.flops_array()
    phase = (np.zeros(n, dtype=np.int64) if phase is None
             else np.asarray(phase, dtype=np.int64))

    parent = np.arange(n)

    def find(v: int) -> int:
        r = v
        while parent[r] != r:
            r = parent[r]
        while parent[v] != r:
            parent[v], v = r, parent[v]
        return r

    def roots_all() -> np.ndarray:
        """Fully path-compress ``parent`` by pointer jumping; returns the
        per-vertex root array (the vectorized twin of mapping ``find``
        over every vertex — same roots, O(m log n) numpy instead of a
        Python loop)."""
        while True:
            pp = parent[parent]
            if np.array_equal(pp, parent):
                return parent
            parent[:] = pp

    # compute->compute edges once; cluster pairs are recomputed per pass
    # from the evolving union-find roots
    E = g.edge_array()
    ce_mask = (~is_input[E[:, 0]] & ~is_input[E[:, 1]]) if len(E) else \
        np.zeros(0, dtype=bool)
    ce_src = E[ce_mask, 0].astype(np.int64)
    ce_dst = E[ce_mask, 1].astype(np.int64)

    cflops = flops.copy()
    n_clusters = len(compute)
    if n_clusters > target:
        cap = max(float(flops.sum()) * cap_factor / target,
                  float(flops.max(initial=0.0)))
        pos = np.empty(n, dtype=np.int64)
        pos[g.topo_order] = np.arange(n)

        for _ in range(32):
            if n_clusters <= target:
                break
            merged = 0
            for direction in ("succ", "pred"):
                if n_clusters <= target:
                    break
                # unique (cluster, cluster) pairs over compute-only edges,
                # keyed by the merge-candidate side of the pair
                r = roots_all()
                cu, cv = r[ce_src], r[ce_dst]
                diff = cu != cv
                key_cl = cu[diff] if direction == "succ" else cv[diff]
                oth_cl = cv[diff] if direction == "succ" else cu[diff]
                pairs = np.unique(key_cl * n + oth_cl)
                keys, idx, cnt = np.unique(pairs // n, return_index=True,
                                           return_counts=True)
                # unique-neighbor merges, applied in (topo-first) order so
                # chained merges respect the flops cap incrementally;
                # cross-phase merges are forbidden (see Replication.phase)
                sel = cnt == 1
                cands = keys[sel]
                others = (pairs % n)[idx[sel]]
                sel = phase[cands] == phase[others]
                cands, others = cands[sel], others[sel]
                order = np.lexsort((cands, pos[cands]))
                if direction == "pred":
                    order = order[::-1]
                for c, oth in zip(cands[order].tolist(),
                                  others[order].tolist()):
                    if n_clusters <= target:
                        break
                    rc = find(c)
                    if rc != c:                    # already absorbed this pass
                        continue
                    ro = find(oth)
                    if ro == rc or cflops[rc] + cflops[ro] > cap:
                        continue
                    parent[rc] = ro
                    cflops[ro] += cflops[rc]
                    n_clusters -= 1
                    merged += 1
            if not merged:
                break

        if n_clusters > target:
            # topological packing: clusters in topo-first order into bins
            # bounded by the mean-flops budget (edges only go forward, so
            # the quotient over bins stays acyclic); one bin stream per
            # phase so packed bins never span phases either
            root_of = roots_all()
            uniq = np.unique(root_of[compute])
            roots = uniq[np.lexsort((uniq, pos[uniq]))].tolist()
            phases = sorted({int(phase[c]) for c in roots})
            total = float(flops.sum())
            bin_of: dict[int, int] = {}
            next_bin = 0
            for p in phases:
                roots_p = [c for c in roots if phase[c] == p]
                flops_p = float(sum(cflops[c] for c in roots_p))
                target_p = max(1, int(round(target * flops_p
                                            / max(total, 1e-30))))
                budget = flops_p / target_p
                b, acc, bins_used = next_bin, 0.0, 1
                for c in roots_p:
                    f = float(cflops[c])
                    if acc > 0 and acc + f > budget and bins_used < target_p:
                        b += 1
                        bins_used += 1
                        acc = 0.0
                    bin_of[c] = b
                    acc += f
                next_bin = b + 1
            bin_arr = np.full(n, -1, dtype=np.int64)
            bin_arr[roots] = [bin_of[c] for c in roots]
            pack = np.empty(n, dtype=np.int64)
            pack[compute] = bin_arr[root_of[compute]]

            labels_compute = pack
        else:
            labels_compute = None
    else:
        labels_compute = None

    labels = np.full(n, -1, dtype=np.int64)
    if labels_compute is not None:
        labels[compute] = labels_compute[compute]
    else:
        # root ids, compacted later by _partition_from_labels
        labels[compute] = roots_all()[compute]

    # input grouping: one cluster per distinct consumer-cluster set
    base = int(labels.max(initial=0)) + 1
    groups: dict[tuple, int] = {}
    for v in np.flatnonzero(is_input):
        key = tuple(sorted({int(labels[w]) for w in g.succs[v]}))
        gid = groups.get(key)
        if gid is None:
            gid = groups[key] = base + len(groups)
        labels[v] = gid
    return labels


def _partition_from_labels(g: DataflowGraph, raw: np.ndarray) -> Partition:
    """Compact raw labels (topo-first order), build the segment graph.

    Fully vectorized (no per-vertex/per-edge Python loops) so 100k+-vertex
    graphs partition in tens of milliseconds; every reduction mirrors the
    original sequential accumulation order bit-for-bit (``np.add.at``
    applies additions in element order, and first-occurrence dedup uses
    ``np.unique(..., return_index=True)``)."""
    n = g.n
    raw = np.asarray(raw, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)
    pos[g.topo_order] = np.arange(n)

    # compact labels in topo-first order: each label's segment id is the
    # rank of its earliest member position (labels partition the vertex
    # set, so first positions are distinct; first_vid only tie-breaks the
    # degenerate n == 0 shapes)
    uniq, inv = np.unique(raw, return_inverse=True)
    L = len(uniq)
    first_pos = np.full(L, n, dtype=np.int64)
    np.minimum.at(first_pos, inv, pos)
    first_vid = np.full(L, n, dtype=np.int64)
    np.minimum.at(first_vid, inv, np.arange(n))
    rank = np.empty(L, dtype=np.int64)
    rank[np.lexsort((first_vid, first_pos))] = np.arange(L)
    seg = rank[inv]
    S = L

    flops = g.flops_array()
    out_bytes = g.out_bytes_array()
    is_input = g.input_mask()

    seg_flops = np.zeros(S)
    np.add.at(seg_flops, seg, flops)
    seg_bytes = np.zeros(S)
    np.add.at(seg_bytes, seg, out_bytes)

    # boundary bytes: each member with >= 1 consumer outside its segment
    # contributes its out_bytes once
    crosses_out = np.zeros(n, dtype=bool)
    E = g.edge_array()
    cross_edges = np.zeros((0, 2), dtype=np.int64)
    if len(E):
        cross = seg[E[:, 0]] != seg[E[:, 1]]
        crosses_out[E[cross, 0]] = True
        cross_edges = E[cross].astype(np.int64)
    boundary = np.zeros(S)
    np.add.at(boundary, seg[crosses_out], out_bytes[crosses_out])

    # segment edges + per-edge transfer byte totals (each producer counted
    # once per destination segment — the transfer-dedup convention of
    # simulator.consumers_on): keep the first edge per (producer, dest
    # segment) pair in edge order, then sum producer bytes per segment
    # pair in that same order
    if len(cross_edges):
        cu, cv = cross_edges[:, 0], seg[cross_edges[:, 1]]
        _, first = np.unique(cu * S + cv, return_index=True)
        keep = np.sort(first)
        ku, kv = cu[keep], cv[keep]
        pair_key, pair_inv = np.unique(seg[ku] * S + kv,
                                       return_inverse=True)
        cross_arr = np.zeros(len(pair_key))
        np.add.at(cross_arr, pair_inv, out_bytes[ku])
        seg_edges = np.stack([pair_key // S, pair_key % S], axis=1)
    else:
        cross_arr = np.zeros(0)
        seg_edges = np.zeros((0, 2), dtype=np.int64)

    # representative member per segment: the max-flops non-input member
    # (lowest vid on ties) names the segment's kind/label; input-only
    # segments fall back to their lowest-vid member
    rep_member = np.full(S, -1, dtype=np.int64)
    nonin = np.flatnonzero(~is_input)
    if len(nonin):
        order = np.lexsort((nonin, -flops[nonin], seg[nonin]))
        sv = seg[nonin][order]
        first = np.ones(len(sv), dtype=bool)
        first[1:] = sv[1:] != sv[:-1]
        rep_member[sv[first]] = nonin[order][first]
    lowest = np.full(S, n, dtype=np.int64)
    np.minimum.at(lowest, seg, np.arange(n))
    input_only = rep_member < 0
    rep_member[input_only] = lowest[input_only]

    seg_in = is_input[rep_member]
    rep_labels = [g.vertices[int(r)].label for r in rep_member]
    out = DataflowGraph.from_arrays(
        f"{g.name}|seg{S}",
        ["input" if seg_in[s] else g.vertices[int(rep_member[s])].kind
         for s in range(S)],
        np.where(seg_in, 0.0, seg_flops),
        np.where(seg_in, seg_bytes, boundary),
        meta_op=np.where(seg_in, -1, np.arange(S)),
        roles=["input" if seg_in[s] else "shard" for s in range(S)],
        labels=[f"seg{s}:{lbl}" if lbl else f"seg{s}"
                for s, lbl in enumerate(rep_labels)],
        edges=seg_edges)
    return Partition(flat=g, seg_graph=out, vertex_segment=seg,
                     seg_flops=seg_flops, seg_bytes=seg_bytes,
                     boundary_bytes=boundary, cross_bytes=cross_arr)


# ---------------------------------------------------------------------------
# Structural replication (tiling)
# ---------------------------------------------------------------------------
def tile_graph(unit: DataflowGraph, n_rep: int, *,
               chains=(("x", 0, 1),),
               shared_labels=("positions",),
               rep_prefix: str = "r",
               name: str | None = None) -> DataflowGraph:
    """Tile ``unit`` ``n_rep`` times into one flat DataflowGraph.

    chains: iterable of ``(input_label, output_index, step)`` — the chain
    contract between repetitions.  Repetition ``i``'s input vertex
    labeled ``input_label`` is replaced by repetition ``i - step``'s
    ``unit.outputs[output_index]`` instance when that repetition exists;
    at the boundary (``i - step`` outside ``[0, n_rep)``) the input
    vertex is kept as a real graph input.  ``step=1`` is a forward chain
    (layer i consumes layer i-1's activation), ``step=-1`` a backward
    chain (layer i consumes layer i+1's input-cotangent) — together they
    tile a full training step.

    shared_labels: input labels instantiated once and shared by every
    repetition (position ids; for microbatch tiling, the parameters).

    The result carries a :class:`Replication` (``.replication``) so
    :func:`coarsen` can tile the unit's segment labels instead of
    re-coarsening the full graph; tiling a graph that is itself tiled
    composes the maps down to the innermost unit.
    """
    if n_rep < 1:
        raise ValueError("n_rep must be >= 1")
    if not getattr(unit, "_frozen", False):
        raise ValueError("unit graph must be frozen")
    label_of = {v.label: v.vid for v in unit.vertices}
    chain_in: dict[int, tuple[int, int]] = {}      # input vid -> (out vid, step)
    for (lbl, out_idx, step) in chains:
        if lbl not in label_of:
            raise KeyError(f"chain input {lbl!r} not found in {unit.name}")
        if out_idx >= len(unit.outputs):
            raise ValueError(f"unit {unit.name} records {len(unit.outputs)} "
                             f"outputs; chain wants index {out_idx}")
        vin = label_of[lbl]
        if not unit.is_input(vin):
            raise ValueError(f"chain vertex {lbl!r} is not an input")
        chain_in[vin] = (unit.outputs[out_idx], int(step))
    shared = {label_of[lbl] for lbl in shared_labels if lbl in label_of}
    shared -= set(chain_in)

    meta_width = max((v.meta_op for v in unit.vertices), default=-1) + 1
    U = unit.n

    # --- which (repetition, unit vertex) cells materialize a flat vertex
    # (streaming CSR construction: per-unit arrays tiled across reps, no
    # per-repetition Python dicts — peak state is O(unit) + the output
    # columns, and cost is numpy-vectorized over all reps at once)
    shared_mask = np.zeros(U, dtype=bool)
    shared_mask[list(shared)] = True
    chain_out = np.full(U, -1, dtype=np.int64)      # chain input -> out vid
    chain_step = np.zeros(U, dtype=np.int64)
    for vin, (ov, step) in chain_in.items():
        chain_out[vin] = ov
        chain_step[vin] = step
    is_chain = chain_out >= 0

    jj = np.arange(n_rep)[:, None] - chain_step[None, :]    # (R, U) source rep
    inside = is_chain[None, :] & (jj >= 0) & (jj < n_rep)
    created = np.ones((n_rep, U), dtype=bool)
    created[1:, shared_mask] = False                # shared: rep 0 only
    created[inside] = False                 # chain inputs with a live source
    flat_id = np.cumsum(created.ravel()).reshape(n_rep, U) - 1

    # resolve[i, u] = the flat vertex that "unit vertex u in repetition i"
    # refers to: its own copy, rep 0's copy (shared), or the source
    # repetition's chain-output copy (substituted chain input)
    resolve = flat_id.copy()
    resolve[:, shared_mask] = flat_id[0, shared_mask][None, :]
    src_rep = np.broadcast_to(jj, (n_rep, U))[inside]
    src_out = np.broadcast_to(chain_out[None, :], (n_rep, U))[inside]
    resolve[inside] = resolve[src_rep, src_out]     # after shared substitution

    # --- vertex columns, in the same row-major (rep, unit-vertex) order
    # the incremental builder used
    rep_idx, uvid = np.nonzero(created)
    u_flops = unit.flops_array()
    u_bytes = unit.out_bytes_array()
    u_meta = np.asarray([v.meta_op for v in unit.vertices], dtype=np.int64)
    kinds = [unit.vertices[u].kind for u in uvid]
    roles = [unit.vertices[u].role for u in uvid]
    shapes = [unit.vertices[u].out_shape for u in uvid]
    labels = [unit.vertices[u].label if i == 0
              else f"{rep_prefix}{i}.{unit.vertices[u].label}"
              for i, u in zip(rep_idx.tolist(), uvid.tolist())]
    metas = np.where(u_meta[uvid] >= 0,
                     u_meta[uvid] + rep_idx * meta_width, -1)

    # --- edges: map every unit edge through resolve for every rep, then
    # unique (== the incremental builder's sorted(set(...)))
    EU = unit.edge_array().astype(np.int64)
    if len(EU):
        src_all = resolve[:, EU[:, 0]].ravel()
        dst_all = resolve[:, EU[:, 1]].ravel()
        n_flat = int(created.sum())
        ekeys = np.unique(src_all * n_flat + dst_all)
        edges = np.stack([ekeys // n_flat, ekeys % n_flat], axis=1)
    else:
        edges = np.zeros((0, 2), dtype=np.int64)

    last = n_rep - 1
    outputs = [int(resolve[last, ov]) for ov in unit.outputs
               if not (is_chain[ov] and inside[last, ov])]
    out = DataflowGraph.from_arrays(
        name or f"{unit.name}x{n_rep}", kinds, u_flops[uvid], u_bytes[uvid],
        meta_op=metas, roles=roles, labels=labels, out_shapes=shapes,
        edges=edges, outputs=outputs)

    unit_vid = uvid.astype(np.int64)
    rep_of = rep_idx.astype(np.int64)
    inner = getattr(unit, "replication", None)
    if inner is not None:
        out.replication = Replication(
            unit=inner.unit, n_rep=n_rep * inner.n_rep,
            unit_vid=inner.unit_vid[unit_vid],
            rep_of=rep_of * inner.n_rep + inner.rep_of[unit_vid],
            phase=inner.phase)
    else:
        # chain phase: everything reachable from a backward (step < 0)
        # chain input is phase 1 — coarsening must not merge across
        # phases or the tiled segment quotient would cycle
        phase = None
        neg = [vin for vin, (_, step) in chain_in.items() if step < 0]
        if neg:
            phase = np.zeros(unit.n, dtype=np.int64)
            stack = list(neg)
            phase[neg] = 1
            while stack:
                u = stack.pop()
                for w in unit.succs[u]:
                    if not phase[w]:
                        phase[w] = 1
                        stack.append(w)
        out.replication = Replication(unit=unit, n_rep=n_rep,
                                      unit_vid=unit_vid, rep_of=rep_of,
                                      phase=phase)
    return out
