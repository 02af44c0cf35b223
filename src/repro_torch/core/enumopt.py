"""Copy of ``src/repro/core/enumopt.py`` (the port imports nothing of ``repro``).

EnumerativeOptimizer — the paper's strong hand-designed baseline
(Appendix B, Algorithm 4).

Greedy meta-op-by-meta-op placement: for each meta-op (in topological
order) it exhaustively enumerates device permutations for the shard ops
(never co-locating two shard ops — load balance by construction), costing
each permutation by the network time to move every input to its consumer,
then does the same for the reduce ops.  Transfer times come from the
device model ("statistics gathered by testing transfers on the actual
hardware" in the paper = our DeviceModel calibration).
"""
from __future__ import annotations

import itertools

import numpy as np

from .devices import DeviceModel
from .graph import DataflowGraph


def _placement_cost(g: DataflowGraph, dev: DeviceModel, verts, devs,
                    assigned: np.ndarray) -> float:
    cost = 0.0
    for v, d in zip(verts, devs):
        for p in g.preds[v]:
            src = assigned[p]
            if src < 0:        # unplaced input: assume resident everywhere
                continue
            cost += dev.transfer_time(g.vertices[p].out_bytes, src, d)
    return cost


def _best_assign(g: DataflowGraph, dev: DeviceModel, verts,
                 assigned: np.ndarray, max_perms: int = 50000) -> None:
    """Exhaustively try device permutations for `verts` (Alg. 4's
    getBestAssign).  Permutations of |D| devices taken len(verts) at a time;
    capped for very large device counts (documented deviation — the paper
    only ran 4/8 GPUs where the full enumeration is feasible)."""
    if not verts:
        return
    k = len(verts)
    nd = dev.n
    best_cost, best = np.inf, None
    count = 0
    for perm in itertools.permutations(range(nd), min(k, nd)):
        devs = [perm[i % len(perm)] for i in range(k)]
        c = _placement_cost(g, dev, verts, devs, assigned)
        if c < best_cost:
            best_cost, best = c, devs
        count += 1
        if count >= max_perms:
            break
    for v, d in zip(verts, best):
        assigned[v] = d


def enumerative_assignment(g: DataflowGraph, dev: DeviceModel,
                           max_perms: int = 50000) -> np.ndarray:
    meta = g.meta_ops()
    if not meta:
        raise ValueError("EnumerativeOptimizer requires meta-op tags "
                         "(graph built by the sharding decomposer)")
    assigned = np.full(g.n, -1, dtype=np.int64)
    for m in meta:
        _best_assign(g, dev, m["shard_ops"], assigned, max_perms)
        _best_assign(g, dev, m["reduce_ops"], assigned, max_perms)
    # inputs and any untagged vertices: co-locate with their first consumer
    # (inputs are resident everywhere at t=0, so this is cost-neutral).
    for v in g.topo_order:
        if assigned[v] < 0:
            succ_dev = [assigned[w] for w in g.succs[v] if assigned[w] >= 0]
            pred_dev = [assigned[p] for p in g.preds[v] if assigned[p] >= 0]
            assigned[v] = (succ_dev + pred_dev + [0])[0]
    return assigned
