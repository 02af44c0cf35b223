"""Copy of ``src/repro/core/heuristics.py`` (the port imports nothing of ``repro``).

Non-learned assignment baselines.

CRITICAL PATH (Kwok & Ahmad 1999): list scheduling that repeatedly selects
the ready vertex with the longest remaining path to an exit (largest
t-level cost in the paper's terminology) and places it on the
earliest-finish device (ETF).  Random tie-breaking gives the "50
assignments, report best" protocol of §6.1.

The select/place halves are factored out so they double as the imitation
teacher (Stage I, Eq. 9) and as the ablation replacements of Table 3:
DOPPLER-SEL = learned SEL + `etf_place`; DOPPLER-PLC = `cp_select` +
learned PLC.
"""
from __future__ import annotations

import numpy as np

from .devices import DeviceModel
from .features import EpisodeState, compute_static_features
from .graph import DataflowGraph


def cp_select(state: EpisodeState, t_level: np.ndarray,
              rng: np.random.Generator | None = None) -> int:
    """Pick the candidate with the largest t-level (longest path to exit)."""
    cands = state.candidates()
    scores = t_level[cands]
    best = scores.max()
    ties = cands[scores >= best * (1 - 1e-12)]
    if rng is not None and len(ties) > 1:
        return int(rng.choice(ties))
    return int(ties[0])


def etf_place(state: EpisodeState, v: int,
              rng: np.random.Generator | None = None,
              respect_memory: bool = True) -> int:
    """Earliest-task-finish device for v under the ETF estimator.

    On fleets that model per-device memory (``dev.mem_bytes``), devices
    whose residency would overflow are excluded — unless every device
    would overflow, in which case plain ETF applies (the assignment is
    infeasible either way and the simulator does not model paging)."""
    g, dev = state.g, state.dev
    nd = dev.n
    finish = np.empty(nd)
    for d in range(nd):
        ready = max((state.est_end[p] +
                     dev.transfer_time(g.vertices[p].out_bytes,
                                       state.assigned[p], d)
                     for p in g.preds[v] if state.placed[p]), default=0.0)
        start = max(state.device_avail[d], ready)
        dur = dev.exec_time(g.vertices[v].flops, d) if not g.is_input(v) else 0.0
        finish[d] = start + dur
    if respect_memory and dev.mem_bytes is not None:
        over = state.dev_bytes + g.vertices[v].out_bytes > dev.mem_bytes
        if not over.all():
            finish = np.where(over, np.inf, finish)
    best = finish.min()
    ties = np.flatnonzero(finish <= best * (1 + 1e-12))
    if rng is not None and len(ties) > 1:
        return int(rng.choice(ties))
    return int(ties[0])


def critical_path_assignment(g: DataflowGraph, dev: DeviceModel,
                             seed: int | None = None,
                             return_actions: bool = False):
    """One CRITICAL PATH list-scheduling run -> assignment (and the
    (select, place) action sequence when used as the Stage-I teacher)."""
    rng = np.random.default_rng(seed)
    sf = compute_static_features(g)
    state = EpisodeState(g, dev)
    actions = []
    while not state.done:
        v = cp_select(state, sf.t_level, rng)
        d = etf_place(state, v, rng)
        actions.append((v, d))
        state.step(v, d)
    if return_actions:
        return state.assigned.copy(), np.asarray(actions, dtype=np.int32)
    return state.assigned.copy()


def best_critical_path(g: DataflowGraph, dev: DeviceModel, sim,
                       n_trials: int = 50, seed: int = 0):
    """Paper protocol: run `n_trials` randomized CP assignments, keep the
    one with the lowest simulated/real exec time."""
    best_a, best_t = None, np.inf
    for i in range(n_trials):
        a = critical_path_assignment(g, dev, seed=seed + i)
        t = sim(a)
        if t < best_t:
            best_a, best_t = a, t
    return best_a, best_t


def random_assignment(g: DataflowGraph, nd: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, nd, size=g.n)


def round_robin_assignment(g: DataflowGraph, nd: int) -> np.ndarray:
    """Topological round-robin — a cheap load-balance-only baseline."""
    a = np.zeros(g.n, dtype=np.int64)
    for i, v in enumerate(g.topo_order):
        a[v] = i % nd
    return a
