"""Copy of ``src/repro/core/hierarchy.py`` over the port's ``core/engine.py``
(the port imports nothing of ``repro``).

Hierarchical placement: coarsen -> place -> refine (core half).

``graphs/partition.py`` turns a full-model :class:`DataflowGraph` into a
segment-level graph; this module owns what happens *after* the existing
SEL/PLC dual policy places those segments:

* :class:`HierarchicalPolicy` — expansion of a segment assignment to the
  flat graph plus a bounded intra-segment refinement pass: the highest-
  traffic boundary vertices (non-input vertices whose edges cross devices
  under the current assignment) are re-placed one move at a time, every
  candidate move scored through the :class:`~.engine.RewardEngine`
  protocol in batched ``exec_times`` calls (the compiled simulator, the
  oracle on the card, ``sim_torch.TorchWCEngine``, or the real executor —
  refinement does not care which).  Refinement is monotone w.r.t. the
  scoring engine: the returned assignment never scores worse than the
  input.
* :class:`ExpandingEngine` — a ``RewardEngine`` adapter that scores
  *segment-level* assignments by expanding them and delegating to a
  flat-graph engine.  This is how hierarchical Stage II/III can train
  against flat-graph (or real-system) rewards while the policy still
  rolls out on the small segment graph.

``DopplerTrainer(..., hierarchy=HierarchyConfig(...))`` wires this in:
the trainer's policy, stages, and checkpoints run unchanged on the
segment graph, and ``trainer.place()`` produces the refined flat
assignment.

What differs from the reference: :meth:`HierarchicalPolicy
.check_state_dict` is :meth:`~HierarchicalPolicy.load_state_dict`'s
validation on its own, so ``policy_io.load_policy`` can check every part
of a checkpoint before it changes the trainer.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..graphs.partition import MultilevelPartition, Partition
from .engine import RewardEngine, as_engine
from .graph import DataflowGraph

__all__ = ["HierarchyConfig", "RefineState", "HierarchicalPolicy",
           "ExpandingEngine", "project_assignment", "refine_assignment"]


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Knobs of the coarsen -> place -> refine pipeline.

    n_segments:     target compute-segment count for ``coarsen``.
    refine_rounds:  bounded refinement rounds per :meth:`refine` call.
    refine_top_k:   boundary vertices re-placed per round.
    cap_factor:     coarsening imbalance cap (see ``coarsen``).
    max_ratio:      per-level contraction bound for the multi-level
                    V-cycle (``coarsen_multilevel``); graphs within one
                    ratio of ``n_segments`` coarsen in a single level,
                    exactly as before.
    max_levels:     hard cap on V-cycle depth.
    level_cp_max_n: intermediate V-cycle levels up to this size pool a
                    CRITICAL-PATH seed before refining (the O(n x nd)
                    python heuristic is priced out above it).
    """
    n_segments: int = 64
    refine_rounds: int = 2
    refine_top_k: int = 16
    cap_factor: float = 2.0
    max_ratio: float = 16.0
    max_levels: int = 16
    level_cp_max_n: int = 4096


@dataclasses.dataclass
class RefineState:
    """Resumable refinement bookkeeping (checkpointed by policy_io)."""
    assignment: np.ndarray | None = None    # best refined flat assignment
    exec_time: float = float("inf")         # its engine score
    rounds_done: int = 0
    moves_applied: int = 0


def boundary_scores(g: DataflowGraph, assignment: np.ndarray) -> np.ndarray:
    """(n,) cross-device traffic attributable to each vertex.

    A vertex scores the bytes of its in/out edges whose endpoints sit on
    different devices (non-input producers only — input results are
    resident everywhere in the WC engines, so moving them is free and
    pointless).  Refinement re-places the top scorers."""
    a = np.asarray(assignment)
    scores = np.zeros(g.n)
    E = g.edge_array()
    if not len(E):
        return scores
    src, dst = E[:, 0], E[:, 1]
    inputs = g.input_mask()
    w = g.out_bytes_array()[src] * (a[src] != a[dst]) * ~inputs[src]
    np.add.at(scores, src, w)
    np.add.at(scores, dst, w)
    scores[inputs] = 0.0
    return scores


def propose_moves(g: DataflowGraph, a: np.ndarray, top_k: int,
                  exec_cost: np.ndarray | None, nd: int
                  ) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """One refinement round's candidate single moves, vectorized.

    Returns ``(cands, moves)``: a ``(K, n)`` candidate-assignment matrix
    and the ``(vertex, device)`` move list, ordered exactly like the
    original per-vertex Python loops (communication moves by boundary
    rank then device id, balance moves by per-device cost then the
    least-loaded-device order), deduplicated with first occurrence kept
    — tests/test_hierarchy.py pins bit-identity against a loop
    reference.

    Communication moves: the ``top_k`` highest boundary-traffic vertices
    onto each device their graph neighbors occupy.  Balance moves: the
    heaviest vertices of the most-loaded device onto the two
    least-loaded devices (what fixes straggler fleets — boundary traffic
    alone never sees compute imbalance)."""
    a = np.asarray(a, dtype=np.int64)
    moves: list[tuple[int, int]] = []
    scores = boundary_scores(g, a)
    top = np.argsort(-scores, kind="stable")[:top_k]
    top = top[scores[top] > 0]
    E = g.edge_array()
    if len(top) and len(E):
        rank = np.full(g.n, -1, dtype=np.int64)
        rank[top] = np.arange(len(top))
        src, dst = E[:, 0].astype(np.int64), E[:, 1].astype(np.int64)
        inputs = g.input_mask()
        m_in = (rank[dst] >= 0) & ~inputs[src]    # v as consumer: pred's dev
        m_out = rank[src] >= 0                    # v as producer: succ's dev
        vv = np.concatenate([dst[m_in], src[m_out]])
        dd = np.concatenate([a[src[m_in]], a[dst[m_out]]])
        keep = dd != a[vv]
        keys = np.unique(rank[vv[keep]] * nd + dd[keep])
        moves = list(zip(top[keys // nd].tolist(), (keys % nd).tolist()))
    if exec_cost is not None:
        seen = set(moves)
        own = exec_cost[np.arange(g.n), a]
        load = np.zeros(nd)
        np.add.at(load, a, own)
        dmax = int(load.argmax())
        dmins = np.argsort(load, kind="stable")[:2]
        on_max = np.flatnonzero(a == dmax)
        on_max = on_max[np.argsort(-own[on_max],
                                   kind="stable")][:max(top_k // 2, 4)]
        on_max = on_max[own[on_max] > 0]
        bv = np.repeat(on_max, len(dmins))
        bd = np.tile(dmins, len(on_max)).astype(np.int64)
        ok = bd != a[bv]
        for v, d in zip(bv[ok].tolist(), bd[ok].tolist()):
            if (v, d) not in seen:
                seen.add((v, d))
                moves.append((v, d))
    if not moves:
        return np.zeros((0, g.n), dtype=np.int64), moves
    cands = np.repeat(a[None, :], len(moves), axis=0)
    mv = np.asarray(moves, dtype=np.int64)
    cands[np.arange(len(moves)), mv[:, 0]] = mv[:, 1]
    return cands, moves


def project_assignment(g: DataflowGraph, new_dev, assignment,
                       survivor_map) -> np.ndarray:
    """Warm-start projection of a placement onto a post-event fleet.

    Vertices on surviving devices keep their (re-indexed) device; vertices
    orphaned by a device loss are redistributed greedily — heaviest
    orphan first onto the currently least-loaded surviving device (LPT),
    load measured in exec seconds on the NEW fleet — so the projection is
    feasible and roughly balanced before any refinement runs.  Works on
    any graph level (flat or segment) as long as ``assignment`` indexes
    that graph's vertices."""
    a = np.asarray(assignment, dtype=np.int64)
    smap = np.asarray(survivor_map, dtype=np.int64)
    if a.min() < 0 or a.max() >= len(smap):
        raise ValueError(f"assignment references device "
                         f"{int(a.max())} outside the survivor map "
                         f"({len(smap)} devices)")
    out = smap[a]
    orphans = np.flatnonzero(out < 0)
    if not len(orphans):
        return out
    nd = int(new_dev.n) if hasattr(new_dev, "n") else int(new_dev)
    if hasattr(new_dev, "flops_per_sec"):
        cost = (new_dev.exec_overhead_vec[None, :]
                + g.flops_array()[:, None]
                / new_dev.flops_per_sec[None, :])
        cost[g.input_mask()] = 0.0
    else:
        cost = np.repeat(g.flops_array()[:, None], nd, axis=1)
        cost[g.input_mask()] = 0.0
    load = np.zeros(nd)
    placed = out >= 0
    np.add.at(load, out[placed], cost[np.flatnonzero(placed),
                                      out[placed]])
    order = orphans[np.argsort(-cost[orphans].mean(axis=1), kind="stable")]
    for v in order:
        d = int(np.argmin(load + cost[v]))
        out[v] = d
        load[d] += cost[v, d]
    return out


def refine_assignment(g: DataflowGraph, exec_cost, assignment, engine,
                      nd: int, episode: int = 0, rounds: int = 2,
                      top_k: int = 16, deadline: float | None = None
                      ) -> tuple[np.ndarray, float, int, int]:
    """Graph-generic bounded monotone refinement (flat graph or a V-cycle
    level): per round, communication + balance moves are proposed
    (:func:`propose_moves`) and all candidates scored in ONE batched
    ``exec_times`` call; the best single move competes against the greedy
    combination of every individually-improving move.  Monotone w.r.t.
    ``engine``: the result never scores worse than the input.

    ``deadline`` (a ``time.perf_counter()`` instant) bounds wall clock:
    no new round starts past it — the hook that makes re-placement's
    ``budget_s`` contract hold while keeping monotonicity (rounds already
    in flight complete; the loop just stops early).

    Returns ``(assignment, exec_time, rounds_done, moves_applied)``."""
    eng = as_engine(engine)
    a = np.asarray(assignment, dtype=np.int64).copy()
    t = float(eng.exec_times(a[None, :], episode)[0])
    rounds_done = moves_applied = 0
    for r in range(rounds):
        if deadline is not None and time.perf_counter() >= deadline:
            break
        cands, moves = propose_moves(g, a, top_k, exec_cost, nd)
        if not moves:
            break
        ts = np.asarray(eng.exec_times(cands, episode + 1 + r),
                        dtype=float)
        rounds_done += 1
        order = np.argsort(ts, kind="stable")
        if ts[order[0]] >= t:
            break
        # greedy combination of every individually-improving move vs
        # the best single move (one more 2-row call)
        combined = a.copy()
        moved: set[int] = set()
        for i in order.tolist():
            v, d = moves[i]
            if ts[i] < t and v not in moved:
                combined[v] = d
                moved.add(v)
        pair = np.stack([combined, cands[order[0]]])
        t2 = np.asarray(eng.exec_times(pair, episode + 101 + r),
                        dtype=float)
        if t2[0] <= t2[1] and t2[0] < t:
            a, t = combined, float(t2[0])
            moves_applied += len(moved)
        elif t2[1] < t:
            a, t = pair[1], float(t2[1])
            moves_applied += 1
        else:
            # noisy engines can re-score the "improving" move worse;
            # keep monotonicity and stop
            break
    return a, float(t), rounds_done, moves_applied


class HierarchicalPolicy:
    """Expansion + level-by-level refinement over a partition stack.

    Accepts a single :class:`Partition` (wrapped into a one-level
    :class:`MultilevelPartition`) or a multi-level stack from
    ``coarsen_multilevel``; ``refine`` operates on the flat graph exactly
    as before, and :meth:`refine_levels` walks the V-cycle down from the
    top."""

    def __init__(self, partition: Partition | MultilevelPartition,
                 config: HierarchyConfig, devices):
        if isinstance(partition, Partition):
            partition = MultilevelPartition([partition])
        self.partition = partition
        self.config = config
        self.devices = devices
        self.n_devices = int(devices.n) if hasattr(devices, "n") \
            else int(devices)
        self.refine_state = RefineState()
        self.vcycle_stats: list[dict] = []   # per-level refine bookkeeping
        self._exec_cost_cache: dict[int, np.ndarray] = {}

    @property
    def n_levels(self) -> int:
        return self.partition.n_levels

    def exec_cost_at(self, level: int) -> np.ndarray | None:
        """(n_level, nd) per-device exec seconds at a V-cycle level (0 for
        inputs), used to rank load-balance refinement moves; None when
        the policy was built with a bare device count."""
        if not hasattr(self.devices, "flops_per_sec"):
            return None
        if level not in self._exec_cost_cache:
            g = self.partition.level_graph(level)
            cost = (self.devices.exec_overhead_vec[None, :]
                    + g.flops_array()[:, None]
                    / self.devices.flops_per_sec[None, :])
            cost[g.input_mask()] = 0.0
            self._exec_cost_cache[level] = cost
        return self._exec_cost_cache[level]

    @property
    def exec_cost(self) -> np.ndarray | None:
        """Flat-graph (level 0) exec-cost table."""
        return self.exec_cost_at(0)

    def rebind_devices(self, devices) -> None:
        """Point the policy at a (derived) fleet after a fleet event: the
        partition stack is graph-only and survives unchanged, but every
        device-derived table (exec costs, device count) must follow.
        Refinement state is NOT reset here — the caller decides whether
        the old refined assignment is still meaningful on the new fleet
        (``DopplerTrainer.replace`` installs the re-placed one)."""
        self.devices = devices
        self.n_devices = int(devices.n) if hasattr(devices, "n") \
            else int(devices)
        self._exec_cost_cache.clear()

    # ------------------------------------------------------------ expand
    def expand(self, seg_assignment) -> np.ndarray:
        """Segment assignment(s) -> flat assignment(s) (batch-friendly)."""
        return self.partition.expand(seg_assignment)

    # ------------------------------------------------------------ refine
    def refine(self, assignment, engine, episode: int = 0,
               rounds: int | None = None,
               top_k: int | None = None,
               deadline: float | None = None) -> tuple[np.ndarray, float]:
        """Bounded intra-segment refinement of a flat assignment.

        Per round, two single-move families are proposed — communication
        moves (top boundary-traffic vertices onto their neighbors'
        devices) and balance moves (heaviest vertices of the most-loaded
        device onto the least-loaded ones) — and ALL candidates are
        scored in one batched ``exec_times`` call; the best single move
        is then compared against the greedy combination of every
        individually-improving move (one more 2-row call).  Monotone:
        the result never scores worse than the input under ``engine``.
        ``deadline`` (perf_counter instant) stops starting new rounds —
        the re-placement budget hook.
        """
        eng = as_engine(engine)
        cfg = self.config
        a, t, rounds_done, moves_applied = self._refine_on(
            self.partition.flat, self.exec_cost, assignment, eng, episode,
            cfg.refine_rounds if rounds is None else rounds,
            cfg.refine_top_k if top_k is None else top_k,
            deadline=deadline)
        self.refine_state = RefineState(a.copy(), float(t), rounds_done,
                                        moves_applied)
        return a, float(t)

    def _refine_on(self, g: DataflowGraph, exec_cost, assignment, eng,
                   episode: int, rounds: int, top_k: int,
                   deadline: float | None = None
                   ) -> tuple[np.ndarray, float, int, int]:
        """Graph-generic refinement body (flat graph or a V-cycle level)."""
        return refine_assignment(g, exec_cost, assignment, eng,
                                 self.n_devices, episode=episode,
                                 rounds=rounds, top_k=top_k,
                                 deadline=deadline)

    # ------------------------------------------------------------ V-cycle
    def refine_levels(self, top_assignment, episode: int = 0,
                      rounds: int | None = None,
                      top_k: int | None = None) -> np.ndarray:
        """Walk the V-cycle down: top segment assignment -> flat.

        At every intermediate level the one-level-expanded assignment is
        refined against that level's *exact* noise-free WC simulator
        (small graphs — cheap), pooling a segment-CP seed where the
        level graph is small enough, so partition quality degrades
        gracefully instead of jumping 1000x in one expand.  The flat
        (level 0) assignment is returned UNREFINED: the caller pools it
        with its own candidates and runs the final flat refinement under
        its own engine, which is what keeps ``place() <= CP`` structural
        at the bottom.  Per-level timings/scores land in
        ``self.vcycle_stats``."""
        from .heuristics import critical_path_assignment
        from .simulator import WCSimulator

        part = self.partition
        cfg = self.config
        rounds = cfg.refine_rounds if rounds is None else rounds
        top_k = cfg.refine_top_k if top_k is None else top_k
        a = np.asarray(top_assignment, dtype=np.int64)
        self.vcycle_stats = []
        has_model = hasattr(self.devices, "flops_per_sec")
        for lvl in range(part.n_levels - 1, 0, -1):
            a = part.levels[lvl].expand(a)
            if not has_model:
                continue                    # bare device count: expand only
            t0 = time.perf_counter()
            g = part.level_graph(lvl)
            eng = as_engine(WCSimulator(g, self.devices, choose="fifo",
                                        noise_sigma=0.0))
            ep = episode + 211 * lvl
            pool = [a]
            if g.n <= cfg.level_cp_max_n:
                pool += [critical_path_assignment(g, self.devices, seed=s)
                         for s in range(2)]
            ts = np.asarray(eng.exec_times(np.stack(pool), ep), dtype=float)
            t_in = float(ts.min())
            a = pool[int(ts.argmin())]
            a, t_out, rds, mvs = self._refine_on(
                g, self.exec_cost_at(lvl), a, eng, ep + 1, rounds, top_k)
            self.vcycle_stats.append(
                {"level": lvl, "n": g.n, "t_in": t_in, "t_out": t_out,
                 "rounds": rds, "moves": mvs,
                 "seconds": time.perf_counter() - t0})
        return part.levels[0].expand(a)

    # ------------------------------------------------- checkpoint plumbing
    def state_dict(self) -> dict:
        rs = self.refine_state
        return {
            "n_segments": self.config.n_segments,
            "refine_rounds": self.config.refine_rounds,
            "refine_top_k": self.config.refine_top_k,
            "vertex_segment": self.partition.vertex_segment.tolist(),
            # full level stack: levels[k] maps level-k vertices to
            # level-(k+1) segments; verified entry-by-entry on resume
            "n_levels": self.partition.n_levels,
            "level_maps": [p.vertex_segment.tolist()
                           for p in self.partition.levels],
            "refine_assignment": (rs.assignment.tolist()
                                  if rs.assignment is not None else None),
            "refine_exec_time": (float(rs.exec_time)
                                 if np.isfinite(rs.exec_time) else None),
            "rounds_done": rs.rounds_done,
            "moves_applied": rs.moves_applied,
        }

    def check_state_dict(self, state: dict) -> None:
        """Raise unless ``state`` was saved against this partition stack
        (what :meth:`load_state_dict` checks before it changes anything;
        ``policy_io.load_policy`` calls it before touching the trainer)."""
        saved = np.asarray(state["vertex_segment"], dtype=np.int64)
        if (saved.shape != self.partition.vertex_segment.shape
                or (saved != self.partition.vertex_segment).any()):
            raise ValueError(
                "hierarchical checkpoint was saved against a different "
                "partition (vertex->segment map mismatch); rebuild the "
                "trainer with the same graph and HierarchyConfig")
        saved_levels = state.get("level_maps")
        if saved_levels is None:
            # pre-V-cycle checkpoint: only valid for a one-level stack
            # (where the composite map above already pins everything)
            if self.partition.n_levels != 1:
                raise ValueError(
                    "hierarchical checkpoint has no level stack but this "
                    "trainer's partition is multi-level; rebuild with the "
                    "same graph and HierarchyConfig (partition mismatch)")
        else:
            if len(saved_levels) != self.partition.n_levels:
                raise ValueError(
                    f"hierarchical checkpoint has {len(saved_levels)} "
                    f"partition levels, this trainer has "
                    f"{self.partition.n_levels}; rebuild with the same "
                    f"graph and HierarchyConfig (partition mismatch)")
            for k, (lvl_map, part) in enumerate(
                    zip(saved_levels, self.partition.levels)):
                arr = np.asarray(lvl_map, dtype=np.int64)
                if (arr.shape != part.vertex_segment.shape
                        or (arr != part.vertex_segment).any()):
                    raise ValueError(
                        f"hierarchical checkpoint level {k} maps "
                        f"{arr.shape[0]} vertices differently; rebuild "
                        f"with the same graph and HierarchyConfig "
                        f"(partition mismatch)")

    def load_state_dict(self, state: dict) -> None:
        self.check_state_dict(state)
        a = state.get("refine_assignment")
        te = state.get("refine_exec_time")
        self.refine_state = RefineState(
            assignment=np.asarray(a, dtype=np.int64) if a is not None
            else None,
            exec_time=float(te) if te is not None else float("inf"),
            rounds_done=int(state.get("rounds_done", 0)),
            moves_applied=int(state.get("moves_applied", 0)))


class ExpandingEngine(RewardEngine):
    """Score segment-level assignments through a flat-graph engine.

    Wraps any reward source for the *flat* graph; ``exec_times`` expands
    each segment assignment row through the partition's vertex->segment
    map and delegates.  Capability flags are inherited, so the trainer
    and evaluator treat the composite exactly like the inner engine."""

    def __init__(self, policy: HierarchicalPolicy, flat_engine):
        self.policy = policy
        self.inner = as_engine(flat_engine)
        self.batched = self.inner.batched
        self.measured = self.inner.measured
        self.name = f"hier[{self.inner.name}]"

    @property
    def deterministic(self) -> bool:
        return self.inner.deterministic

    def exec_times(self, assignments, episode: int = 0) -> np.ndarray:
        A = np.asarray(assignments)
        if A.ndim == 1:
            A = A[None, :]
        return self.inner.exec_times(self.policy.expand(A), episode)

    def evaluate_repeats(self, assignment, n_runs: int,
                         seed0: int = 1000) -> np.ndarray:
        return self.inner.evaluate_repeats(
            self.policy.expand(np.asarray(assignment)), n_runs, seed0=seed0)
