"""Copy of ``src/repro/core/sim_batch.py`` (the port imports nothing of ``repro``).

Batched, compiled WC simulation engine — the Stage-II reward oracle hot path.

``WCSimulator.run`` is an event-driven Python loop that re-scans its ready
lists on every task start (O(starts x ready-set) per episode) and recomputes
per-task costs through ``DeviceModel`` method calls.  Stage II pays one such
episode per REINFORCE sample, and ``stage2_sim_batched`` / ``FleetTrainer``
evaluate K x S of them per update.  This module makes that batch cheap:

* :class:`CompiledGraph` precomputes, once per (graph, device-model) pair,
  everything episodes share: CSR successors, non-input predecessor counts,
  flop/byte vectors, the (n, n_dev) per-device execution-cost table, link
  latency/bandwidth matrices, and the b-level depth used by the 'dfs'
  strategy.
* :func:`compile_assignment` derives, with vectorized numpy (a
  structure-of-arrays sweep over the batch), the per-assignment task system:
  execution durations gathered from the cost table and the unique transfer
  tasks (producer, destination-device) implied by cross-device edges.
* :func:`run_plan` replays one episode over that static plan with indexed
  per-resource ready queues (heaps keyed exactly like the serial engine's
  tie-breaking) instead of list scans, so each event costs O(log) instead of
  O(ready-set).

Equivalence contract (enforced by tests/test_sim_batch.py): for every
``choose`` strategy ('fifo' | 'dfs' | 'random') and any ``noise_sigma``,
``run_plan`` reproduces ``WCSimulator.run`` **bit-for-bit** given the same
seed — the ready-queue keys replicate the serial engine's (ready-time,
exec-before-transfer, insertion-order) FIFO ties, its (depth,
insertion-order) DFS ties, and its RNG call sequence (one ``integers`` draw
per 'random' choice, one ``lognormal`` draw per noisy start, in start
order).  The serial engine stays the reference implementation; this module
is the fast path.

The noise-free case additionally dedups work: with ``noise_sigma == 0`` the
makespan is seed-independent, so a K x S batch costs K (unique-assignment)
episodes instead of K x S.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque as _deque
from typing import Sequence

import numpy as np

from .devices import DeviceModel
from .graph import DataflowGraph, validate_assignment


# ---------------------------------------------------------------------------
# Static per-(graph, devices) structure
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CompiledGraph:
    """Episode-invariant structure shared by every assignment and seed."""
    n: int
    n_dev: int
    n_compute: int                      # non-input vertices (must all execute)
    succs: list                         # python list-of-lists, graph order
    is_input: list                      # python list of bool
    ni_pred_count: np.ndarray           # (n,) non-input predecessor count
    ni_esrc: np.ndarray                 # edges with a non-input source,
    ni_edst: np.ndarray                 # in graph edge order
    flops: np.ndarray                   # (n,)
    out_bytes: np.ndarray               # (n,)
    exec_cost: np.ndarray               # (n, n_dev) seconds, matches
                                        # DeviceModel.exec_time bit-for-bit
    link_latency: np.ndarray            # (n_dev, n_dev)
    link_bw: np.ndarray                 # (n_dev, n_dev)
    depth: list                         # b-level hop count ('dfs' strategy)

    @classmethod
    def build(cls, graph: DataflowGraph, devices: DeviceModel
              ) -> "CompiledGraph":
        n, nd = graph.n, devices.n
        is_input = [graph.is_input(v) for v in range(n)]
        ni_pred = np.array(
            [sum(1 for p in graph.preds[v] if not is_input[p])
             for v in range(n)], dtype=np.int64)
        edges = graph.edge_array()
        if len(edges):
            src_ok = ~np.array([is_input[s] for s in edges[:, 0]], dtype=bool)
            ni_edges = edges[src_ok]
        else:
            ni_edges = np.zeros((0, 2), dtype=np.int32)
        flops = graph.flops_array()
        out_bytes = graph.out_bytes_array()
        # Same expression as DeviceModel.exec_time (overhead + flops / rate):
        # elementwise IEEE ops, so the table is bit-identical to the serial
        # engine's per-call results — including heterogeneous fleets with
        # per-device rates and launch overheads.
        exec_cost = devices.exec_overhead_vec[None, :] + \
            flops[:, None] / devices.flops_per_sec[None, :]
        depth = np.zeros(n)
        for v in reversed(graph.topo_order):
            for w in graph.succs[v]:
                depth[v] = max(depth[v], depth[w] + 1)
        return cls(
            n=n, n_dev=nd,
            n_compute=int(n - sum(is_input)),
            succs=[list(graph.succs[v]) for v in range(n)],
            is_input=is_input,
            ni_pred_count=ni_pred,
            ni_esrc=np.ascontiguousarray(ni_edges[:, 0], dtype=np.int64),
            ni_edst=np.ascontiguousarray(ni_edges[:, 1], dtype=np.int64),
            flops=flops, out_bytes=out_bytes,
            exec_cost=exec_cost,
            link_latency=np.asarray(devices.link_latency, dtype=np.float64),
            link_bw=np.asarray(devices.link_bw, dtype=np.float64),
            depth=depth.tolist(),
        )


# ---------------------------------------------------------------------------
# Per-assignment task system (seed-invariant)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EpisodePlan:
    """Derived task DAG for one assignment: exec task per non-input vertex,
    one transfer task per unique (producer, consumer-device) cross pair.
    All hot-loop fields are plain python lists (scalar numpy indexing is an
    order of magnitude slower inside the event loop)."""
    A: list                             # vertex -> device
    dur: list                           # (n + X,) task durations: exec v at
                                        # index v (0.0 for inputs), transfer
                                        # j at index n + j
    need0: list                         # initial exec indegree; inputs = -1
    xfer_src: list                      # (X,) producer vertex
    xfer_dst: list                      # (X,) destination device
    xfers_of: list                      # vertex -> [xfer task ids], in the
                                        # serial engine's consumer order
    succs_on: list                      # vertex -> {device: [succ vertices
                                        # assigned there], graph succ order}


def compile_assignment(cg: CompiledGraph, assignment: Sequence[int]
                       ) -> EpisodePlan:
    """Vectorized derivation of the per-assignment task system."""
    n, nd = cg.n, cg.n_dev
    A = np.asarray(assignment, dtype=np.int64)
    exec_dur = cg.exec_cost[np.arange(n), A]
    exec_dur[np.asarray(cg.is_input)] = 0.0

    sdev = A[cg.ni_esrc]
    ddev = A[cg.ni_edst]
    cross = np.flatnonzero(sdev != ddev)
    if len(cross):
        # unique (producer, dst-device) pairs; within a producer, order by
        # FIRST edge occurrence — exactly the serial engine's insertion-
        # ordered ``consumers_on`` dict.
        key = cg.ni_esrc[cross] * nd + ddev[cross]
        uk, first = np.unique(key, return_index=True)
        order = np.lexsort((first, uk // nd))
        uk, first = uk[order], first[order]
        xsrc = uk // nd
        xdst = uk % nd
        xsdev = A[xsrc]
        # same expression as DeviceModel.transfer_time (latency + bytes/bw)
        xdur = cg.link_latency[xsdev, xdst] + \
            cg.out_bytes[xsrc] / cg.link_bw[xsdev, xdst]
        xfers_of: list = [[] for _ in range(n)]
        for j, p in enumerate(xsrc.tolist()):
            xfers_of[p].append(n + j)
        xsrc, xdst, xdur = xsrc.tolist(), xdst.tolist(), xdur.tolist()
    else:
        xsrc, xdst, xdur = [], [], []
        xfers_of = [[] for _ in range(n)]

    A_list = A.tolist()
    succs_on: list = []
    for v, sv in enumerate(cg.succs):
        by_dev: dict = {}
        for w in sv:
            by_dev.setdefault(A_list[w], []).append(w)
        succs_on.append(by_dev)

    need0 = [(-1 if cg.is_input[v] else c)
             for v, c in enumerate(cg.ni_pred_count.tolist())]
    return EpisodePlan(
        A=A_list, dur=exec_dur.tolist() + xdur, need0=need0,
        xfer_src=xsrc, xfer_dst=xdst, xfers_of=xfers_of, succs_on=succs_on)


# ---------------------------------------------------------------------------
# Episode replay
# ---------------------------------------------------------------------------
def run_plan(cg: CompiledGraph, plan: EpisodePlan, *, choose: str = "fifo",
             noise_sigma: float = 0.0,
             rng: np.random.Generator | None = None) -> float:
    """One episode over a compiled plan; returns the makespan.

    Resources are devices (execs) and directed device pairs (transfers);
    each keeps an indexed ready queue.  A resource is (re)examined only when
    it frees up or gains a task, and each examination starts at most its
    extremal ready task — the same work-conserving schedule as the serial
    inner loop, without its O(ready-set) rescans.

    Queue ordering replicates the serial engine's choose_task exactly:
    fifo keys are (ready_time, insertion_seq) — non-decreasing at append
    time, so a plain deque suffices — and dfs keys are (-depth,
    insertion_seq) heaps.  Exec and transfer tasks never share a resource;
    the cross-resource candidate sort adds the serial exec-before-transfer
    tie component, so starts (and therefore noise draws) happen in the
    serial engine's exact order.
    """
    if choose == "random":
        return _run_plan_random(cg, plan, noise_sigma, rng)

    n, nd = cg.n, cg.n_dev
    A, dur_of = plan.A, plan.dur
    xfer_src, xfer_dst = plan.xfer_src, plan.xfer_dst
    xfers_of, succs_on, depth = plan.xfers_of, plan.succs_on, cg.depth
    is_fifo = choose == "fifo"
    if not is_fifo and choose != "dfs":
        raise ValueError(f"unknown choose strategy {choose!r}")
    noisy = noise_sigma > 0
    if noisy and rng is None:
        rng = np.random.default_rng()
    lognormal = rng.lognormal if noisy else None

    n_res = nd + nd * nd
    need = list(plan.need0)
    queues: list = [None] * n_res       # lazily-created deque (fifo) / heap
    res_free = [0.0] * n_res            # serial dev_free / chan_free
    marked = [-1] * n_res               # start-pass dedup marker
    heap: list = []                     # (end, tiebreak, task, resource)
    push, pop = heapq.heappush, heapq.heappop
    qpush = _deque.append if is_fifo else heapq.heappush
    new_q = _deque if is_fifo else list
    seq = 0                             # replicates serial insertion order
    tiebreak = 0
    pass_no = 0
    executed = 0
    t = 0.0

    # Seed: vertices whose non-input predecessors are all inputs.
    touched = []
    for v in range(n):
        if need[v] == 0:
            res = A[v]
            q = queues[res]
            if q is None:
                q = queues[res] = new_q()
            qpush(q, (0.0 if is_fifo else -depth[v], seq, v))
            seq += 1
            touched.append(res)

    while True:
        # ---- start pass: head of every eligible touched resource, in the
        # serial engine's global choose order
        pass_no += 1
        cands = None
        first = None
        for res in touched:
            if marked[res] == pass_no:
                continue
            marked[res] = pass_no
            q = queues[res]
            if q and res_free[res] <= t:
                k0, s0, task = q[0]
                c = (k0, res >= nd, s0, res, task)
                if first is None:
                    first = c
                elif cands is None:
                    cands = [first, c]
                else:
                    cands.append(c)
        if cands is None:
            cands = () if first is None else (first,)
        else:
            cands.sort()
        for k0, isx, s0, res, task in cands:
            q = queues[res]
            if is_fifo:
                q.popleft()
            else:
                heapq.heappop(q)
            dur = dur_of[task]
            if noisy:
                dur = dur * lognormal(0.0, noise_sigma)
            end = t + dur
            res_free[res] = end
            push(heap, (end, tiebreak, task, res))
            tiebreak += 1

        if not heap:
            break
        end, _, task, res = pop(heap)
        t = end
        touched = [res]
        # Resources whose running task also completes exactly at t are
        # already startable in the serial engine (dev_free <= t) before
        # their own completion pops — peek them so tie cases match.
        if heap and heap[0][0] == end:
            same_t = []
            while heap and heap[0][0] == end:
                same_t.append(pop(heap))
            for ev in same_t:
                push(heap, ev)
                touched.append(ev[3])
        if task < n:                                        # exec v done
            v = task
            executed += 1
            d = A[v]
            for w in succs_on[v].get(d, ()):
                nw = need[w] - 1
                need[w] = nw
                if nw == 0:
                    q = queues[d]
                    if q is None:
                        q = queues[d] = new_q()
                    qpush(q, (t if is_fifo else -depth[w], seq, w))
                    seq += 1
                    # w's resource is d == res, already in touched
            base = nd + d * nd
            for task_j in xfers_of[v]:
                chan = base + xfer_dst[task_j - n]
                q = queues[chan]
                if q is None:
                    q = queues[chan] = new_q()
                qpush(q, (t if is_fifo else -depth[v], seq, task_j))
                seq += 1
                touched.append(chan)
        else:                                               # transfer done
            j = task - n
            v, dst = xfer_src[j], xfer_dst[j]
            for w in succs_on[v].get(dst, ()):
                nw = need[w] - 1
                need[w] = nw
                if nw == 0:
                    q = queues[dst]
                    if q is None:
                        q = queues[dst] = new_q()
                    qpush(q, (t if is_fifo else -depth[w], seq, w))
                    seq += 1
                    touched.append(dst)

    if executed != cg.n_compute:
        raise RuntimeError(
            f"deadlock: {cg.n_compute - executed} vertices never executed")
    return t


def _run_plan_random(cg: CompiledGraph, plan: EpisodePlan,
                     noise_sigma: float, rng: np.random.Generator | None
                     ) -> float:
    """'random' strategy: the serial engine draws one ``integers`` over the
    full startable list per choice, so the candidate list (and the RNG call
    sequence) is reproduced exactly; the win here is the compiled costs and
    incremental readiness, not the per-choice scan."""
    if rng is None:
        rng = np.random.default_rng()
    n, nd = cg.n, cg.n_dev
    A, dur_of = plan.A, plan.dur
    xfer_src, xfer_dst = plan.xfer_src, plan.xfer_dst
    xfers_of, succs_on = plan.xfers_of, plan.succs_on
    noisy = noise_sigma > 0

    need = list(plan.need0)
    ready: dict[int, list] = {}         # resource -> [(seq, task)] in order
    res_free: dict[int, float] = {}
    heap: list = []
    push, pop = heapq.heappush, heapq.heappop
    seq = tiebreak = executed = 0
    t = 0.0

    def start_pass():
        nonlocal tiebreak
        while True:
            # serial out-order: ready execs (insertion order), then ready
            # transfers (insertion order)
            cands = [(res >= nd, s0, res, task)
                     for res, items in ready.items()
                     if res_free.get(res, 0.0) <= t for (s0, task) in items]
            if not cands:
                return
            cands.sort()
            isx, s0, res, task = cands[int(rng.integers(len(cands)))]
            ready[res].remove((s0, task))
            dur = dur_of[task]
            if noisy:
                dur = dur * rng.lognormal(0.0, noise_sigma)
            res_free[res] = t + dur
            push(heap, (t + dur, tiebreak, task, res))
            tiebreak += 1

    def enqueue(res, task):
        nonlocal seq
        ready.setdefault(res, []).append((seq, task))
        seq += 1

    for v in range(n):
        if need[v] == 0:
            enqueue(A[v], v)
    start_pass()

    while heap:
        end, _, task, res = pop(heap)
        t = end
        if task < n:
            v = task
            executed += 1
            d = A[v]
            for w in succs_on[v].get(d, ()):
                need[w] -= 1
                if need[w] == 0:
                    enqueue(d, w)
            for task_j in xfers_of[v]:
                enqueue(nd + d * nd + xfer_dst[task_j - n], task_j)
        else:
            j = task - n
            v, dst = xfer_src[j], xfer_dst[j]
            for w in succs_on[v].get(dst, ()):
                need[w] -= 1
                if need[w] == 0:
                    enqueue(dst, w)
        start_pass()

    if executed != cg.n_compute:
        raise RuntimeError(
            f"deadlock: {cg.n_compute - executed} vertices never executed")
    return t


# ---------------------------------------------------------------------------
# Batch driver
# ---------------------------------------------------------------------------
class BatchWCEngine:
    """Evaluates K assignments x S seeds against one compiled graph."""

    def __init__(self, graph: DataflowGraph, devices: DeviceModel,
                 choose: str = "fifo", noise_sigma: float = 0.0):
        self.graph, self.devices = graph, devices
        self.choose, self.noise_sigma = choose, noise_sigma
        self.compiled = CompiledGraph.build(graph, devices)
        self._plan_cache: dict[bytes, EpisodePlan] = {}

    # ------------------------------------------------------------- helpers
    def _plan_for(self, assignment: np.ndarray) -> EpisodePlan:
        key = assignment.astype(np.int64).tobytes()
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = compile_assignment(self.compiled, assignment)
            if len(self._plan_cache) >= 1024:     # bounded memoization
                self._plan_cache.clear()
            self._plan_cache[key] = plan
        return plan

    def exec_time(self, assignment: Sequence[int],
                  seed: int | None = None) -> float:
        validate_assignment(self.graph, assignment, self.compiled.n_dev)
        plan = self._plan_for(np.asarray(assignment, dtype=np.int64))
        rng = np.random.default_rng(seed) \
            if (self.noise_sigma > 0 or self.choose == "random") else None
        return run_plan(self.compiled, plan, choose=self.choose,
                        noise_sigma=self.noise_sigma, rng=rng)

    # --------------------------------------------------------------- batch
    def run_batch(self, assignments, seeds=None) -> np.ndarray:
        """(K, n) assignments x (S,) seeds -> (K, S) makespans.

        Episode (k, s) is exactly ``WCSimulator.run(assignments[k],
        seed=seeds[s]).makespan``.  Noise-free (and non-'random') batches
        collapse the seed axis and dedup repeated assignment rows.
        """
        A = np.asarray(assignments, dtype=np.int64)
        if A.ndim == 1:
            A = A[None, :]
        K = A.shape[0]
        for k in range(K):
            validate_assignment(self.graph, A[k], self.compiled.n_dev)
        seeds = [None] if seeds is None else list(seeds)
        S = len(seeds)
        seedless = self.noise_sigma <= 0 and self.choose != "random"

        uniq, inverse = np.unique(A, axis=0, return_inverse=True)
        plans = [self._plan_for(uniq[u]) for u in range(len(uniq))]
        out = np.empty((K, S))
        if seedless:
            per_uniq = np.array([
                run_plan(self.compiled, p, choose=self.choose)
                for p in plans])
            out[:] = per_uniq[inverse][:, None]
        else:
            for k in range(K):
                plan = plans[inverse[k]]
                for s, seed in enumerate(seeds):
                    out[k, s] = run_plan(
                        self.compiled, plan, choose=self.choose,
                        noise_sigma=self.noise_sigma,
                        rng=np.random.default_rng(seed))
        return out

    def run_paired(self, assignments, seeds) -> np.ndarray:
        """(K, n) assignments, (K,) seeds -> (K,) makespans (one seed per
        assignment — the Stage-II sampling pattern)."""
        A = np.asarray(assignments, dtype=np.int64)
        if A.ndim == 1:
            A = A[None, :]
        assert len(seeds) == A.shape[0], (len(seeds), A.shape)
        if self.noise_sigma <= 0 and self.choose != "random":
            return self.run_batch(A, seeds=None)[:, 0]
        for k in range(A.shape[0]):
            validate_assignment(self.graph, A[k], self.compiled.n_dev)
        return np.array([
            run_plan(self.compiled, self._plan_for(A[k]), choose=self.choose,
                     noise_sigma=self.noise_sigma,
                     rng=np.random.default_rng(seeds[k]))
            for k in range(A.shape[0])])
