"""Copy of ``src/repro/core/simulator.py`` (the port imports nothing of ``repro``).

Work-conserving (WC) execution engine — the paper's Algorithm 1 + 2.

Event-driven digital twin of the asynchronous runtime: given a device
assignment ``A`` it stochastically simulates execution and returns
``ExecTime(A)`` plus the full schedule.  Key properties kept faithful:

* **Work-conserving** — whenever a resource (device compute stream or a
  directed inter-device channel) is free and a task for it is ready, the
  scheduler starts one; it only "waits" (advances simulated time) when no
  task can start (Alg. 1's `task = null` branch).
* **EnumTasks (Alg. 2)** — ready tasks are (a) transfers `transfer(v, A_v,
  A_w)` for every edge (v, w) with the producer's result materialized on
  ``A_v`` but not yet on ``A_w``, and (b) executions `exec(v, A_v)` for
  vertices whose inputs are all resident on ``A_v``.
* **ChooseTask** — pluggable strategy ('fifo', 'dfs', 'random'); the paper
  leaves this open ("may operate depth-first, breadth-first, ...").
* **Stochastic durations** — the distribution P(<t_out, a> | S, t) is
  realized by FLOP-count / byte-count cost models (Appendix E) plus
  lognormal noise, mirroring the paper's simulator (option (a) of §2).

Inputs (entry vertices of kind 'input') are available on every device at
t=0, exactly as in Alg. 1.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Sequence

import numpy as np

from .devices import DeviceModel
from .graph import DataflowGraph, validate_assignment


@dataclasses.dataclass
class Event:
    """One schedule entry: (task, beg, end). Task is ('exec', v, d) or
    ('xfer', v, src, dst)."""
    task: tuple
    beg: float
    end: float


@dataclasses.dataclass
class SimResult:
    makespan: float
    events: list[Event]
    device_busy: np.ndarray        # (n_dev,) seconds of compute occupancy
    bytes_moved: float             # total inter-device traffic
    transfer_count: int
    transfer_class_counts: dict    # e.g. {'same_gpu':..,'same_group':..,'across':..}

    def utilization(self) -> np.ndarray:
        if self.makespan <= 0:
            return np.zeros_like(self.device_busy)
        return self.device_busy / self.makespan


class WCSimulator:
    """Event-driven WC engine over a :class:`DeviceModel`."""

    def __init__(self, graph: DataflowGraph, devices: DeviceModel,
                 choose: str = "fifo", noise_sigma: float = 0.0,
                 group_of: Sequence[int] | None = None):
        self.g = graph
        self.dev = devices
        self.choose = choose
        self.noise_sigma = noise_sigma
        # optional device->group map for App. J-style transfer accounting
        self.group_of = (np.asarray(group_of) if group_of is not None
                         else np.zeros(devices.n, dtype=int))
        # depth (b-level hop count) for the 'dfs' strategy
        depth = np.zeros(graph.n)
        for v in reversed(graph.topo_order):
            for w in graph.succs[v]:
                depth[v] = max(depth[v], depth[w] + 1)
        self._depth = depth

    # ------------------------------------------------------------------
    def run(self, assignment: Sequence[int], seed: int | None = None,
            record: bool = False) -> SimResult:
        g, dev = self.g, self.dev
        n, nd = g.n, dev.n
        validate_assignment(g, assignment, nd)
        A = np.asarray(assignment, dtype=np.int64)
        rng = np.random.default_rng(seed)

        # rdy[v, d]: result of v materialized on d.
        rdy = np.zeros((n, nd), dtype=bool)
        for v in range(n):
            if g.is_input(v):
                rdy[v, :] = True            # inputs available everywhere
        executed = np.zeros(n, dtype=bool)
        executed[g.input_mask()] = True

        # How many inputs of v are already resident on A_v.
        need = np.array([len(g.preds[v]) for v in range(n)])
        have = np.zeros(n, dtype=np.int64)
        for v in range(n):
            for p in g.preds[v]:
                if rdy[p, A[v]]:
                    have[v] += 1

        # Pending transfers keyed by (src_vertex, dst_device).
        xfer_started: set[tuple[int, int]] = set()
        exec_started = executed.copy()

        # Resource free times.
        dev_free = np.zeros(nd)
        chan_free: dict[tuple[int, int], float] = {}

        # Ready-task pools (work lists, maintained incrementally).
        ready_exec: list[tuple[float, int]] = []   # (ready_time, v)
        ready_xfer: list[tuple[float, int, int, int]] = []  # (t, v, src, dst)

        # vertex -> devices that need it, in first-edge order (an ordered
        # dict, not a set: deterministic tie-breaking that sim_batch.py can
        # replicate bit-for-bit)
        consumers_on: dict[int, dict[int, None]] = {}
        for (s, d) in g.edges:
            consumers_on.setdefault(s, {})[int(A[d])] = None

        def note_materialized(v: int, d: int, t: float):
            """Result of v became resident on device d at time t."""
            if rdy[v, d]:
                return
            rdy[v, d] = True
            for w in g.succs[v]:
                if A[w] == d:
                    have[w] += 1
                    if have[w] == need[w] and not exec_started[w]:
                        ready_exec.append((t, w))
            # new transfer opportunities out of device d
            if d == A[v]:
                for dst in consumers_on.get(v, ()):  # devices needing v
                    if dst != d and not rdy[v, dst] and (v, dst) not in xfer_started:
                        ready_xfer.append((t, v, d, dst))

        # Seed: inputs are everywhere, so only non-input vertices create work.
        for v in range(n):
            if executed[v]:
                continue
            if have[v] == need[v]:
                ready_exec.append((0.0, v))

        t = 0.0
        events: list[Event] = []
        device_busy = np.zeros(nd)
        bytes_moved = 0.0
        n_xfers = 0
        class_counts = {"same_device": 0, "same_group": 0, "across_groups": 0}
        heap: list[tuple[float, int, tuple]] = []   # (end_time, tiebreak, task)
        tiebreak = 0

        def noisy(dur: float) -> float:
            if self.noise_sigma <= 0:
                return dur
            return float(dur * rng.lognormal(0.0, self.noise_sigma))

        def startable_now():
            """Enumerate tasks whose resource is free at time t (WC check)."""
            out = []
            for (rt, v) in ready_exec:
                if not exec_started[v] and dev_free[A[v]] <= t:
                    out.append(("exec", rt, v))
            for (rt, v, s, d) in ready_xfer:
                if (v, d) not in xfer_started and not rdy[v, d] \
                        and chan_free.get((s, d), 0.0) <= t:
                    out.append(("xfer", rt, v, s, d))
            return out

        def choose_task(tasks):
            if self.choose == "random":
                return tasks[rng.integers(len(tasks))]
            if self.choose == "dfs":
                return max(tasks, key=lambda x: self._depth[x[2]])
            # fifo: earliest-ready first, execs before transfers on ties
            return min(tasks, key=lambda x: (x[1], x[0] != "exec"))

        def start(task):
            nonlocal bytes_moved, n_xfers, tiebreak
            if task[0] == "exec":
                _, rt, v = task
                d = A[v]
                dur = noisy(dev.exec_time(g.vertices[v].flops, d))
                dev_free[d] = t + dur
                device_busy[d] += dur
                exec_started[v] = True
                heapq.heappush(heap, (t + dur, tiebreak, ("exec", v, d, t)))
            else:
                _, rt, v, s, d = task
                dur = noisy(dev.transfer_time(g.vertices[v].out_bytes, s, d))
                chan_free[(s, d)] = t + dur
                xfer_started.add((v, d))
                bytes_moved += g.vertices[v].out_bytes
                n_xfers += 1
                if self.group_of[s] == self.group_of[d]:
                    class_counts["same_group"] += 1
                else:
                    class_counts["across_groups"] += 1
                heapq.heappush(heap, (t + dur, tiebreak, ("xfer", v, s, d, t)))
            tiebreak += 1

        # count intra-device "transfers" (consumer on producer's device) for
        # App. J-style accounting
        for (s, d) in g.edges:
            if A[s] == A[d] and not g.is_input(s):
                class_counts["same_device"] += 1

        # ------------------------------------------------ main event loop
        while True:
            # Work-conserving inner loop: start everything startable now.
            while True:
                tasks = startable_now()
                if not tasks:
                    break
                task = choose_task(tasks)
                start(task)
                # purge started entries lazily
                if task[0] == "exec":
                    ready_exec = [(rt, v) for (rt, v) in ready_exec
                                  if not exec_started[v]]
                else:
                    ready_xfer = [(rt, v, s, d) for (rt, v, s, d) in ready_xfer
                                  if (v, d) not in xfer_started and not rdy[v, d]]

            if not heap:
                break
            # Wait: advance to the next completion event (Alg. 1 null branch).
            end, _, info = heapq.heappop(heap)
            t = end
            if info[0] == "exec":
                _, v, d, beg = info
                executed[v] = True
                if record:
                    events.append(Event(("exec", v, d), beg, end))
                note_materialized(v, d, t)
            else:
                _, v, s, d, beg = info
                if record:
                    events.append(Event(("xfer", v, s, d), beg, end))
                note_materialized(v, d, t)

        if not executed.all():
            missing = np.flatnonzero(~executed)[:5]
            raise RuntimeError(f"deadlock: vertices never executed: {missing}")
        return SimResult(t, events, device_busy, bytes_moved, n_xfers,
                         class_counts)

    # ------------------------------------------------------------------
    def exec_time(self, assignment: Sequence[int], seed: int | None = None
                  ) -> float:
        """ExecTime(A) — the paper's reward oracle (negated by the caller)."""
        return self.run(assignment, seed=seed).makespan

    # ------------------------------------------------------- batched path
    @property
    def batch_engine(self):
        """Compiled batch engine (sim_batch.py), built lazily and reused —
        bit-equivalent to :meth:`run` per the equivalence contract enforced
        by tests/test_sim_batch.py."""
        eng = getattr(self, "_batch_engine", None)
        if eng is not None and (eng.choose != self.choose
                                or eng.noise_sigma != self.noise_sigma):
            eng = None                  # settings changed; recompile
        if eng is None:
            from .sim_batch import BatchWCEngine
            eng = self._batch_engine = BatchWCEngine(
                self.g, self.dev, choose=self.choose,
                noise_sigma=self.noise_sigma)
        return eng

    def run_batch(self, assignments, seeds=None, engine: str = "batched"
                  ) -> np.ndarray:
        """Makespans for K assignments x S seeds -> (K, S) array.

        Entry (k, s) equals ``self.run(assignments[k], seed=seeds[s])
        .makespan``; ``engine='serial'`` evaluates exactly that loop (the
        reference path used by the equivalence tests), ``'batched'``
        delegates to the compiled engine.
        """
        if engine == "batched":
            return self.batch_engine.run_batch(assignments, seeds)
        A = np.asarray(assignments)
        if A.ndim == 1:
            A = A[None, :]
        seed_list = [None] if seeds is None else list(seeds)
        return np.array([[self.run(a, seed=s).makespan for s in seed_list]
                         for a in A])

    def run_paired(self, assignments, seeds, engine: str = "batched"
                   ) -> np.ndarray:
        """Makespans for K (assignment, seed) pairs -> (K,) array — the
        Stage-II population-sampling pattern."""
        if engine == "batched":
            return self.batch_engine.run_paired(assignments, seeds)
        A = np.asarray(assignments)
        if A.ndim == 1:
            A = A[None, :]
        return np.array([self.run(a, seed=s).makespan
                         for a, s in zip(A, seeds)])


def synchronous_exec_time(graph: DataflowGraph, devices: DeviceModel,
                          assignment: Sequence[int]) -> float:
    """Bulk-synchronous (level-wise) execution model for Table 1: vertices
    execute level by level with a barrier between levels; each level's time
    is max over devices of compute, plus all cross-device transfers into the
    next level serialized per channel."""
    g = graph
    A = np.asarray(assignment)
    # level = longest hop distance from an entry
    level = np.zeros(g.n, dtype=int)
    for v in g.topo_order:
        for w in g.succs[v]:
            level[w] = max(level[w], level[v] + 1)
    total = 0.0
    for lv in range(level.max() + 1):
        verts = [v for v in range(g.n) if level[v] == lv and not g.is_input(v)]
        if not verts:
            continue
        per_dev = np.zeros(devices.n)
        for v in verts:
            per_dev[A[v]] += devices.exec_time(g.vertices[v].flops, A[v])
        chan = {}
        for v in verts:
            for w in g.succs[v]:
                if A[w] != A[v]:
                    key = (A[v], A[w])
                    chan[key] = chan.get(key, 0.0) + devices.transfer_time(
                        g.vertices[v].out_bytes, A[v], A[w])
        total += per_dev.max(initial=0.0) + (max(chan.values()) if chan else 0.0)
    return total
