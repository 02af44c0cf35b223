"""Real work-conserving executor (twin of ``repro/core/executor.py``; the
port imports nothing of ``repro``): the reward source of Stage III.

The eager event loop of the paper's Appendix C: each vertex is dispatched
to its assigned device as soon as its inputs are there, inter-device
movement is an explicit copy, and the device's queues give the overlap.
The wall-clock of one execution of the graph is the observed ExecTime(A).

Each vertex's work is synthesized from its cost model, as in the
reference: a square float32 matmul sized so 2*s^3 ~= the vertex's flops,
seeded by a reduction over the real input payloads (the data dependency
is real), writing an output of the vertex's out_bytes.  The times are
those of float32 matmuls on the CUDA cores: TF32 stays off (the package
turns it off; this module states it again).

Devices and streams.  ``devices`` is a list of ``torch.device``s (default:
the card, which must be present); ``n_virtual`` maps that many logical
devices round-robin onto them.  On CUDA every logical device owns one
non-blocking stream from PyTorch's pool, so the logical devices of one
GPU overlap as far as the card allows; nothing of the loop runs on the
default stream.  Each step records an event on its stream after its
output; a consumer on another logical device makes its stream wait on
the producer's event, and only then issues the transfer.  On the CPU the
same loop runs serially, with no streams.

Transfers are real copies, into a buffer allocated on the consumer's
stream, even between two logical devices of one GPU.  This departs on
purpose from the reference on a one-device host, where ``device_put`` to
the same device is a no-op and transfers are free.  The transfer set is
the reference's: one copy per unique cross (producer, consumer-device)
pair, first-consumer order (``sim_batch.compile_assignment``'s dedup).

Measurement contract (as the reference's):

* **Plan compilation** -- per assignment, :class:`ExecPlan` is derived
  once and cached (at most 512 plans): the topo-ordered dispatch list
  with its transfer set, the pre-placed base matrix per step and the
  exit keys to wait on.  Inputs are staged on every logical device once
  per executor; bases are built once per (side, logical device); the
  payload is warmed per (side, out_len, logical device) on its stream
  (cuBLAS's per-stream workspace, the allocator's first blocks); the
  events are made.  A measured run is only the dispatch loop: from the
  first enqueue to the wait on the exit vertices' events, the twin of
  ``block_until_ready`` on the exit keys.  Nothing in the loop reads
  back to the host.
* **Buffers across streams** -- every result of a run stays referenced
  until the run's final wait, and a producer's output copied on another
  stream is marked with ``record_stream``, so the caching allocator
  never hands its memory out while a reader is in flight.
* **Batched measurement** -- :meth:`execute_batch` scores K assignments x
  R repeats with plans shared across duplicate rows (every row still
  measured on its own), one un-measured warm-up replay on the first
  batch of the executor's life, and repeats interleaved round-robin.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .device import resolve_device
from .graph import DataflowGraph, validate_assignment

torch.backends.cuda.matmul.allow_tf32 = False   # fp32 payloads (see above)

PLAN_CACHE_SIZE = 512


def _payload(seed: torch.Tensor, base: torch.Tensor, out_len: int
             ) -> torch.Tensor:
    """One vertex's work: an (s, s) matmul seeded by the inputs' scalar
    digest -> ``out_len`` float32 copies of ``r[0, 0] * 1e-9`` (the
    reference's ``_compute_fn``; three launches, no host read)."""
    m = torch.add(base, seed, alpha=1e-6)
    r = torch.mm(m, m)
    # r[0, 0] broadcast to out_len (one view op), written out by the mul
    return torch.mul(r.as_strided((out_len,), (0,)), 1e-9)


def _matmul_side(flops: float) -> int:
    return max(4, int(round((max(flops, 1.0) / 2.0) ** (1.0 / 3.0))))


def _out_len(nbytes: float) -> int:
    return max(1, int(nbytes) // 4)


@dataclasses.dataclass
class ExecPlan:
    """Compiled dispatch schedule for one assignment.

    ``steps`` holds one entry per non-input vertex in topo order:
    ``(v, d, xfers, pred_keys, out_len, base)`` where ``xfers`` are the
    ``(producer, src_device)`` transfers to issue before the step (each a
    unique cross (producer, d) pair, first-consumer order), ``pred_keys``
    the ``(pred, d)`` result keys feeding the seed reduction, and ``base``
    the step's pre-placed (s, s) matrix."""
    A: np.ndarray                  # effective (mod n_dev) assignment
    steps: list
    exit_keys: list
    n_transfers: int


class WCExecutor:
    """Executes a ``DataflowGraph`` under an assignment on real devices
    and measures its wall-clock (see the module docstring)."""

    def __init__(self, graph: DataflowGraph, devices=None,
                 flops_scale: float = 1.0, bytes_scale: float = 1.0,
                 n_virtual: int | None = None):
        self.g = graph
        physical = [resolve_device("cuda")] if devices is None else \
            [resolve_device(d) for d in devices]
        physical = [torch.device("cuda", torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None else d
                    for d in physical]
        if n_virtual is not None:
            # n_virtual logical devices round-robin onto the physical ones
            physical = [physical[i % len(physical)]
                        for i in range(n_virtual)]
        self.devices = physical
        self.nd = len(self.devices)
        self.cuda = self.devices[0].type == "cuda"
        if any((d.type == "cuda") != self.cuda for d in self.devices):
            raise ValueError("devices must be all CUDA or all CPU")
        # one stream a logical device (PyTorch's pool: non-blocking)
        self.streams = [torch.cuda.Stream(device=d) for d in self.devices] \
            if self.cuda else None
        self.flops_scale = flops_scale
        self.bytes_scale = bytes_scale
        self._bases: dict[tuple[int, int], torch.Tensor] = {}
        self._zeros: dict[int, torch.Tensor] = {}
        self._warm: set[tuple[int, int, int]] = set()
        self._events: dict[tuple[int, int], torch.cuda.Event] = {}
        self._plan_cache: dict[bytes, ExecPlan] = {}
        self._input_results: dict[tuple[int, int], torch.Tensor] | None = \
            None
        self._ran_once = False                  # any replay has happened
        self.last_dispatch_s = 0.0              # host s to the last enqueue

    # ------------------------------------------------------------ helpers
    def _on(self, d: int):
        """Context: logical device ``d``'s stream (nothing on the CPU)."""
        if self.cuda:
            return torch.cuda.stream(self.streams[d])
        return contextlib.nullcontext()

    def _base(self, s: int, d: int) -> torch.Tensor:
        key = (s, d)
        if key not in self._bases:
            with self._on(d):
                self._bases[key] = torch.full(
                    (s, s), 1.0 / s, dtype=torch.float32,
                    device=self.devices[d])
        return self._bases[key]

    def _zero(self, d: int) -> torch.Tensor:
        """The seed of a vertex without predecessors (made with the first
        warm-up on ``d``, before any run needs it)."""
        if d not in self._zeros:
            self._zeros[d] = torch.zeros((), dtype=torch.float32,
                                         device=self.devices[d])
        return self._zeros[d]

    def _vertex_dims(self, v: int) -> tuple[int, int]:
        vert = self.g.vertices[v]
        s = _matmul_side(vert.flops * self.flops_scale)
        ol = _out_len(vert.out_bytes * self.bytes_scale)
        return s, ol

    def _sync(self) -> None:
        if self.cuda:
            for dev in set(self.devices):
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------ plan pipeline
    def _inputs(self) -> dict[tuple[int, int], torch.Tensor]:
        """Input buffers staged on every logical device (Alg. 1: available
        everywhere), built once and shared by every measured run."""
        if self._input_results is None:
            res: dict[tuple[int, int], torch.Tensor] = {}
            for v in range(self.g.n):
                if self.g.is_input(v):
                    _, ol = self._vertex_dims(v)
                    for d in range(self.nd):
                        with self._on(d):
                            res[(v, d)] = torch.zeros(
                                ol, dtype=torch.float32,
                                device=self.devices[d])
            self._sync()
            self._input_results = res
        return self._input_results

    def compile_plan(self, assignment) -> ExecPlan:
        """Derive the dispatch schedule for one assignment (cached)."""
        validate_assignment(self.g, assignment, self.nd)
        A = np.asarray(assignment, dtype=np.int64) % self.nd
        key = A.tobytes()
        plan = self._plan_cache.get(key)
        if plan is not None:
            return plan

        g = self.g
        self._inputs()
        # inputs are resident everywhere from t=0
        have = {(v, d) for v in range(g.n) if g.is_input(v)
                for d in range(self.nd)}
        steps = []
        n_transfers = 0
        for v in g.topo_order:
            if g.is_input(v):
                continue
            d = int(A[v])
            xfers = []
            pred_keys = []
            for p in g.preds[v]:
                pk = (p, d)
                if pk not in have:
                    # unique cross (producer, consumer-device) pair
                    xfers.append((p, int(A[p])))
                    have.add(pk)
                    n_transfers += 1
                pred_keys.append(pk)
            s, ol = self._vertex_dims(v)
            base = self._base(s, d)
            if (s, ol, d) not in self._warm:
                # the payload's first run on this stream, off the clock
                with self._on(d):
                    _payload(self._zero(d), base, ol)
                self._warm.add((s, ol, d))
            if self.cuda and (v, d) not in self._events:
                ev = torch.cuda.Event()
                ev.record(self.streams[d])      # creates it, off the clock
                self._events[(v, d)] = ev
            steps.append((v, d, tuple(xfers), tuple(pred_keys), ol, base))
            have.add((v, d))
        self._sync()

        exit_keys = [(x, int(A[x])) if not g.is_input(x) else (x, 0)
                     for x in g.exit_nodes]
        plan = ExecPlan(A=A, steps=steps, exit_keys=exit_keys,
                        n_transfers=n_transfers)
        if len(self._plan_cache) >= PLAN_CACHE_SIZE:   # bounded memoization
            self._plan_cache.clear()
        self._plan_cache[key] = plan
        return plan

    def _run_plan(self, plan: ExecPlan, trace: dict | None = None) -> float:
        """One measured replay of a compiled plan; returns wall seconds.

        The WC event loop: walk the pre-compiled steps, each enqueued on
        its logical device's stream behind the events of its cross-device
        producers.  ``trace`` (a dict; debug replays only) receives each
        step's ``(v, d, stream id, start, end)`` with CUDA timing events
        recorded after the step's waits and after its output (before its
        event), and the run's ``results``."""
        results = dict(self._input_results)
        devices, streams, events = self.devices, self.streams, self._events
        cuda = self.cuda
        if cuda:
            saved_device = torch.cuda.current_device()
            saved = [torch.cuda.current_stream(dev)
                     for dev in set(devices)]
        steps = [] if trace is not None else None
        t0 = time.perf_counter()
        try:
            for v, d, xfers, pred_keys, out_len, base in plan.steps:
                if cuda:
                    stream = streams[d]
                    torch.cuda.set_stream(stream)
                    for p, src in xfers:
                        stream.wait_event(events[(p, src)])
                    if steps is not None:
                        start = torch.cuda.Event(enable_timing=True)
                        start.record(stream)
                for p, src in xfers:
                    # the producer's result copied onto the consumer's
                    # device, on the consumer's stream
                    x = results[(p, src)]
                    if cuda:
                        x.record_stream(stream)
                    results[(p, d)] = torch.empty_like(
                        x, device=devices[d]).copy_(x, non_blocking=True)
                if pred_keys:
                    seed = results[pred_keys[0]][0]
                    for pk in pred_keys[1:]:
                        seed = seed + results[pk][0]
                else:
                    seed = self._zeros[d]
                results[(v, d)] = _payload(seed, base, out_len)
                if cuda:
                    if steps is not None:
                        # before the step's event: a consumer released by
                        # that event starts after this timestamp
                        end = torch.cuda.Event(enable_timing=True)
                        end.record(stream)
                        steps.append((v, d, stream.stream_id, start, end))
                    events[(v, d)].record(stream)
                elif steps is not None:
                    steps.append((v, d, None, None, None))
            t_dispatch = time.perf_counter()
            if cuda:
                for key in plan.exit_keys:
                    if not self.g.is_input(key[0]):
                        events[key].synchronize()
            t1 = time.perf_counter()
        finally:
            if cuda:
                for stream in saved:
                    torch.cuda.set_stream(stream)
                torch.cuda.set_device(saved_device)
        self.last_dispatch_s = t_dispatch - t0
        self._ran_once = True
        if trace is not None:
            trace["steps"] = steps
            trace["results"] = results
        return t1 - t0

    # ------------------------------------------------------------------
    def trace_run(self, assignment) -> dict:
        """An untimed debug replay of ``assignment``: -> ``{"steps": [(v,
        d, stream id, start event, end event)], "results": {(v, d):
        tensor}}`` (events and stream ids on CUDA only), synchronized."""
        trace: dict = {}
        self._run_plan(self.compile_plan(assignment), trace)
        self._sync()
        return trace

    def execute(self, assignment, measure: bool = True) -> float:
        """Run the graph once under assignment A; returns wall seconds."""
        t = self._run_plan(self.compile_plan(assignment))
        return t if measure else 0.0

    def execute_batch(self, assignments, repeats: int = 1,
                      interleave: bool = True) -> np.ndarray:
        """(K, n) assignments x `repeats` measured runs -> (K, repeats).

        Duplicate rows share one compiled plan (the plan cache) but every
        row is still measured: wall-clock is not replayable, so K rows
        are K*repeats real runs.  The first batch of the executor's life
        runs one un-measured warm-up replay; later fresh plans need none
        (their payloads were warmed and their buffers staged at
        compile time).  Repeats are interleaved round-robin across the
        batch (repeat r of every assignment under adjacent machine
        conditions); ``interleave=False`` measures assignment-major."""
        A = np.asarray(assignments, dtype=np.int64)
        if A.ndim == 1:
            A = A[None, :]
        K = A.shape[0]
        plans = [self.compile_plan(A[k]) for k in range(K)]
        if not self._ran_once:
            self._run_plan(plans[0])            # warmup, off the record
        out = np.empty((K, repeats))
        if interleave:
            for r in range(repeats):
                for k, plan in enumerate(plans):
                    out[k, r] = self._run_plan(plan)
        else:
            for k, plan in enumerate(plans):
                for r in range(repeats):
                    out[k, r] = self._run_plan(plan)
        return out

    def exec_time(self, assignment, n_warmup: int = 1, n_runs: int = 1
                  ) -> float:
        """Median wall time of `n_runs` executions (after warmup)."""
        plan = self.compile_plan(assignment)
        for _ in range(n_warmup):
            self._run_plan(plan)
        return float(np.median([self._run_plan(plan)
                                for _ in range(n_runs)]))
