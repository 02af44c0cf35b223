"""Device-resident WC reward oracle (twin of ``repro/core/sim_jax.py``).

Noise-free 'fifo' work-conserving makespans for a batch of assignments,
making the same scheduling decisions as the reference's
``makespan_fifo_batch`` (and so as ``WCSimulator.run(choose='fifo',
noise_sigma=0)``), with costs in float32.  The reference's module
docstring explains the replay: tasks in one index space (exec ``v`` at
slot ``v``, the transfer of non-input edge ``e`` at ``n + e``), one FIFO
linked list per resource (``nd`` devices then ``nd²`` directed
channels), one heap pop per trip, insertion keys as exact f32 integers.

What differs from the reference:

* ``vmap`` is a written-out leading batch axis B.  The per-batch set-up
  (``_derive_tasks``, ``_init_episode``) is PyTorch; the trip loop
  (``_run_trips``'s ``while_loop``) is the ``wc_oracle`` kernel
  ``wc_trips`` on CUDA tensors: one launch runs every trip of every
  episode on the card, each episode stopping at its own completion.
  Its plain version ``wc_trips_ref`` (``kernels/wc_oracle/ref.py``) is
  the loop in PyTorch ops, one host-driven trip at a time.
* JAX drops out-of-range scatter updates and clamps out-of-range
  gathers; torch raises, so the set-up's buffers carry one trash row
  each: ``tkn`` (B, N + 1, 3), ``hdtl`` (B, R + 1, 2), ``need`` (B, n + 1)
  (``kernels/wc_oracle/ref.py`` says which writes land there).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.wc_oracle.ops import wc_trips
from .device import resolve_device
from .devices import DeviceModel
from .engine import RewardEngine
from .graph import DataflowGraph
from .nn import first_true

I32_BIG = 2**31 - 1
F_BIG = float(I32_BIG)               # f32(2**31 - 1) == 2**31
ORACLE_BACKENDS = ("torch", "cuda")


@dataclasses.dataclass
class SimGraph:
    """Static per-(graph, fleet) tensors for the oracle."""
    is_input: torch.Tensor     # (n,) bool
    need0: torch.Tensor        # (n,) int64 non-input indegree; inputs = -1
    esrc: torch.Tensor         # (mm,) int64 producer of each non-input edge
    edst: torch.Tensor         # (mm,) int64 consumer
    edge_pos: torch.Tensor     # (mm,) int64 position in producer's out row
    edge_valid: torch.Tensor   # (mm,) bool (False on padding)
    out_row: torch.Tensor      # (n, C) int64 out-edge ids per producer, -1 pad
    exec_cost: torch.Tensor    # (n, nd) f32, 0 rows for inputs
    link_lat: torch.Tensor     # (nd, nd) f32
    link_bw: torch.Tensor      # (nd, nd) f32
    out_bytes: torch.Tensor    # (n,) f32
    n: int = 0
    nd: int = 0
    m: int = 0                 # non-input edges (before padding)
    C: int = 0                 # max non-input out-degree
    n_compute: int = 0
    n_trips: int = 0           # bound on heap pops
    seqw: int = 0              # per-trip insertion-sequence row width (2C)
    koff: int = 0              # kind offset: transfer keys sort after execs

    @property
    def R(self) -> int:
        return self.nd + self.nd * self.nd

    @property
    def K(self) -> int:
        return max(self.nd, self.C + 1)

    @classmethod
    def build(cls, graph: DataflowGraph, devices: DeviceModel,
              device: str | torch.device = "cpu") -> "SimGraph":
        """Arrays in numpy (costs in float64, cast to f32 as the reference
        does), then tensors on ``device``."""
        n, nd = graph.n, devices.n
        is_input = np.array([graph.is_input(v) for v in range(n)], bool)
        edges = graph.edge_array().reshape(-1, 2)
        ni = edges[~is_input[edges[:, 0]]] if len(edges) else edges
        m = len(ni)
        mp = max(m, 1)                            # pad so shapes stay >0
        esrc = np.zeros(mp, np.int64)
        edst = np.zeros(mp, np.int64)
        valid = np.zeros(mp, bool)
        esrc[:m], edst[:m], valid[:m] = ni[:, 0], ni[:, 1], True
        # position of each edge within its producer's out row (graph edge
        # order = the serial engine's succs / consumers_on order)
        edge_pos = np.zeros(mp, np.int64)
        rows: list[list[int]] = [[] for _ in range(n)]
        for e in range(m):
            p = int(esrc[e])
            edge_pos[e] = len(rows[p])
            rows[p].append(e)
        C = max(max((len(r) for r in rows), default=0), 1)
        out_row = np.full((n, C), -1, np.int64)
        for p, r in enumerate(rows):
            out_row[p, :len(r)] = r
        need0 = np.zeros(n, np.int64)
        np.add.at(need0, edst[:m], 1)
        need0[is_input] = -1
        # tight trip bound: one completion per exec plus at most
        # min(out-degree, n_dev - 1) canonical transfers per producer
        outdeg = np.zeros(n, np.int64)
        np.add.at(outdeg, esrc[:m], 1)
        x_max = int(np.minimum(outdeg, nd - 1).sum()) if nd > 1 else 0
        flops = graph.flops_array()
        exec_cost = (devices.exec_overhead_vec[None, :]
                     + flops[:, None] / devices.flops_per_sec[None, :])
        exec_cost[is_input] = 0.0
        n_compute = int(n - is_input.sum())
        seqw = 2 * C
        # largest insertion sequence: n (init block) + trips * seqw
        koff = n + (n_compute + m + 2) * seqw
        if 2 * koff >= 2 ** 24:
            raise ValueError(
                f"graph too large for exact f32 queue keys "
                f"(2*koff={2 * koff} >= 2^24); use the numpy engines")
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        return cls(
            is_input=t(is_input, torch.bool),
            need0=t(need0, torch.long),
            esrc=t(esrc, torch.long), edst=t(edst, torch.long),
            edge_pos=t(edge_pos, torch.long),
            edge_valid=t(valid, torch.bool),
            out_row=t(out_row, torch.long),
            exec_cost=t(exec_cost.astype(np.float32), torch.float32),
            link_lat=t(devices.link_latency.astype(np.float32),
                       torch.float32),
            link_bw=t(devices.link_bw.astype(np.float32), torch.float32),
            out_bytes=t(graph.out_bytes_array().astype(np.float32),
                        torch.float32),
            n=n, nd=nd, m=m, C=C, n_compute=n_compute,
            n_trips=n_compute + x_max, seqw=seqw, koff=koff)


def _derive_tasks(sg: SimGraph, A: torch.Tensor):
    """Per-assignment task systems for a batch A (B, n)."""
    av = A.long()
    sdev = av[:, sg.esrc]                                 # (B, mm)
    ddev = av[:, sg.edst]
    cross = sg.edge_valid[None, :] & (sdev != ddev)
    # canonical transfer slot per edge: first out-edge of the same producer
    # with the same destination device (consumers_on first-edge order)
    row = sg.out_row[sg.esrc]                             # (mm, C)
    row_dst = torch.where(row[None] >= 0,
                          av[:, sg.edst[row.clamp(min=0)]], -1)  # (B, mm, C)
    same = row_dst == ddev[:, :, None]
    first = first_true(same, dim=2)
    canon_id = torch.gather(row[None].expand(av.shape[0], -1, -1), 2,
                            first[..., None])[..., 0]
    is_canon = cross & (first == sg.edge_pos[None, :])
    # an edge's readiness requirement: producer's exec if co-located, else
    # the canonical transfer bringing the producer's result over
    req = torch.where(cross, sg.n + canon_id,
                      torch.where(sg.edge_valid, sg.esrc, -1)[None, :])
    edur = torch.gather(sg.exec_cost[None].expand(av.shape[0], -1, -1), 2,
                        av[..., None])[..., 0]
    xdur = (sg.link_lat[sdev, ddev]
            + sg.out_bytes[sg.esrc][None, :] / sg.link_bw[sdev, ddev])
    res_x = sg.nd + sdev * sg.nd + ddev                   # channel resource
    return av, is_canon, req, edur, xdur, res_x


def _init_episode(sg: SimGraph, av: torch.Tensor):
    """Initial trip-loop state (tkn, hdtl, run, need, cand), batched."""
    n, nd, R = sg.n, sg.nd, sg.R
    B = av.shape[0]
    mm = sg.esrc.shape[0]
    dev = av.device
    ready0 = (sg.need0 == 0) & ~sg.is_input                # (n,)
    fseq = torch.arange(n, dtype=torch.float32, device=dev)
    vid = torch.arange(n, device=dev)

    # initial per-device FIFO queues (vertex order): next pointer = the
    # next seeded vertex on the same device (suffix min per device column)
    oh = av[:, :, None] == torch.arange(nd, device=dev)    # (B, n, nd)
    seeded = oh & ready0[None, :, None]
    colidx = torch.where(seeded, vid[None, :, None], I32_BIG)
    sufmin = torch.cummin(colidx.flip(1), dim=1).values.flip(1)
    nxt0 = torch.cat([sufmin[:, 1:],
                      torch.full((B, 1, nd), I32_BIG, device=dev)], 1)
    nxt_v = torch.gather(nxt0, 2, av[..., None])[..., 0]  # (B, n)
    tkn = torch.stack([
        torch.where(ready0, fseq, F_BIG).expand(B, n),
        torch.zeros(B, n, device=dev),
        torch.where(ready0[None, :] & (nxt_v < I32_BIG), nxt_v.float(),
                    -1.0)], dim=2)
    # rows n..N-1: transfers; row N: trash.  Built on the device (no host
    # copy), so a CUDA graph can capture the set-up
    tail = torch.stack([torch.full((), v, device=dev)
                        for v in (F_BIG, 0.0, -1.0)]).expand(B, mm + 1, 3)
    tkn = torch.cat([tkn, tail], 1)                         # (B, N + 1, 3)
    hd0 = colidx.amin(1)                                    # (B, nd)
    tl0 = torch.where(seeded, vid[None, :, None], -1).amax(1)
    hdtl = torch.full((B, R + 1, 2), -1, dtype=torch.long, device=dev)
    hdtl[:, :nd, 0] = torch.where(hd0 < I32_BIG, hd0, -1)
    hdtl[:, :nd, 1] = tl0

    # run[:, r] = (end, start trip, ready time, key, task, free)
    run = torch.zeros(B, R, 6, device=dev)
    run[..., 0].fill_(torch.inf)
    run[..., 4].fill_(-1.0)

    need = torch.cat([sg.need0, sg.need0.new_zeros(1)]).expand(B, n + 1)
    need = need.clone()                                     # slot n = trash
    cand = torch.full((B, sg.K), R, dtype=torch.long, device=dev)
    cand[:, :nd] = torch.arange(nd, device=dev)
    return tkn, hdtl, run, need, cand


def trip_inputs(sg: SimGraph, A: torch.Tensor) -> tuple:
    """The set-up of a batch A (B, n), as ``wc_trips`` takes it: (dur,
    res_of, req, is_canon, tkn, hdtl, run, need, cand)."""
    av, is_canon, req, edur, xdur, res_x = _derive_tasks(sg, A)
    return (torch.cat([edur, xdur], 1), torch.cat([av, res_x], 1), req,
            is_canon, *_init_episode(sg, av))


def makespan_fifo_batch(sg: SimGraph, assignments: torch.Tensor,
                        backend: str = "cuda"):
    """(B, n) assignments -> ((B,) f32 makespans, (B,) bool ok flags).

    ``ok`` is False for episodes whose heap drained before every compute
    task ran (deadlock): their makespans are garbage.  ``backend`` picks
    the trip loop: the ``wc_trips`` kernel ("cuda", one launch per batch;
    its plain version for CPU tensors) or the plain version ("torch")."""
    if backend not in ORACLE_BACKENDS:
        raise ValueError(f"unknown oracle backend {backend!r}; expected "
                         f"one of {ORACLE_BACKENDS}")
    A = torch.as_tensor(assignments, device=sg.exec_cost.device)
    ms, n_done = wc_trips(sg, *trip_inputs(sg, A), backend=backend)
    return ms, n_done == sg.n_compute


class TorchWCEngine(RewardEngine):
    """Host-facing oracle (twin of ``JaxWCEngine``): noise-free 'fifo'
    makespans of assignments, scored as one batch on ``device``.  As a
    reward engine it takes the place of the reference's
    ``JaxOracleEngine``: batched, deterministic (``episode`` does not
    change a makespan, so repeats dedup to one run)."""

    batched = True
    deterministic = True

    def __init__(self, graph: DataflowGraph, devices: DeviceModel,
                 backend: str = "cuda", device: str | torch.device = "cuda"):
        if backend not in ORACLE_BACKENDS:
            raise ValueError(f"unknown oracle backend {backend!r}; "
                             f"expected one of {ORACLE_BACKENDS}")
        self.graph, self.devices = graph, devices
        self.device = resolve_device(device)
        self.sim_graph = SimGraph.build(graph, devices, self.device)
        self.backend = backend
        self.name = f"torch_oracle[{backend}]"

    def run_batch(self, assignments) -> np.ndarray:
        A = torch.as_tensor(np.asarray(assignments), dtype=torch.long)
        if A.dim() == 1:
            A = A[None, :]
        ms, ok = makespan_fifo_batch(self.sim_graph, A.to(self.device),
                                     backend=self.backend)
        if not bool(ok.all()):
            raise RuntimeError("deadlock: episode never completed")
        return ms.cpu().numpy()

    def exec_times(self, assignments, episode: int = 0) -> np.ndarray:
        return self.run_batch(assignments)
