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

* ``vmap`` is a written-out leading batch axis B; the trip ``while_loop``
  is a Python loop that tests its exit condition every
  ``CHECK_EVERY`` trips (trips past an episode's completion are no-ops,
  so the result is decision-exact), capped at ``n_trips + 1``.
* JAX drops out-of-range scatter updates and clamps out-of-range
  gathers; torch raises.  Every buffer the reference scatters out of
  range gets one trash row instead:
    - ``tkn``  (B, N + 1, 3): index N, written by ``_readiness``
      (``i_task == N`` for dead entries, ``link_idx == N`` for no link);
    - ``hdtl`` (B, R + 1, 2): index R, written by ``_start_pass``
      (``ridx == R``) and ``_readiness`` (dead ``i_res``);
    - ``need`` (B, n + 1):    index n, written by ``_readiness``
      (untriggered out-edges).
  Reads that the reference clamps are clamped explicitly.
* ``backend="cuda"`` routes the per-trip table work (start writes,
  lexicographic pop, slot clear) through the ``wc_oracle`` kernel, as
  ``_makespan_fifo_batch_pallas`` does; ``backend="torch"`` uses its
  plain version.  Both share every other op.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.wc_oracle.ops import wc_step
from .device import resolve_device
from .devices import DeviceModel
from .graph import DataflowGraph
from .nn import first_true

I32_BIG = 2**31 - 1
F_BIG = float(I32_BIG)               # f32(2**31 - 1) == 2**31
ORACLE_BACKENDS = ("torch", "cuda")
CHECK_EVERY = 16                     # trips between host checks of the exit


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
                f"(2*koff={2 * koff} >= 2^24)")
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


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-episode gather x[b, idx[b, ...]] for x (B, L, *tail)."""
    B = x.shape[0]
    bi = torch.arange(B, device=x.device).view(B, *([1] * (idx.dim() - 1)))
    return x[bi, idx]


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
    # rows n..N-1: transfers; row N: trash
    tail = torch.tensor([F_BIG, 0.0, -1.0], device=dev).expand(B, mm + 1, 3)
    tkn = torch.cat([tkn, tail], 1)                         # (B, N + 1, 3)
    hd0 = colidx.amin(1)                                    # (B, nd)
    tl0 = torch.where(seeded, vid[None, :, None], -1).amax(1)
    hdtl = torch.full((B, R + 1, 2), -1, dtype=torch.long, device=dev)
    hdtl[:, :nd, 0] = torch.where(hd0 < I32_BIG, hd0, -1)
    hdtl[:, :nd, 1] = tl0

    # run[:, r] = (end, start trip, ready time, key, task, free)
    run = torch.zeros(B, R, 6, device=dev)
    run[..., 0] = torch.inf
    run[..., 4] = -1.0

    need = torch.cat([sg.need0, sg.need0.new_zeros(1)]).expand(B, n + 1)
    need = need.clone()                                     # slot n = trash
    cand = torch.full((B, sg.K), R, dtype=torch.long, device=dev)
    cand[:, :nd] = torch.arange(nd, device=dev)
    return tkn, hdtl, run, need, cand


def _start_pass(sg: SimGraph, dur, tkn, hdtl, run, cand, t, ftrip: float):
    """Work-conserving start pass over the candidate resources: a free
    resource starts its queue head (duplicate candidates are idempotent).
    Returns ``ridx`` (``R`` drops the row) and ``rows``; applies the
    queue-head pops to ``hdtl`` in place."""
    R = sg.R
    cc = cand.clamp(max=R - 1)
    crow = _rows(run, cc)                                   # (B, K, 6)
    h = torch.where(cand < R, _rows(hdtl, cc)[..., 0], -1)  # head or -1
    # a resource whose task ends exactly at t counts as free in the serial
    # engine before its completion pops; its slot is still occupied here,
    # so that start waits one trip (same start time, same schedule)
    go = (h >= 0) & (crow[..., 5] <= t[:, None]) & ~torch.isfinite(
        crow[..., 0])
    hh = h.clamp(min=0)
    end_c = t[:, None] + _rows(dur, hh)
    ridx = torch.where(go, cc, R)
    hrow = _rows(tkn, hh)                                   # (B, K, 3)
    rows = torch.stack([end_c, torch.full_like(end_c, ftrip), hrow[..., 1],
                        hrow[..., 0], hh.float(), end_c], dim=2)
    hn = hrow[..., 2].long()
    new_hdtl = torch.stack(
        [hn, torch.where(hn < 0, -1, _rows(hdtl, cc)[..., 1])], dim=2)
    B = cand.shape[0]
    bi = torch.arange(B, device=cand.device)[:, None]
    hdtl[bi, ridx] = new_hdtl                               # R: trash row
    return ridx, rows


def _readiness(sg: SimGraph, is_canon, req, res_of, tkn, hdtl, need, t,
               trip_idx: int, c, c_is_exec, alive):
    """Readiness triggered by completion ``c``, in the completed producer's
    out-edge row (≤C entries), in the serial emission order.  Updates
    ``tkn``, ``hdtl`` and ``need`` in place; returns ``i_res`` (B, C)."""
    n, C, R = sg.n, sg.C, sg.R
    mm = sg.esrc.shape[0]
    N = n + mm
    B = c.shape[0]
    dev = c.device
    bi = torch.arange(B, device=dev)[:, None]
    cpos = torch.arange(C, device=dev)
    cx = (c - n).clamp(0, mm - 1)
    p = torch.where(c_is_exec, c, sg.esrc[cx])              # (B,)
    prow = sg.out_row[p.clamp(0, n - 1)]                    # (B, C)
    pe = prow.clamp(min=0)
    pvalid = (prow >= 0) & alive[:, None]
    ptrig = pvalid & (_rows(req, pe) == c[:, None])
    pdst = sg.edst[pe]
    need.scatter_add_(1, torch.where(ptrig, pdst, n), -ptrig.long())
    # last decrement wins the emission slot: max triggered succ position
    # per destination vertex; parallel edges collapse onto that slot
    samew = pdst[:, :, None] == pdst[:, None, :]
    maxpos = torch.where(samew & ptrig[:, None, :], cpos, -1).amax(2)
    nw = ptrig & (_rows(need, pdst) == 0) & (cpos == maxpos)
    nx = pvalid & c_is_exec[:, None] & _rows(is_canon, pe)
    i_live = nw | nx
    base = n + trip_idx * sg.seqw
    i_task = torch.where(nw, pdst, torch.where(nx, n + pe, N))
    i_key = torch.where(nw, base + maxpos, sg.koff + base + C + cpos)
    i_res = torch.where(i_live, _rows(res_of, i_task.clamp(max=N - 1)), R)
    # within-trip chaining: link each entry to the next entry bound for
    # the same resource; execs and transfers target disjoint resources
    samer = (i_res[:, :, None] == i_res[:, None, :]) & i_live[:, None, :]
    after = samer & (cpos[None, None, :] > cpos[None, :, None])
    succ_k = torch.where(after, cpos, C).amin(2)
    has_succ = succ_k < C
    succ_task = torch.gather(i_task, 1, succ_k.clamp(max=C - 1))
    is_first = ~(samer & (cpos[None, None, :] < cpos[None, :, None])
                 ).any(2) & i_live
    is_last = ~has_succ & i_live
    # one combined row scatter: (key, ready, chain-next) for the new
    # entries plus the tail-append link from each queue's old tail;
    # both sets are disjoint and deduped, dead entries go to trash row N
    rtl = _rows(hdtl, i_res.clamp(max=R - 1))[..., 1]
    link_idx = torch.where(is_first & (rtl >= 0), rtl.clamp(min=0), N)
    link_row = _rows(tkn, link_idx)
    new_rows = torch.stack([
        torch.cat([i_key.float(), link_row[..., 0]], 1),
        torch.cat([t[:, None].expand(B, C), link_row[..., 1]], 1),
        torch.cat([torch.where(has_succ, succ_task, -1).float(),
                   i_task.float()], 1)], dim=2)
    tkn[bi, torch.cat([i_task, link_idx], 1)] = new_rows
    # every live entry writes its resource's FINAL (head, tail) row, so
    # duplicate indices carry identical values; dead ones go to row R
    fst = torch.where(samer & is_first[:, None, :], i_task[:, None, :],
                      -1).amax(2)
    lst = torch.where(samer & is_last[:, None, :], i_task[:, None, :],
                      -1).amax(2)
    old_hd = _rows(hdtl, i_res.clamp(max=R - 1))[..., 0]
    hdtl[bi, torch.where(i_live, i_res, R)] = torch.stack(
        [torch.where(rtl < 0, fst, old_hd), lst], dim=2)
    return i_res


def _next_cand(sg: SimGraph, i_res, rho, alive):
    """Next trip's candidates: resources whose queue gained a task plus the
    resource freed by the pop, padded with R to K."""
    R, K, C = sg.R, sg.K, sg.C
    cand = torch.cat([i_res, torch.where(alive, rho, R)[:, None]], 1)
    if K > C + 1:
        cand = torch.cat([cand, cand.new_full((cand.shape[0], K - C - 1),
                                              R)], 1)
    return cand


def makespan_fifo_batch(sg: SimGraph, assignments: torch.Tensor,
                        backend: str = "cuda"):
    """(B, n) assignments -> ((B,) f32 makespans, (B,) bool ok flags).

    ``ok`` is False for episodes whose heap drained before every compute
    task ran (deadlock): their makespans are garbage.  ``backend`` picks
    the per-trip table step: the ``wc_oracle`` kernel ("cuda"; its plain
    version for CPU tensors) or the plain version ("torch")."""
    if backend not in ORACLE_BACKENDS:
        raise ValueError(f"unknown oracle backend {backend!r}; expected "
                         f"one of {ORACLE_BACKENDS}")
    n, R = sg.n, sg.R
    A = torch.as_tensor(assignments, device=sg.exec_cost.device)
    av, is_canon, req, edur, xdur, res_x = _derive_tasks(sg, A)
    dur = torch.cat([edur, xdur], 1)
    res_of = torch.cat([av, res_x], 1)
    tkn, hdtl, run, need, cand = _init_episode(sg, av)
    B = av.shape[0]
    t = torch.zeros(B, device=av.device)
    ms = torch.zeros(B, device=av.device)
    n_done = torch.zeros(B, dtype=torch.long, device=av.device)
    for trip in range(sg.n_trips + 1):
        if trip % CHECK_EVERY == 0 and not bool(
                (n_done < sg.n_compute).any()):
            break
        ridx, rows = _start_pass(sg, dur, tkn, hdtl, run, cand, t,
                                 float(trip))
        # the kernel's drop sentinel is -1, not R
        run, rho, e1 = wc_step(run, rows.contiguous(),
                               torch.where(ridx < R, ridx, -1).to(
                                   torch.int32), backend=backend)
        rho = rho.long()
        alive = torch.isfinite(e1)
        c = torch.where(alive, _rows(run, rho[:, None])[:, 0, 4].long(), -1)
        c_is_exec = alive & (c < n)
        t = torch.where(alive, e1, t)
        ms = torch.where(alive, e1, ms)
        n_done = n_done + c_is_exec.long()
        i_res = _readiness(sg, is_canon, req, res_of, tkn, hdtl, need, t,
                           trip, c, c_is_exec, alive)
        cand = _next_cand(sg, i_res, rho, alive)
    return ms, n_done == sg.n_compute


class TorchWCEngine:
    """Host-facing oracle (twin of ``JaxWCEngine``): noise-free 'fifo'
    makespans of assignments, scored as one batch on ``device``."""

    def __init__(self, graph: DataflowGraph, devices: DeviceModel,
                 backend: str = "cuda", device: str | torch.device = "cuda"):
        if backend not in ORACLE_BACKENDS:
            raise ValueError(f"unknown oracle backend {backend!r}; "
                             f"expected one of {ORACLE_BACKENDS}")
        self.graph, self.devices = graph, devices
        self.device = resolve_device(device)
        self.sim_graph = SimGraph.build(graph, devices, self.device)
        self.backend = backend

    def run_batch(self, assignments) -> np.ndarray:
        A = torch.as_tensor(np.asarray(assignments), dtype=torch.long)
        if A.dim() == 1:
            A = A[None, :]
        ms, ok = makespan_fifo_batch(self.sim_graph, A.to(self.device),
                                     backend=self.backend)
        if not bool(ok.all()):
            raise RuntimeError("deadlock: episode never completed")
        return ms.cpu().numpy()

    def exec_time(self, assignment) -> float:
        return float(self.run_batch(np.asarray(assignment)[None, :])[0])

    def exec_times(self, assignments, episode: int = 0) -> np.ndarray:
        """Reward-engine surface: one makespan per row.  The oracle is
        noise-free, so ``episode`` does not change the result."""
        return self.run_batch(assignments)
