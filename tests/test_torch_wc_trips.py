"""The ``wc_trips`` kernel's algorithm on the CPU, against the JAX oracle.

``csrc/wc_oracle.cu``'s ``wc_trips`` runs every trip of an episode in one
warp, in an order the vectorised trip loop never spells out.  ``_emulate``
below replays that kernel with numpy scalars, one episode at a time, lanes
in chunks of 32 as the kernel has them and integers as it holds them: the
initial candidate list deduplicated by a stamp; the start pass over
distinct candidates; the pop as per-lane lexicographic minima, then staged
``__reduce_min_sync`` minima over the keys' bit patterns; readiness as
pass 1 (indegree decrements, ``atomicMax`` of ``trip * C + position`` per
destination) and pass 2 (emission at the last triggering position once the
indegree is 0, the lanes' writes, then lane 0's queue appends in position
order and the next candidate list); each episode stopping at its own
completion or at a drained heap.

Bars: ``ms`` and ``ok`` bit-equal to ``repro.core.sim_jax.
makespan_fifo_batch`` (XLA backend) and to the port's plain trip loop
(``wc_trips_ref``), on random, CRITICAL-PATH and round-robin assignments
over seven graph x fleet pairs (one a one-device fleet, R = 2; one a
fan-out of 70, whose rows span three chunks), and on a deadlocked batch.
The kernel itself is held against the plain loop on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sim_jax
from repro.core.devices import get_device_model as jax_fleet
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.graph import DataflowGraph as JaxGraph
from repro.graphs import workloads as jax_workloads
from repro_torch.core.devices import get_device_model, uniform_box
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.heuristics import (critical_path_assignment,
                                         round_robin_assignment)
from repro_torch.core.sim_torch import (SimGraph, makespan_fifo_batch,
                                        trip_inputs)
from repro_torch.graphs import workloads
from repro_torch.kernels.wc_oracle.ops import episode_bytes, wc_trips
from repro_torch.kernels.wc_oracle.ref import wc_trips_ref

LANES = 32
F32 = np.float32
INF = F32(np.inf)

PAIRS = [("ffnn", (), "p100x4"), ("llama_block", (), "mixed_gen4"),
         ("llama_layer", (), "v100x8"), ("chainmm", (), "mixed_gen4"),
         ("synthetic_layered", (16, 8), "v100x8"),
         ("ffnn", (), "one_device"), ("fanout", (70,), "v100x8")]


def fanout(cls, width):
    """A hub feeding ``width`` consumers that all feed one join: C =
    width, so the kernel's readiness and candidate lists span several
    32-lane chunks and one queue gains entries from several chunks."""
    g = cls(f"fanout{width}")
    x = g.add_vertex("input", out_bytes=4e6)
    hub = g.add_vertex("matmul", flops=2e9, out_bytes=8e6)
    join = g.add_vertex("sum_reduction", flops=1e6, out_bytes=1e6)
    g.add_edge(x, hub)
    for i in range(width):
        v = g.add_vertex("matmul", flops=1e8 * (1 + i % 7),
                         out_bytes=1e5 * (1 + i % 3))
        g.add_edge(hub, v)
        g.add_edge(v, join)
    return g.freeze()


def _graphs(gname, args):
    if gname == "fanout":
        return fanout(DataflowGraph, *args), fanout(JaxGraph, *args)
    return (getattr(workloads, gname)(*args),
            getattr(jax_workloads, gname)(*args))


def _fleets(fleet):
    if fleet == "one_device":
        return uniform_box(1), jax_uniform_box(1)
    return get_device_model(fleet), jax_fleet(fleet)


def _staged_min(best):
    """The kernel's cross-lane pop: ``__reduce_min_sync`` over the lanes'
    (end, start trip, ready time, key) bit patterns (``__float_as_uint``),
    one key at a time over the lanes still tied, then over their rows
    -> (e1, rho)."""
    keys = np.array([b[:4] for b in best], F32).view(np.uint32)
    tied = np.ones(LANES, bool)
    for i in range(4):
        tied &= keys[:, i] == keys[tied, i].min()
    return best[int(np.argmax(tied))][0], min(
        b[4] for b, t in zip(best, tied) if t)


def _emulate_episode(sg, dur, res, req, canon, tkn, hdtl, run, need, cand):
    """One episode through the kernel's steps -> (ms, n_done)."""
    n, R, C, K = sg.n, sg.R, sg.C, sg.K
    N = dur.shape[0]
    esrc, edst, out_row = (x.numpy() for x in (sg.esrc, sg.edst,
                                               sg.out_row))
    # ---- the initial state, trash rows skipped
    tkey, trdy = tkn[:N, 0].copy(), tkn[:N, 1].copy()
    tnext = tkn[:N, 2].astype(np.int64)
    end, strip, rdy, key = (run[:, i].copy() for i in range(4))
    task, fre = run[:, 4].astype(np.int64), run[:, 5].copy()
    head, tail = hdtl[:R, 0].copy(), hdtl[:R, 1].copy()
    stamp = np.full(R, -1)
    need = need[:n].copy()
    lastpos = np.full(n, -1)
    clist = []                                 # lane 0, serially
    for r in cand:
        if 0 <= r < R and stamp[r] != 0:
            stamp[r] = 0
            clist.append(int(r))

    t = ms = F32(0)
    n_done = 0
    trip = 0
    while trip <= sg.n_trips and n_done < sg.n_compute:
        # ---- start pass: one lane per distinct candidate
        for r in clist:
            h = head[r]
            if h >= 0 and fre[r] <= t and not np.isfinite(end[r]):
                end_c = t + dur[h]                     # f32 + f32
                assert end_c.dtype == F32
                end[r], strip[r], rdy[r], key[r] = end_c, F32(trip), \
                    trdy[h], tkey[h]
                task[r], fre[r] = h, end_c
                head[r] = tnext[h]
                if tnext[h] < 0:
                    tail[r] = -1
        # ---- pop: per-lane minima over busy rows, then the staged minima
        best = [(INF, F32(0), F32(0), F32(0), R)] * LANES
        for lane in range(LANES):
            for r in range(lane, R, LANES):
                if np.isfinite(end[r]):
                    best[lane] = min(best[lane],
                                     (end[r], strip[r], rdy[r], key[r], r))
        e1, rho = _staged_min(best)
        if not np.isfinite(e1):
            break
        c = int(task[rho])
        end[rho] = INF
        t = ms = e1
        c_exec = c < n
        n_done += c_exec
        prow = out_row[c if c_exec else esrc[c - n]]
        tag0 = trip * C
        # ---- readiness pass 1: decrements and the last position
        for j in range(C):
            e = prow[j]
            if e >= 0 and req[e] == c:
                d = edst[e]
                need[d] -= 1
                lastpos[d] = max(lastpos[d], tag0 + j)
        # ---- pass 2: chunk by chunk, the lanes' reads and writes, then
        # lane 0's appends
        key0, tag = n + trip * sg.seqw, trip + 1
        nxt = []
        for j0 in range(0, C, LANES):
            ent = []                               # (live, task, key, r)
            for lane in range(LANES):
                j = j0 + lane
                e = prow[j] if j < C else -1
                live, tk, ky, r = False, 0, 0, 0
                if e >= 0:
                    if req[e] == c:
                        d = edst[e]
                        if need[d] == 0 and lastpos[d] == tag0 + j:
                            live, tk, ky = True, int(d), key0 + j
                    elif c_exec and canon[e]:
                        live, tk, ky = True, n + int(e), \
                            sg.koff + key0 + C + j
                    if live:
                        r = int(res[tk])
                ent.append((live, tk, ky, r))
            live_ent = [(tk, ky, r) for live, tk, ky, r in ent if live]
            for tk, ky, r in live_ent:
                tkey[tk], trdy[tk], tnext[tk] = F32(ky), t, -1
            for tk, ky, r in live_ent:              # in lane order
                tl = tail[r]
                if tl >= 0:
                    tnext[tl] = tk
                else:
                    head[r] = tk
                tail[r] = tk
                if stamp[r] != tag:
                    stamp[r] = tag
                    nxt.append(r)
        if stamp[rho] != tag:
            stamp[rho] = tag
            nxt.append(rho)
        clist = nxt
        trip += 1
    return ms, n_done


def _emulate(sg, A):
    """(B, n) assignments -> (ms (B,) f32, ok (B,) bool) by the kernel's
    algorithm."""
    state = [x.numpy() for x in trip_inputs(sg, A)]
    out = [_emulate_episode(sg, *(x[b] for x in state))
           for b in range(A.shape[0])]
    ms = np.array([o[0] for o in out], F32)
    return ms, np.array([o[1] for o in out]) == sg.n_compute


def _assignments(g, dev, rng):
    """4 random, 2 CRITICAL-PATH and 2 (shifted) round-robin rows."""
    rr = round_robin_assignment(g, dev.n)
    return np.stack([*rng.integers(0, dev.n, (4, g.n)),
                     critical_path_assignment(g, dev, seed=0),
                     critical_path_assignment(g, dev, seed=1),
                     rr, (rr + 1) % dev.n])


@pytest.mark.parametrize("gname,args,fleet", PAIRS)
def test_kernel_algorithm_equals_jax_and_plain(gname, args, fleet):
    g, gj = _graphs(gname, args)
    dev, devj = _fleets(fleet)
    A = _assignments(g, dev, np.random.default_rng(len(gname) + dev.n))
    sg = SimGraph.build(g, dev)
    if fleet == "one_device":
        assert sg.R == 2
    if gname == "fanout":
        assert sg.C > 2 * LANES and sg.K > 2 * LANES
    ms_e, ok_e = _emulate(sg, torch.as_tensor(A))
    ms_j, ok_j = sim_jax.makespan_fifo_batch(
        sim_jax.SimGraph.build(gj, devj), jnp.asarray(A))
    ms_p, ok_p = makespan_fifo_batch(sg, torch.as_tensor(A),
                                     backend="torch")
    assert ok_e.all()
    assert np.array_equal(ms_e, np.asarray(ms_j))
    assert np.array_equal(ok_e, np.asarray(ok_j))
    assert np.array_equal(ms_e, ms_p.numpy())
    assert np.array_equal(ok_e, ok_p.numpy())


def test_kernel_algorithm_deadlock():
    """tests/test_torch_oracle.py::test_deadlock_flag's corrupted
    indegree: the heap drains early, ok is False and ms is the last
    completion, as in both loops."""
    g = workloads.synthetic_layered(2, 2)
    gj = jax_workloads.synthetic_layered(2, 2)
    sg = SimGraph.build(g, uniform_box(2))
    sgj = sim_jax.SimGraph.build(gj, jax_uniform_box(2))
    v = int(torch.nonzero(sg.need0 > 0)[0])
    need0 = sg.need0.clone()
    need0[v] = 99                                  # v waits forever
    bad = dataclasses.replace(sg, need0=need0)
    badj = dataclasses.replace(sgj, need0=sgj.need0.at[v].set(99))
    A = np.stack([np.zeros(g.n, np.int64), np.ones(g.n, np.int64),
                  np.arange(g.n) % 2, 1 - np.arange(g.n) % 2])
    ms_e, ok_e = _emulate(bad, torch.as_tensor(A))
    ms_j, ok_j = sim_jax.makespan_fifo_batch(badj, jnp.asarray(A))
    ms_p, ok_p = makespan_fifo_batch(bad, torch.as_tensor(A),
                                     backend="torch")
    assert not ok_e.any() and not np.asarray(ok_j).any()
    assert not ok_p.any()
    assert np.array_equal(ms_e, np.asarray(ms_j))
    assert np.array_equal(ms_e, ms_p.numpy())


def test_wrapper_on_cpu_is_the_plain_loop_and_keeps_its_inputs():
    g = workloads.ffnn()
    dev = get_device_model("p100x4")
    sg = SimGraph.build(g, dev)
    A = torch.as_tensor(np.random.default_rng(3).integers(0, dev.n,
                                                          (5, g.n)))
    args = trip_inputs(sg, A)
    before = [x.clone() for x in args]
    ms_c, nd_c = wc_trips(sg, *args, backend="cuda")   # CPU tensors: plain
    ms_r, nd_r = wc_trips_ref(sg, *args)
    assert all(torch.equal(a, b) for a, b in zip(args, before))
    assert torch.equal(ms_c, ms_r) and torch.equal(nd_c, nd_r)
    assert nd_c.dtype == torch.int32 and (nd_c == sg.n_compute).all()
    with pytest.raises(ValueError):
        wc_trips(sg, *args, backend="xla")


def test_episode_bytes_covers_the_kernels_layout():
    """csrc/wc_oracle.cu's carve: 9 R + 5 N + 2 n + mm + K words, then mm
    bytes, rounded up to 16; llama_layer x v100x8 fits shared memory
    with room for several episodes per SM."""
    sg = SimGraph.build(workloads.llama_layer(), get_device_model("v100x8"))
    n, mm, R, K = sg.n, sg.esrc.shape[0], sg.R, sg.K
    nbytes = episode_bytes(n, mm, R, K)
    words = 9 * R + 5 * (n + mm) + 2 * n + mm + K
    assert nbytes % 16 == 0 and 0 <= nbytes - (4 * words + mm) < 16
    assert (R, K) == (72, 8) and nbytes < 227 * 1024 // 8
