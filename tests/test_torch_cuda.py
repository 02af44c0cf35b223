"""The CUDA kernels against their plain versions, on the card.

Every test here needs a GPU (marker ``cuda``) and skips without one.  The
file imports no jax, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: ``wc_step`` bit-exact on run_out and e1 (rho where alive);
``wc_trips`` bit-equal to the plain trip loop on ms and n_done, in both
placements of its state; the
``gnn_mp`` segment-sum within 1e-5 of the plain version relative to the
output's largest magnitude (both sum in fp32, in different orders);
``segment_sum_pair`` (both directions in one launch) likewise; both
bit-equal to the plain version, which adds in their order (ROADMAP C5);
the oracle's makespans with the kernel equal to the plain path's;
one Stage I episode and one Stage II update of ``DopplerTrainer`` on the
kernel backends against a twin on the plain backends (chip_smoke.py's
training gate: same actions, rewards bit for bit, losses within 1e-5 of
max(1, |loss|), gradients within 5e-6 of max(1, max|g|), params 5e-3);
the fused engine's captured updates (CUDA graph replays) against the same
function run eagerly on the kernel and on the plain backends, at that
gate with makespans bit-identical, and its raise under capture;
a checkpoint resumed into a trainer whose fused engine is already
captured (bit-identical makespans, params, moments and generator), and
the generator's device type checked when a CPU checkpoint loads on the
card; GDP's and Placeto's episodes on the ``gnn_mp`` pair against the
plain backend at the training gate, with their pair launches (2 a GNN
layer per GDP episode, 2·n a layer per Placeto episode);
the Stage III executor (one stream a logical device): every edge in
dependency order on the card's clock, every output within 1e-4 of its
closed form, two independent chains at most 0.9 of their one-stream span
on two streams, ``ExecutorRewardEngine`` batches, and buffers freed and
handed out again across streams between runs without a wrong value;
``flash_attention`` within 2e-5 (fp32) / 2e-2 (bf16, fp16), bf16 at d 64
and 128 on ``flash_fwd_wgmma`` and everything else, d up to 256, on
``flash_fwd_mma``, and ``mamba2_scan`` within 1e-4 scaled by max(|ref|, 1), the
bars of tests/test_kernels.py (``mamba2_scan`` at zamba2's N 64 and up to
xLSTM's N 1024, P 1025, per-head q and k); a reduced xLSTM (d_model 256:
N 256 a head) on the kernel path against its plain path within 1e-4;
a reduced granite-moe (top-2 of 4 experts, decode at capacity 1) on the
kernel path against its plain path within 1e-4 (fp32) / 2e-2 (bf16), its
MoE output the same bits on a second call;
the hierarchy: ``wc_trips`` bit-equal to the plain trip loop on a
refinement round's candidates (``synthetic_layered(32, 16)``, both
placements), a hierarchical ``place()`` and ``replace()`` on the kernel
backends equal to the same trainer on the plain backends, one
``wc_trips`` launch an engine call, and the fused updates after a
committed device loss bit-identical to a fresh trainer's on the new
fleet; the importer's ``model:olmo_1b`` placed on the card, its
makespans bit-equal to the CPU oracle's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.devices import FleetEvent, get_device_model, uniform_box
from repro_torch.core.engine import ExecutorRewardEngine
from repro_torch.core.executor import WCExecutor
from repro_torch.core.gdp import GDPTrainer
from repro_torch.core.placeto import PlacetoTrainer
from repro_torch.core.policy_io import load_policy, save_policy
from repro_torch.core.simulator import WCSimulator
from repro_torch.train.checkpoint import latest_step, restore_checkpoint
from repro_torch.train.optim import AdamState
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.heuristics import (critical_path_assignment,
                                         round_robin_assignment)
from repro_torch.core.hierarchy import HierarchyConfig, propose_moves
from repro_torch.core.engine import RewardEngine
from repro_torch.core.nn import tree_leaves, tree_map
from repro_torch.core.sim_torch import (SimGraph, makespan_fifo_batch,
                                        trip_inputs)
from repro_torch.core.training import DopplerTrainer
from repro_torch.graphs import workloads
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gnn_mp import ops as gnn_ops
from repro_torch.kernels.gnn_mp.ref import build_csr, segment_sum_ref
from repro_torch.kernels.wc_oracle import ops as wc_ops
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan.ref import ssd_scan_ref
from repro_torch.kernels.wc_oracle.ref import wc_step_ref, wc_trips_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("m,n,d", [(364, 252, 64), (500, 100, 32),
                                   (1000, 53, 16), (64, 200, 8),
                                   (7, 3, 200), (1, 1, 1)])
def test_gnn_mp_kernel_matches_plain(cuda, m, n, d):
    g = torch.Generator(cuda).manual_seed(m + n)
    msg = torch.randn(m, d, generator=g, device=cuda)
    dst = torch.randint(0, n, (m,), generator=g, device=cuda)
    csr = build_csr(dst, n)
    before = gnn_ops.launches
    got = gnn_ops.segment_sum(msg, dst, n, backend="cuda", csr=csr)
    torch.cuda.synchronize()
    assert gnn_ops.launches == before + 1
    ref = segment_sum_ref(msg, dst, n, csr)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) / scale <= 1e-5
    # isolated rows come out exactly zero
    empty = csr.row_ptr[1:] == csr.row_ptr[:-1]
    assert not got[empty].any()


def test_gnn_mp_kernel_grad_and_empty(cuda):
    msg = torch.randn(50, 8, device=cuda, requires_grad=True)
    dst = torch.randint(0, 10, (50,), device=cuda)
    w = torch.randn(10, 8, device=cuda)
    (gnn_ops.segment_sum(msg, dst, 10) * w).sum().backward()
    assert torch.equal(msg.grad, w[dst])
    before = gnn_ops.launches
    out = gnn_ops.segment_sum(torch.zeros(0, 8, device=cuda),
                              torch.zeros(0, dtype=torch.long, device=cuda), 5)
    assert out.shape == (5, 8) and not out.any()
    assert gnn_ops.launches == before          # m == 0: no launch


@pytest.mark.parametrize("m,n,d", [(364, 252, 64), (500, 100, 32),
                                   (1000, 53, 16), (7, 3, 200), (1, 1, 1),
                                   (300, 10, 128), (100, 40, 5),
                                   (2**20, 2**17, 64)])
def test_gnn_mp_pair_kernel_matches_plain(cuda, m, n, d):
    """Both directions in one launch, each within 1e-5 of the plain
    version; isolated rows exactly zero."""
    g = torch.Generator(cuda).manual_seed(m + d)
    msg_in, msg_out = (torch.randn(m, d, generator=g, device=cuda)
                       for _ in range(2))
    src, dst = (torch.randint(0, n, (m,), generator=g, device=cuda)
                for _ in range(2))
    csr = (build_csr(dst, n), build_csr(src, n))
    before = (gnn_ops.pair_launches, gnn_ops.launches)
    agg_in, agg_out = gnn_ops.segment_sum_pair(msg_in, dst, msg_out, src, n,
                                               csr=csr)
    torch.cuda.synchronize()
    assert (gnn_ops.pair_launches, gnn_ops.launches) == (before[0] + 1,
                                                         before[1])
    for got, msg, idx, c in ((agg_in, msg_in, dst, csr[0]),
                             (agg_out, msg_out, src, csr[1])):
        ref = segment_sum_ref(msg, idx, n, c)
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got - ref).abs().max()) / scale <= 1e-5
        assert not got[c.row_ptr[1:] == c.row_ptr[:-1]].any()


@pytest.mark.parametrize("m,n,d", [(364, 252, 64), (1000, 53, 16),
                                   (3000, 50, 8), (2**20, 2**17, 64)])
def test_gnn_mp_kernels_are_bit_equal_to_plain(cuda, m, n, d):
    """The plain sum adds in the kernels' order (edge-sorted, from zero),
    so both kernels equal it bit for bit, at any degree (ROADMAP C5: a
    Stage III gradient amplified their last-bit gap to 5.6e-5 of its
    max), and the llama_layer encoder on the kernel equals the plain
    backend's."""
    from repro_torch.core.assign import encode
    from repro_torch.graphs.workloads import get_workload
    g = torch.Generator(cuda).manual_seed(m + d + 1)
    msg_in, msg_out = (torch.randn(m, d, generator=g, device=cuda)
                       for _ in range(2))
    src, dst = (torch.randint(0, n, (m,), generator=g, device=cuda)
                for _ in range(2))
    csr = (build_csr(dst, n), build_csr(src, n))
    pair = gnn_ops.segment_sum_pair(msg_in, dst, msg_out, src, n, csr=csr)
    one = gnn_ops.segment_sum(msg_in, dst, n, backend="cuda", csr=csr[0])
    for got, msg, idx, c in ((pair[0], msg_in, dst, csr[0]),
                             (pair[1], msg_out, src, csr[1]),
                             (one, msg_in, dst, csr[0])):
        assert torch.equal(got, segment_sum_ref(msg, idx, n, c))
    tr = DopplerTrainer(get_workload("llama_layer"),
                        get_device_model("v100x8"), seed=0, device=cuda)
    kern = encode(tr.params, tr.gd, "cuda")
    plain = encode(tr.params, tr.gd, "torch")
    for a, b in zip(kern if isinstance(kern, tuple) else (kern,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(a, b)


def test_gnn_mp_pair_kernel_grad_and_empty(cuda):
    msg_in = torch.randn(50, 8, device=cuda, requires_grad=True)
    msg_out = torch.randn(50, 8, device=cuda, requires_grad=True)
    src, dst = (torch.randint(0, 10, (50,), device=cuda) for _ in range(2))
    w_in, w_out = torch.randn(10, 8, device=cuda), torch.randn(10, 8,
                                                               device=cuda)
    before = gnn_ops.pair_launches
    agg_in, agg_out = gnn_ops.segment_sum_pair(msg_in, dst, msg_out, src, 10)
    ((agg_in * w_in).sum() + (agg_out * w_out).sum()).backward()
    assert gnn_ops.pair_launches == before + 1
    assert torch.equal(msg_in.grad, w_in[dst])
    assert torch.equal(msg_out.grad, w_out[src])
    z = torch.zeros(0, 8, device=cuda)
    e = torch.zeros(0, dtype=torch.long, device=cuda)
    a, b = gnn_ops.segment_sum_pair(z, e, z, e, 5)
    assert a.shape == b.shape == (5, 8) and not a.any() and not b.any()
    assert gnn_ops.pair_launches == before + 1   # m == 0: no launch


def _rand_wc_state(rng, B, R, K, device):
    run = rng.integers(0, 50, size=(B, R, 6)).astype(np.float32)
    idle = rng.random((B, R)) < 0.4
    run[..., 0] = np.where(idle, np.inf, run[..., 0] + 1.0)
    tgt = rng.integers(0, R, size=(B, K))
    base = rng.integers(0, 50, size=(B, R, 6)).astype(np.float32)
    rows = np.take_along_axis(base, tgt[:, :, None], axis=1)
    ridx = np.where(rng.random((B, K)) < 0.3, -1, tgt).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (run, rows, ridx)]


@pytest.mark.parametrize("B,R,K", [(257, 72, 8), (3, 20, 5), (1, 1, 1),
                                   (8, 130, 140), (16, 257, 129), (2, 2, 1),
                                   (1000, 300, 40)])
def test_wc_oracle_kernel_bit_exact(cuda, B, R, K):
    rng = np.random.default_rng(B * 1000 + R + K)
    run, rows, ridx = _rand_wc_state(rng, B, R, K, cuda)
    run[0, :, 0] = torch.inf                       # one drained episode
    out_k, rho_k, e1_k = wc_ops.wc_step(run, rows, ridx, backend="cuda")
    out_r, rho_r, e1_r = wc_step_ref(run, rows, ridx)
    torch.cuda.synchronize()
    alive = torch.isfinite(e1_r)
    assert torch.equal(out_k, out_r) and torch.equal(e1_k, e1_r)
    assert torch.equal(rho_k[alive], rho_r[alive])
    assert int(rho_k.max()) <= R - 1


def test_wc_oracle_kernel_rejects_bad_inputs(cuda):
    run = torch.zeros(2, 4, 6, device=cuda)
    rows = torch.zeros(2, 3, 6, device=cuda)
    with pytest.raises(ValueError):
        wc_ops.wc_step(run, rows, torch.zeros(2, 3, dtype=torch.long,
                                              device=cuda))
    with pytest.raises(ValueError):
        wc_ops.wc_step(run, rows.cpu(), torch.zeros(2, 3, dtype=torch.int32,
                                                    device=cuda))


@pytest.mark.parametrize("gname,fleet", [("ffnn", "p100x4"),
                                         ("chainmm", "mixed_gen4")])
def test_oracle_kernel_path_equals_plain_and_cpu(cuda, gname, fleet):
    g = getattr(workloads, gname)()
    dev = get_device_model(fleet)
    A = torch.from_numpy(np.random.default_rng(0).integers(0, dev.n,
                                                           (33, g.n)))
    sg = SimGraph.build(g, dev, cuda)
    before = (wc_ops.launches, wc_ops.trip_launches)
    ms_k, ok_k = makespan_fifo_batch(sg, A.to(cuda), backend="cuda")
    assert (wc_ops.launches, wc_ops.trip_launches) == (before[0],
                                                       before[1] + 1)
    ms_t, ok_t = makespan_fifo_batch(sg, A.to(cuda), backend="torch")
    ms_c, ok_c = makespan_fifo_batch(SimGraph.build(g, dev, "cpu"), A,
                                     backend="torch")
    assert ok_k.all() and ok_t.all() and ok_c.all()
    assert torch.equal(ms_k, ms_t) and torch.equal(ms_k.cpu(), ms_c)


def _fanout(width):
    g = DataflowGraph(f"fanout{width}")
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


@pytest.mark.parametrize("gname,fleet,B", [
    ("llama_layer", "v100x8", 257), ("llama_block", "mixed_gen4", 64),
    ("ffnn", "p100x4", 1), ("chainmm", "two_pod_2x2", 33),
    ("ffnn", "one_device", 5), ("fanout", "v100x8", 16),
    ("ffnn", "tpu_v5e_16x16", 2)])
def test_wc_trips_kernel_equals_plain(cuda, gname, fleet, B):
    """Both placements where the state fits shared memory; ffnn x
    tpu_v5e_16x16 (R = 65,792) takes the global scratch by itself."""
    g = _fanout(70) if gname == "fanout" else getattr(workloads, gname)()
    fm = uniform_box(1) if fleet == "one_device" else get_device_model(fleet)
    sg = SimGraph.build(g, fm, cuda)
    A = torch.from_numpy(np.random.default_rng(B).integers(0, fm.n,
                                                            (B, g.n)))
    args = trip_inputs(sg, A.to(cuda))
    ms_r, nd_r = wc_trips_ref(sg, *args)
    nbytes = wc_ops.episode_bytes(sg.n, sg.esrc.shape[0], sg.R, sg.K)
    auto = wc_ops.placement(nbytes, cuda)
    assert (auto == "global") == (fleet == "tpu_v5e_16x16")
    for where in (auto,) if auto == "global" else ("shared", "global"):
        before = wc_ops.trip_launches
        ms_k, nd_k = wc_ops.wc_trips(sg, *args, where=where)
        torch.cuda.synchronize()
        assert wc_ops.trip_launches == before + 1
        assert torch.equal(ms_k, ms_r) and torch.equal(nd_k, nd_r)
        assert (nd_k == sg.n_compute).all()


def test_wc_trips_kernel_deadlock(cuda):
    g = workloads.synthetic_layered(2, 2)
    sg = SimGraph.build(g, uniform_box(2), cuda)
    need0 = sg.need0.clone()
    need0[int(torch.nonzero(need0 > 0)[0])] = 99
    bad = dataclasses.replace(sg, need0=need0)
    A = torch.zeros(3, g.n, dtype=torch.long, device=cuda)
    ms_k, ok_k = makespan_fifo_batch(bad, A, backend="cuda")
    ms_t, ok_t = makespan_fifo_batch(bad, A, backend="torch")
    assert not ok_k.any() and not ok_t.any() and torch.equal(ms_k, ms_t)


def test_wc_trips_kernel_rejects_bad_inputs(cuda):
    g = workloads.ffnn()
    sg = SimGraph.build(g, get_device_model("p100x4"), cuda)
    args = list(trip_inputs(sg, torch.zeros(2, g.n, dtype=torch.long,
                                           device=cuda)))
    bad = [(0, args[0].double()),                  # dur not f32
           (0, args[0][:, :-1]),                   # dur shape
           (4, args[4].cpu()),                     # tkn on the CPU
           (4, args[4].transpose(1, 2).contiguous().transpose(1, 2)),
           (1, args[1].float())]                   # float indices
    for i, t in bad:
        a = list(args)
        a[i] = t
        with pytest.raises(ValueError):
            wc_ops.wc_trips(sg, *a)
    big = SimGraph.build(g, get_device_model("tpu_v5e_16x16"), cuda)
    with pytest.raises(ValueError):
        wc_ops.wc_trips(big, *trip_inputs(big, torch.zeros(
            1, g.n, dtype=torch.long, device=cuda)), where="shared")


def test_placement_request_on_the_card(cuda):
    g = workloads.ffnn()
    tr = DopplerTrainer(g, get_device_model("p100x4"), seed=0, device=cuda)
    assert (tr.encoder_backend, tr.oracle_backend) == ("cuda", "cuda")
    g0, w0, t0 = gnn_ops.pair_launches, wc_ops.launches, wc_ops.trip_launches
    pl = tr.place(n_samples=16)
    assert gnn_ops.pair_launches - g0 == 2     # 2 layers, both directions
    assert (wc_ops.launches, wc_ops.trip_launches) == (w0, t0 + 1)
    assert pl.population.shape == (16, g.n) and np.isfinite(pl.makespans).all()
    assert pl.makespan == pl.makespans.min()


def test_zoo_graph_placed_on_the_card_equals_the_cpu_oracle(cuda):
    """``model:olmo_1b`` (the importer's layer graph) placed on the card:
    2 pair launches and 1 ``wc_trips`` launch, every candidate's makespan
    bit-equal to the CPU oracle's."""
    g = workloads.get_workload("model:olmo_1b")
    fm = get_device_model("v100x8")
    tr = DopplerTrainer(g, fm, seed=0, device=cuda)
    g0, t0 = gnn_ops.pair_launches, wc_ops.trip_launches
    pl = tr.place(n_samples=16)
    assert (gnn_ops.pair_launches - g0, wc_ops.trip_launches - t0) == (2, 1)
    cands = np.concatenate([pl.greedy[None], pl.population])
    ms, ok = makespan_fifo_batch(SimGraph.build(g, fm, "cpu"),
                                 torch.as_tensor(cands), backend="torch")
    assert ok.all() and np.array_equal(ms.numpy(), pl.makespans)


# ------------------------------------------------------------- training
def _train_twins(cuda, gname="ffnn", fleet="p100x4"):
    """A trainer on the kernel backends and its twin on the plain ones, on
    the card, with the same params and generator seed."""
    g, fm = workloads.get_workload(gname), get_device_model(fleet)
    kern = DopplerTrainer(g, fm, seed=0, device=cuda)
    plain = DopplerTrainer(g, fm, seed=0, device=cuda,
                           encoder_backend="torch", oracle_backend="torch")
    assert (kern.encoder_backend, kern.oracle_backend) == ("cuda", "cuda")
    return kern, plain


def _assert_same_update(kern, plain):
    """chip_smoke.py's training gate: the same actions (rewards bit for
    bit), losses within 1e-5 relative, each gradient leaf within
    5e-6 of max(1, max|g|), params after the step within 5e-3."""
    a, b = kern.last_update, plain.last_update
    assert np.array_equal(np.asarray(torch.as_tensor(a["actions"]).cpu()),
                          np.asarray(torch.as_tensor(b["actions"]).cpu()))
    if "rewards" in a:
        assert np.array_equal(a["rewards"], b["rewards"])
    lp = float(b["loss"])
    assert abs(float(a["loss"]) - lp) <= 1e-5 * abs(lp)
    for gk, gp in zip(tree_leaves(a["grads"]), tree_leaves(b["grads"])):
        scale = max(1.0, float(gp.abs().max()))
        assert float((gk - gp).abs().max()) <= 5e-6 * scale
    for pk, pp in zip(tree_leaves(kern.params), tree_leaves(plain.params)):
        assert float((pk - pp).abs().max()) <= 5e-3


def test_stage1_episode_kernels_match_plain(cuda):
    kern, plain = _train_twins(cuda)
    p0 = gnn_ops.pair_launches
    kern.stage1_imitation(1)
    assert gnn_ops.pair_launches - p0 == 2     # the encoder's forward
    p0 = gnn_ops.pair_launches
    plain.stage1_imitation(1)
    assert gnn_ops.pair_launches == p0
    _assert_same_update(kern, plain)
    # every leaf got a gradient through the pair's gather backward, but
    # the two output biases a softmax ignores (0 up to rounding)
    grads = kern.last_update["grads"]
    shift_free = {id(grads[h]["layers"][-1]["b"])
                  for h in ("sel_head", "plc_head2")}
    assert all(bool((x != 0).any()) for x in tree_leaves(grads)
               if id(x) not in shift_free)


def test_stage2_update_kernels_match_plain(cuda):
    kern, plain = _train_twins(cuda)
    p0, t0 = gnn_ops.pair_launches, wc_ops.trip_launches
    times = kern.train_rl(kern.default_engine(), 1, batch_size=8,
                          stage="oracle")
    assert (gnn_ops.pair_launches - p0, wc_ops.trip_launches - t0) == (4, 1)
    p0, t0 = gnn_ops.pair_launches, wc_ops.trip_launches
    assert plain.train_rl(plain.default_engine(), 1, batch_size=8,
                          stage="oracle") == times
    assert (gnn_ops.pair_launches, wc_ops.trip_launches) == (p0, t0)
    _assert_same_update(kern, plain)
    assert kern.history == plain.history and kern.episode == 8


# ------------------------------------------------ Stage III executor
def _closed_form(ex, plan) -> dict:
    """Each result of ``plan``'s run in float64: inputs 0, transfers copy,
    r[0, 0] = s (1/s + seed 1e-6)^2 with seed the predecessors' sum."""
    vals = dict.fromkeys(ex._input_results, 0.0)
    for v, d, xfers, pred_keys, _, base in plan.steps:
        for p, src in xfers:
            vals[(p, d)] = vals[(p, src)]
        seed = sum(vals[pk] for pk in pred_keys)
        s = base.shape[0]
        vals[(v, d)] = s * (1.0 / s + seed * 1e-6) ** 2 * 1e-9
    return vals


def _check_run(ex, a) -> set:
    """A debug replay of ``a``: every edge's consumer starts after its
    producer ends, every output constant and within 1e-4 relative of its
    closed form; -> the streams its steps ran on."""
    trace = ex.trace_run(a)
    at = {v: (sid, st, en) for v, _, sid, st, en in trace["steps"]}
    for p, v in ex.g.edges:
        if p in at:
            assert at[p][2].elapsed_time(at[v][1]) >= 0.0, (p, v)
    want = _closed_form(ex, ex.compile_plan(a))
    assert set(trace["results"]) == set(want)
    for k, t in trace["results"].items():
        lo, hi = float(t.min()), float(t.max())
        assert lo == hi, k
        if want[k] == 0.0:
            assert lo == 0.0, k
        else:
            assert abs(lo - want[k]) <= 1e-4 * abs(want[k]), k
    return {sid for sid, _, _ in at.values()}


@pytest.mark.parametrize("gname,fleet", [("ffnn", "p100x4"),
                                         ("llama_block", "mixed_gen4"),
                                         ("llama_layer", "v100x8")])
def test_executor_order_values_and_streams(cuda, gname, fleet):
    g, fm = workloads.get_workload(gname), get_device_model(fleet)
    ex = WCExecutor(g, n_virtual=fm.n, flops_scale=1e-3, bytes_scale=1e-2)
    own = {s.stream_id for s in ex.streams}
    assert len(own) == fm.n
    assert torch.cuda.default_stream().stream_id not in own
    for a in (critical_path_assignment(g, fm, seed=0),
              round_robin_assignment(g, fm.n)):
        streams = _check_run(ex, a)
        assert streams <= own
    assert streams == own                     # round robin: every stream
    assert torch.cuda.current_stream() == torch.cuda.default_stream()


def _chains(side, length):
    g = DataflowGraph(f"two_chains_{side}")
    x = g.add_vertex("input", out_bytes=4.0)
    for _ in range(2):
        prev = x
        for i in range(length):
            v = g.add_vertex("matmul", flops=2.0 * side ** 3, out_bytes=4.0,
                             meta_op=i)
            g.add_edge(prev, v)
            prev = v
    return g.freeze()


def _span_ms(trace) -> float:
    ref = trace["steps"][0][3]
    return (max(ref.elapsed_time(s[4]) for s in trace["steps"])
            - min(ref.elapsed_time(s[3]) for s in trace["steps"]))


def test_executor_two_streams_overlap(cuda):
    """Two chains of 8 fp32 products at side 1,024 (chip_smoke.py's
    gate): on two streams at most 0.9 of the device span on one (median
    of 5 replays each), each stream first held 10 ms by a sleep kernel so
    that the host's dispatch does not set the span."""
    L = 8
    ex = WCExecutor(_chains(1024, L), n_virtual=2)
    two = np.array([0] + [0] * L + [1] * L)
    one = np.zeros(1 + 2 * L, np.int64)
    cycles = int(torch.cuda.get_device_properties(0).clock_rate * 10.0)
    spans = {"one": [], "two": []}
    for _ in range(5):
        for name, a, n in (("one", one, 1), ("two", two, 2)):
            ex.compile_plan(a)
            for s in ex.streams[:n]:
                with torch.cuda.stream(s):
                    torch.cuda._sleep(cycles)
            spans[name].append(_span_ms(ex.trace_run(a)))
    ratio = np.median(spans["two"]) / np.median(spans["one"])
    assert ratio <= 0.9, spans


def test_executor_reward_engine_on_the_card(cuda):
    g, fm = workloads.get_workload("ffnn"), get_device_model("p100x4")
    ex = WCExecutor(g, n_virtual=fm.n, flops_scale=1e-2, bytes_scale=1e-1)
    eng = ExecutorRewardEngine(ex, repeats=3)
    rng = np.random.default_rng(0)
    A = rng.integers(0, fm.n, size=(5, g.n))
    A[3] = A[0]
    ts = eng.exec_times(A)
    assert ts.shape == (5,) and np.isfinite(ts).all() and (ts > 0).all()
    assert len(ex._plan_cache) == 4           # rows 0 and 3 share a plan
    reps = eng.evaluate_repeats(A[1], 4)
    assert reps.shape == (4,) and (reps > 0).all()
    assert 0 < ex.last_dispatch_s <= reps[-1]


def test_executor_buffers_reused_across_streams(cuda):
    """Runs of random assignments on a random DAG, with every stream's
    freed blocks handed out again (filled with NaN) between runs: every
    run's outputs stay right (a dropped result or a missing
    ``record_stream`` lets a copy read a reused block)."""
    rng = np.random.default_rng(3)
    g = DataflowGraph("random_dag")
    for _ in range(2):
        g.add_vertex("input", out_bytes=float(rng.integers(1, 1 << 20)))
    for v in range(2, 60):
        side = int(rng.integers(16, 768))
        g.add_vertex("matmul", flops=2.0 * side ** 3,
                     out_bytes=float(rng.integers(4, 4 << 20)), meta_op=v)
        for p in sorted(set(rng.integers(0, v, size=3).tolist())):
            g.add_edge(p, v)
    g = g.freeze()
    ex = WCExecutor(g, n_virtual=4)
    A = rng.integers(0, 4, size=(6, g.n))

    def churn():
        for s in ex.streams:
            with torch.cuda.stream(s):
                junk = [torch.full((int(n),), float("nan"), device=cuda)
                        for n in rng.integers(1, 1 << 20, size=8)]
            del junk
    for a in A:
        _check_run(ex, a)
        churn()
        ex.execute_batch(A, repeats=2)
        churn()
    _check_run(ex, A[0])


# ----------------------------------------------- fused training (graphs)
def _tables(seed, n, K, nd):
    """One update's step-major draw tables, from numpy."""
    rng = np.random.default_rng(seed)
    u = [rng.random(s, dtype=np.float32).clip(1e-7, 1 - 1e-7)
         for s in ((n, K, n), (n, K, nd), (n, K), (n, K))]
    return [(-np.log(-np.log(x))).astype(np.float32) for x in u[:2]] + u[2:]


def _fused_engine(tr, stage):
    (eng,) = [e for k, e in tr._fused_cache.items() if k[0] == stage]
    return eng


def test_fused_stage2_captured_matches_eager_and_plain(cuda):
    """Two captured dispatches (3 updates, then a tail of 1) against the
    same function run eagerly on the kernel backends and on the plain
    ones, from one state on the same draws: makespans bit-identical, the
    last update at chip_smoke.py's training gate; the capture recorded 4
    gnn_mp pair launches and 1 wc_trips launch, and replays them."""
    kern, plain = _train_twins(cuda)
    eager, _ = _train_twins(cuda)
    draws = [_tables(i, kern.g.n, 8, kern.dev.n) for i in range(4)]
    runs = [tr.stage2_fused(4, batch_size=8, updates_per_dispatch=3,
                            draws=draws, capture=cap)
            for tr, cap in ((kern, None), (eager, False), (plain, False))]
    assert runs[0] == runs[1] == runs[2]
    eng = _fused_engine(kern, "stage2")
    assert eng.graphed.graph is not None and eng.graphed.replays == 4
    assert eng.graphed.captured == {"gnn_mp_pair": 4, "wc_oracle_trips": 1}
    assert set(kern.seconds) == {"warmup", "capture", "updates"}
    assert _fused_engine(eager, "stage2").graphed.graph is None
    for other in (eager, plain):
        _assert_same_update(kern, other)
        assert kern.history == other.history
        assert (kern._r_sum, kern._r_count) == (other._r_sum,
                                                other._r_count)
    # a later call replays the same graph, on fresh generator draws
    p0 = gnn_ops.pair_launches
    kern.stage2_fused(2, batch_size=8, updates_per_dispatch=3)
    assert gnn_ops.pair_launches == p0 and eng.graphed.replays == 6


def test_fused_stage1_captured_matches_eager(cuda):
    kern, plain = _train_twins(cuda)
    got = kern.stage1_imitation_fused(4, seed=2, batch_size=2)
    assert plain.stage1_imitation_fused(4, seed=2, batch_size=2,
                                        capture=False) == pytest.approx(
        got, rel=1e-5)
    assert _fused_engine(kern, "stage1").graphed.captured == {
        "gnn_mp_pair": 2, "wc_oracle_trips": 0}
    _assert_same_update(kern, plain)


def test_fused_stage2_raises_under_capture(cuda):
    """A SimGraph doctored to n_trips=1: the captured dispatch flags every
    episode and raises; the trainer keeps its state."""
    kern, _ = _train_twins(cuda)
    kern._fused_cache["sim_graph"] = dataclasses.replace(
        SimGraph.build(kern.g, kern.dev, cuda), n_trips=1)
    params = kern.params
    with pytest.raises(RuntimeError, match="converge"):
        kern.stage2_fused(2, batch_size=4, updates_per_dispatch=2)
    assert _fused_engine(kern, "stage2").graphed.graph is not None
    assert kern.params is params and kern.episode == 0


def test_fused_capture_needs_the_kernel_oracle(cuda):
    _, plain = _train_twins(cuda)
    with pytest.raises(ValueError, match="oracle_backend"):
        plain.stage2_fused(1, batch_size=4)


# ------------------------------------------------- flash_attention (B3)
def _qkv(cuda, B, S, Hq, Hkv, d, dtype, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    return [torch.randn(B, S, h, d, generator=g, device=cuda).to(dtype)
            for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("B,S,Hq,Hkv,d", [
    (2, 256, 4, 2, 64), (1, 128, 2, 1, 128), (2, 512, 8, 8, 32),
    (1, 384, 6, 3, 64), (2, 100, 4, 4, 16), (1, 1, 2, 1, 64),
    (3, 193, 6, 2, 96), (1, 65, 1, 1, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, B, S, Hq, Hkv, d, dtype,
                                              causal):
    """Bars of tests/test_kernels.py: 2e-5 in fp32, 2e-2 in bf16 (the
    kernel and the plain version both compute in fp32 and round once)."""
    q, k, v = _qkv(cuda, B, S, Hq, Hkv, d, dtype, B * S + Hq)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, backend="cuda")
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    ref = attention_ref(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,d,causal", [
    (4, 2048, 32, 32, 64, True),                  # the serving shape
    (1, 2048, 16, 16, 128, True), (2, 333, 8, 2, 64, True),
    (2, 333, 8, 2, 128, True), (1, 1, 4, 2, 64, True),
    (1, 1, 2, 1, 128, False), (3, 193, 6, 2, 128, False),
    (2, 777, 8, 4, 64, False), (1, 640, 16, 4, 128, True),
    (2, 129, 4, 1, 64, True)])
def test_flash_attention_wgmma_kernel_matches_plain(cuda, B, S, Hq, Hkv, d,
                                                    causal):
    """bf16 at d 64 and 128 runs flash_fwd_wgmma (the per-kernel counter
    moves, flash_fwd_mma's does not); 2e-2 against the plain version."""
    q, k, v = _qkv(cuda, B, S, Hq, Hkv, d, torch.bfloat16, 7 * S + d)
    before = dict(fa_ops.kernel_launches)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.kernel_launches == {
        "flash_fwd_wgmma": before["flash_fwd_wgmma"] + 1,
        "flash_fwd_mma": before["flash_fwd_mma"]}
    ref = attention_ref(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


MMA_SHAPES = [(2, 200, 4, 2, 96, True), (2, 200, 4, 2, 256, True),
              (1, 333, 8, 1, 256, False),                    # MQA, ragged
              (3, 77, 6, 3, 96, False), (1, 1, 8, 1, 256, True),   # S = 1
              (2, 130, 4, 4, 32, True), (1, 257, 8, 1, 200, True),
              (4, 2048, 8, 1, 256, True)]                     # gemma's
MMA_CASES = ([(dt, *shape) for dt in (torch.float32, torch.float16,
                                      torch.bfloat16) for shape in MMA_SHAPES]
             + [(dt, 2, 200, 4, 2, d, c) for dt in (torch.float32,
                                                    torch.float16)
                for d in (64, 128) for c in (True, False)])


@pytest.mark.parametrize("dtype,B,S,Hq,Hkv,d,causal", MMA_CASES)
def test_flash_attention_other_types_run_flash_fwd_mma(cuda, dtype, B, S,
                                                       Hq, Hkv, d, causal):
    """Every case but bf16 at d 64 / 128 runs flash_fwd_mma (its counter
    moves, flash_fwd_wgmma's does not), d up to 256, GQA and MQA, ragged
    S and non-causal: 2e-5 (fp32) / 2e-2 (fp16, bf16) of the plain
    version."""
    q, k, v = _qkv(cuda, B, S, Hq, Hkv, d, dtype, d + S)
    before = dict(fa_ops.kernel_launches)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.kernel_launches == {
        "flash_fwd_wgmma": before["flash_fwd_wgmma"],
        "flash_fwd_mma": before["flash_fwd_mma"] + 1}
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, causal).float(),
                               atol=tol, rtol=tol)


def test_flash_attention_wgmma_rejects_misaligned(cuda):
    """The tensor maps need 16-byte aligned tensors: a misaligned bf16
    tensor raises, it does not go to the other kernel."""
    buf = torch.randn(1 * 64 * 2 * 64 + 1, device=cuda).bfloat16()
    q = buf[1:].view(1, 64, 2, 64)
    k = v = q[:, :, :1].contiguous()
    before = dict(fa_ops.kernel_launches)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v)
    assert fa_ops.kernel_launches == before


def test_flash_attention_kernel_rejects_bad_inputs(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 64, torch.float32, 0)
    with pytest.raises(ValueError):                  # mixed dtypes
        fa_ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):                  # Hq % Hkv != 0
        fa_ops.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError):                  # head_dim > 256
        fa_ops.flash_attention(*_qkv(cuda, 1, 8, 1, 1, 257,
                                     torch.float32, 0))
    with pytest.raises(ValueError):                  # not contiguous
        fa_ops.flash_attention(q.transpose(1, 2), k, v)


# ----------------------------------------------------- mamba2_scan (B4)
def _ssd_inputs(cuda, B, S, H, N, P, seed, shared_qk=False, state=False):
    g = torch.Generator(cuda).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    if shared_qk:            # mamba2_forward's layout: one (B, S, N), H views
        q = (rn(B, S, N) * 0.5)[:, :, None].expand(B, S, H, N)
        k = (rn(B, S, N) * 0.5)[:, :, None].expand(B, S, H, N)
    else:
        q, k = rn(B, S, H, N) * 0.5, rn(B, S, H, N) * 0.5
    v = rn(B, S, H, P)
    log_a = -rn(B, S, H).abs() * 0.1
    st = rn(B, H, P, N) if state else None
    return q, k, v, log_a, st


@pytest.mark.parametrize("B,S,H,N,P,chunk,shared,state", [
    (1, 256, 4, 16, 32, 64, False, False), (2, 128, 1, 64, 64, 128, False,
                                            True),
    (1, 512, 3, 8, 16, 128, False, False), (1, 256, 1, 32, 128, 32, False,
                                            False),
    (2, 200, 2, 64, 256, 64, True, True), (1, 1, 2, 8, 64, 8, True, False),
    (2, 37, 3, 5, 70, 16, False, True), (1, 300, 2, 64, 96, 256, True,
                                         False),
    (2, 300, 2, 16, 100, 100, False, True),    # P, chunk not multiples of 8
    (2, 300, 2, 16, 100, 100, True, False),
    (1, 200, 3, 50, 64, 64, True, True), (2, 129, 2, 50, 256, 256, False,
                                          True),    # N 50
    (1, 1, 3, 50, 100, 100, False, True), (2, 1, 2, 64, 256, 256, True,
                                           True),   # S 1
    (4, 2048, 16, 64, 256, 256, True, True),        # serving, state in
    (4, 2048, 4, 1024, 1025, 256, False, False),    # xLSTM's mLSTM prefill
    (4, 2048, 4, 1024, 1025, 256, False, True),
    (1, 300, 2, 100, 1025, 256, False, True),       # N 100, P 1025
    (2, 129, 2, 1000, 100, 64, False, False),       # N 1000, P 100
    (2, 300, 2, 1000, 1025, 100, True, True),       # shared, ragged
    (1, 77, 3, 200, 33, 32, True, False), (1, 1, 2, 1024, 1025, 256, False,
                                           True)])
def test_mamba2_scan_kernel_matches_plain(cuda, B, S, H, N, P, chunk, shared,
                                          state):
    """y and the final state within 1e-4 of the plain version, scaled by
    max(|ref|, 1) (tests/test_kernels.py's bar); ragged S, S = 1, head
    stride 0 and per-head q and k, P and chunk 100, N 50, the serving
    shape and a nonzero initial state included; past one tile of N (100,
    200, 1000, 1024) with P 1025 (padded to a pitch of 1028), 100 and 33.  One call counts one
    launch, whatever the number of kernels it runs."""
    q, k, v, log_a, st = _ssd_inputs(cuda, B, S, H, N, P, B * S + N,
                                     shared, state)
    before = ssd_ops.launches
    y, fin = ssd_ops.ssd_scan(q, k, v, log_a, chunk, st, backend="cuda")
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    y_r, fin_r = ssd_scan_ref(q, k, v, log_a, chunk, st)
    for got, ref in ((y, y_r), (fin, fin_r)):
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got - ref).abs().max()) / scale <= 1e-4


def test_mamba2_scan_reads_pitched_v_in_place(cuda):
    """A v built in ``pitched`` (xLSTM's 1025 columns at a pitch of 1028)
    gives, bit for bit, the y and state of the same values handed over
    contiguous (which the wrapper copies into a padded buffer)."""
    q, k, v, log_a, st = _ssd_inputs(cuda, 2, 300, 2, 100, 1025, 7,
                                     state=True)
    vp = ssd_ops.pitched(2, 300, 2, 1025, device=cuda)
    vp.copy_(v)
    y, fin = ssd_ops.ssd_scan(q, k, v, log_a, 256, st, backend="cuda")
    y_p, fin_p = ssd_ops.ssd_scan(q, k, vp, log_a, 256, st, backend="cuda")
    assert torch.equal(y, y_p) and torch.equal(fin, fin_p)


def test_mamba2_scan_kernel_rejects_bad_inputs(cuda):
    q, k, v, log_a, _ = _ssd_inputs(cuda, 1, 16, 2, 1025, 8, 0)
    with pytest.raises(ValueError):                  # N > MAX_STATE_DIM
        ssd_ops.ssd_scan(q, k, v, log_a, 8)
    q, k, v, log_a, _ = _ssd_inputs(cuda, 1, 16, 2, 8, 8, 0)
    with pytest.raises(ValueError):                  # bf16 v
        ssd_ops.ssd_scan(q, k, v.bfloat16(), log_a, 8)
    with pytest.raises(ValueError):                  # state of the wrong shape
        ssd_ops.ssd_scan(q, k, v, log_a, 8, torch.zeros(1, 2, 8, 4,
                                                        device=cuda))


def test_reduced_xlstm_kernel_path_matches_plain(cuda):
    """xlstm_1p3b.reduced() at d_model 256 (7 mLSTM + 1 sLSTM, N = P =
    256 a head, P + 1 = 257 on v) in fp32: train-mode logits, prefill and
    three decode steps on the kernel path within 1e-4 of max(|plain|, 1)
    of the plain path, with one ``mamba2_scan`` launch a mLSTM block in
    each full-sequence pass."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import steps, transformer
    cfg = dataclasses.replace(get_config("xlstm_1p3b").reduced(),
                              d_model=256, compute_dtype="float32")
    params = transformer.init_params(cfg, 0, device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=cuda)
    out = {}
    for backend in ("cuda", "torch"):
        before = ssd_ops.launches
        with torch.inference_mode():
            full, _, _ = transformer.model_apply(params, cfg,
                                                 {"tokens": toks},
                                                 ssm_backend=backend)
            state = transformer.init_decode_state(cfg, 2, 40,
                                                  dtype=torch.float32,
                                                  device=cuda)
            pre, state = steps.make_prefill_step(cfg, 40, None, backend)(
                params, {"tokens": toks[:, :37]}, state)
            dec = []
            for i in range(37, 40):
                lg, state = steps.make_decode_step(cfg, None, backend)(
                    params, {"tokens": toks[:, i:i + 1]}, state, i)
                dec.append(lg)
        assert ssd_ops.launches - before == (14 if backend == "cuda" else 0)
        out[backend] = [full, pre, *dec]
    for got, ref in zip(out["cuda"], out["torch"]):
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got - ref).abs().max()) / scale <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_granite_kernel_path_matches_plain(cuda, dtype):
    """granite_moe_3b_a800m.reduced() (top-2 of 4 experts) on the card:
    train-mode logits and aux, prefill and three decode steps (capacity 1:
    assignments dropped) on the kernel path within 1e-4 (fp32) / 2e-2
    (bf16) of max(|plain|, 1) of the plain path, one ``flash_attention``
    launch a layer in each full-sequence pass; the MoE's output the same
    bits on a second call."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mlp, steps, transformer
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m").reduced(),
                              compute_dtype=dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    params = transformer.cast_params(
        transformer.init_params(cfg, 0, device=cuda), cfg)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=cuda)
    out = {}
    for backend in ("cuda", "torch"):
        before = fa_ops.launches
        with torch.inference_mode():
            full, _, aux = transformer.model_apply(params, cfg,
                                                   {"tokens": toks},
                                                   attn_backend=backend)
            state = transformer.init_decode_state(
                cfg, 2, 40, dtype=getattr(torch, dtype), device=cuda)
            pre, state = steps.make_prefill_step(cfg, 40, backend)(
                params, {"tokens": toks[:, :37]}, state)
            dec = []
            for i in range(37, 40):
                lg, state = steps.make_decode_step(cfg, backend)(
                    params, {"tokens": toks[:, i:i + 1]}, state, i)
                dec.append(lg)
        assert fa_ops.launches - before == (4 if backend == "cuda" else 0)
        out[backend] = [full, pre, *dec]
        assert float(aux) > 0
    for got, ref in zip(out["cuda"], out["torch"]):
        scale = max(float(ref.float().abs().max()), 1.0)
        assert float((got.float() - ref.float()).abs().max()) / scale <= tol
    moe = tree_map(lambda t: t[0], params["unit"][0])["moe"]
    x = torch.randn(80, cfg.d_model, generator=g, device=cuda).to(
        getattr(torch, dtype))
    with torch.inference_mode():
        route = mlp.moe_route(moe, x, cfg.moe)
        y1 = mlp.moe_experts(moe, x, route, cfg.moe, cfg.act)
        y2 = mlp.moe_experts(moe, x, route, cfg.moe, cfg.act)
    assert torch.equal(y1, y2)


# ------------------------------------------- the kernels under autograd
@pytest.mark.parametrize("B,S,Hq,Hkv,d,dtype", [
    (2, 300, 4, 4, 64, torch.bfloat16),      # flash_fwd_wgmma (zamba2's d)
    (1, 257, 4, 1, 256, torch.bfloat16),     # flash_fwd_mma at gemma's d
    (2, 200, 4, 2, 64, torch.float32)])      # flash_fwd_mma, 3xTF32
def test_flash_attention_grads_match_plain(cuda, B, S, Hq, Hkv, d, dtype):
    """Under autograd a CUDA call still launches its kernel (counted) and
    its q, k and v gradients are the plain version's, within the forward
    bars (2e-5 in fp32, 2e-2 in bf16, of max(|plain|, 1))."""
    q0, k0, v0 = _qkv(cuda, B, S, Hq, Hkv, d, dtype, S + d)
    g = torch.randn(B, S, Hq, d, device=cuda).to(dtype)
    name = "flash_fwd_wgmma" if fa_ops.uses_wgmma(dtype, d) else \
        "flash_fwd_mma"
    res = {}
    for backend in ("cuda", "torch"):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        before = dict(fa_ops.kernel_launches)
        out = fa_ops.flash_attention(q, k, v, backend=backend)
        assert out.requires_grad
        out.backward(g)
        torch.cuda.synchronize()
        launched = fa_ops.kernel_launches[name] - before[name]
        assert launched == (1 if backend == "cuda" else 0)
        res[backend] = (out, q.grad, k.grad, v.grad)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for got, ref in zip(res["cuda"], res["torch"]):
        assert got.dtype == dtype and got.shape == ref.shape
        scale = max(float(ref.float().abs().max()), 1.0)
        assert float((got.float() - ref.float()).abs().max()) / scale <= tol


@pytest.mark.parametrize("B,S,H,N,P,chunk,shared,state", [
    (2, 300, 4, 64, 64, 128, True, False),      # zamba2's N, broadcast q, k
    (2, 300, 4, 64, 64, 128, True, True),
    (1, 300, 2, 1024, 1025, 128, False, True),  # xLSTM's N, pitched v
    (1, 200, 2, 1024, 1025, 256, False, False)])
def test_mamba2_scan_grads_match_plain(cuda, B, S, H, N, P, chunk, shared,
                                       state):
    """Under autograd a CUDA call still launches the kernels (counted);
    the gradients of q, k (one (B, S, N) leaf broadcast over the heads,
    or per head), v (built in ``pitched`` at P 1025, as the mLSTM's),
    log_a and the carried-in state are the plain version's within 1e-4 of
    max(|plain|, 1), the kernel's forward bar."""
    q0, k0, v0, la0, st0 = _ssd_inputs(cuda, B, S, H, N, P, S + N, False,
                                       state)
    if shared:
        q0, k0 = q0[:, :, 0].contiguous(), k0[:, :, 0].contiguous()
    g = torch.Generator(cuda).manual_seed(5)
    gy = torch.randn(B, S, H, P, generator=g, device=cuda)
    gst = torch.randn(B, H, P, N, generator=g, device=cuda)
    res = {}
    for backend in ("cuda", "torch"):
        leaves = [t.clone().requires_grad_() if t is not None else None
                  for t in (q0, k0, v0, la0, st0)]
        q, k = ((t[:, :, None].expand(B, S, H, N) if shared else t)
                for t in leaves[:2])
        v = ssd_ops.pitched(B, S, H, P, device=cuda)
        v[...] = leaves[2] * 1.0
        before = ssd_ops.launches
        y, fin = ssd_ops.ssd_scan(q, k, v, leaves[3], chunk, leaves[4],
                                  backend=backend)
        torch.autograd.backward((y, fin), (gy, gst))
        torch.cuda.synchronize()
        assert ssd_ops.launches - before == (1 if backend == "cuda" else 0)
        res[backend] = [y, fin] + [t.grad for t in leaves if t is not None]
    for got, ref in zip(res["cuda"], res["torch"]):
        assert got.shape == ref.shape
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got - ref).abs().max()) / scale <= 1e-4


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_1p3b",
                                  "granite_moe_3b_a800m"])
def test_reduced_train_step_kernels_match_plain(cuda, arch):
    """One ``make_train_step`` step of a reduced config in fp32 with remat
    on the card: the kernel path's loss within 1e-5 relative, its
    gradients within 1e-4 of each leaf's max and its params after AdamW
    within lr / 100 of the plain path's (2 lr where a gradient is within
    1e-3 of its leaf's max of 0: AdamW's first step is lr times its
    sign); each kernel of the unit launched twice (the forward and
    remat's recompute)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.nn import value_and_grad
    from repro_torch.models import steps, transformer
    from repro_torch.train.data import DataConfig, SyntheticTokenStream
    from repro_torch.train.optim import adamw_init
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True,
                              compute_dtype="float32")
    params = transformer.init_params(cfg, 0, device=cuda)
    batch = SyntheticTokenStream(cfg, DataConfig(40, 2), cuda).next_batch()
    unit, reps, rem = transformer.unit_and_reps(cfg)
    res = {}
    for backend in ("cuda", "torch"):
        before = (fa_ops.launches, ssd_ops.launches)
        (_, (ce, _)), grads = value_and_grad(
            lambda p: transformer.lm_loss(p, cfg, batch, attn_backend=backend,
                                          ssm_backend=backend),
            params, has_aux=True)
        step = steps.make_train_step(cfg, 1e-3, attn_backend=backend,
                                     ssm_backend=backend)
        new, _, metrics = step(params, adamw_init(params), batch, 0)
        torch.cuda.synchronize()
        n = (fa_ops.launches - before[0], ssd_ops.launches - before[1])
        want = (2 * 2 * reps * sum(k in ("attn", "attn_shared")
                                   for k in unit),
                2 * (2 * reps * sum(k in ("mamba", "mlstm") for k in unit)
                     + sum(k in ("mamba", "mlstm") for k in rem)))
        assert n == (want if backend == "cuda" else (0, 0))
        res[backend] = (ce, grads, new)
    (ce, g, p), (ce_r, g_r, p_r) = res["cuda"], res["torch"]
    assert abs(float(ce) - float(ce_r)) <= 1e-5 * abs(float(ce_r))
    for a, b in zip(tree_leaves(g), tree_leaves(g_r)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for a, b, gr in zip(tree_leaves(p), tree_leaves(p_r), tree_leaves(g_r)):
        clear = gr.abs() > 1e-3 * gr.abs().max()
        bar = torch.where(clear, 1e-3 / 100, 2e-3 + 1e-3 / 100)
        assert bool(((a - b).abs() <= bar).all())


# ------------------------------------- checkpoints and the baselines
def test_fused_resume_after_capture(cuda, tmp_path):
    """Trainer B captures its fused engine (one update), then loads A's
    checkpoint: its next dispatches replay the same graph on the restored
    state, bit-identical to A's continuation."""
    a, _ = _train_twins(cuda)
    a.stage2_fused(2, batch_size=8, updates_per_dispatch=2)
    save_policy(tmp_path, a)
    want = a.stage2_fused(2, batch_size=8, updates_per_dispatch=2)
    b = DopplerTrainer(a.g, a.dev, seed=7, device=cuda)
    b.stage2_fused(1, batch_size=8, updates_per_dispatch=2)
    eng = _fused_engine(b, "stage2")
    assert eng.graphed.graph is not None
    load_policy(tmp_path, b)
    assert b.stage2_fused(2, batch_size=8, updates_per_dispatch=2) == want
    assert _fused_engine(b, "stage2") is eng and eng.graphed.replays == 3
    for x, y in zip(tree_leaves((a.params, a.opt_state.mu, a.opt_state.nu)),
                    tree_leaves((b.params, b.opt_state.mu, b.opt_state.nu))):
        assert torch.equal(x, y)
    assert a.opt_state.step == b.opt_state.step and a.episode == b.episode
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert np.array_equal(a.greedy_assignment(), b.greedy_assignment())


def test_checkpoint_from_the_cpu_on_the_card(cuda, tmp_path):
    """A CPU trainer's checkpoint: its params restore onto the card
    bit-equal; ``load_policy`` refuses its mt19937 generator state for
    the card's Philox generator and leaves the trainer as it was."""
    g, fm = workloads.get_workload("ffnn"), get_device_model("p100x4")
    src = DopplerTrainer(g, fm, seed=3, device="cpu")
    src.stage2_sim_batched(1, batch_size=4)
    save_policy(tmp_path, src)
    card = DopplerTrainer(g, fm, seed=0, device=cuda)
    like = (card.params, AdamState(torch.zeros((), dtype=torch.int32),
                                   card.opt_state.mu, card.opt_state.nu))
    (params, _), _ = restore_checkpoint(tmp_path, latest_step(tmp_path),
                                        like)
    for x, y in zip(tree_leaves(params), tree_leaves(src.params)):
        assert x.device.type == "cuda" and torch.equal(x.cpu(), y)
    before = card.generator.get_state()
    with pytest.raises(ValueError, match="cpu generator.*cuda generator"):
        load_policy(tmp_path, card)
    assert card.episode == 0 and torch.equal(card.generator.get_state(),
                                             before)


@pytest.mark.parametrize("kind", ["gdp", "placeto"])
def test_baseline_episode_kernels_match_plain(cuda, kind):
    """One episode on the kernel backend against the plain one, from the
    same params and generator seed: chip_smoke.py's training gate, and
    the pair's launches (a GDP rollout encodes once, a Placeto rollout
    once a step; the replay as many again)."""
    T = {"gdp": GDPTrainer, "placeto": PlacetoTrainer}[kind]
    g, fm = workloads.get_workload("ffnn"), get_device_model("p100x4")
    kern = T(g, fm, seed=0, device=cuda)
    plain = T(g, fm, seed=0, device=cuda, encoder_backend="torch")
    assert kern.encoder_backend == "cuda"
    sim = WCSimulator(g, fm, noise_sigma=0.05)
    layers = len(kern.params["gnn"]["layers"])
    per_rollout = layers * (1 if kind == "gdp" else g.n)
    p0 = gnn_ops.pair_launches
    kern.train(1, sim)
    assert gnn_ops.pair_launches - p0 == 2 * per_rollout
    p0 = gnn_ops.pair_launches
    plain.train(1, sim)
    assert gnn_ops.pair_launches == p0
    _assert_same_update(kern, plain)
    assert kern.history == plain.history


# ------------------------------------------------------------ the hierarchy
HIER = HierarchyConfig(n_segments=16, refine_rounds=2, refine_top_k=12)


def _hier_trainer(cuda, plain=False, n_layers=32, seed=0):
    kw = dict(encoder_backend="torch", oracle_backend="torch") if plain \
        else {}
    return DopplerTrainer(workloads.synthetic_layered(n_layers, 16),
                          get_device_model("v100x8"), seed=seed,
                          device=cuda, hierarchy=HIER, **kw)


def test_wc_trips_on_a_refine_batch_equals_plain(cuda):
    """A refinement round's candidates (``propose_moves`` at the CP
    assignment, top-k 24) on ``synthetic_layered(32, 16)`` x v100x8
    (n 529), in both placements of the state."""
    tr = _hier_trainer(cuda)
    g = tr.flat_graph
    cands, moves = propose_moves(g, critical_path_assignment(g, tr.dev),
                                 24, tr.hier.exec_cost, tr.dev.n)
    assert len(moves) > 16
    sg = SimGraph.build(g, tr.dev, cuda)
    args = trip_inputs(sg, torch.as_tensor(cands, device=cuda))
    ms_r, nd_r = wc_trips_ref(sg, *args)
    for where in ("shared", "global"):
        ms_k, nd_k = wc_ops.wc_trips(sg, *args, where=where)
        torch.cuda.synchronize()
        assert torch.equal(ms_k, ms_r) and torch.equal(nd_k, nd_r)
    assert (nd_r == sg.n_compute).all()


def test_hierarchical_place_and_replace_match_plain(cuda):
    """The same trainer on the kernel and on the plain backends, on the
    card: ``place()`` (pool, V-cycle, refinement) and ``replace()`` for a
    device loss give the same assignments and makespans; the kernel
    trainer launches ``wc_trips`` once an engine call."""
    class Counted(RewardEngine):
        batched = deterministic = True

        def __init__(self, inner):
            self.inner, self.calls = inner, 0

        def exec_times(self, assignments, episode=0):
            self.calls += 1
            return self.inner.exec_times(assignments, episode)

    kern, plain = _hier_trainer(cuda), _hier_trainer(cuda, plain=True)
    assert kern.hier.n_levels == 2 and kern.g.n < kern.flat_graph.n
    eng = Counted(kern.flat_engine())
    t0 = wc_ops.trip_launches
    got = kern.place(engine=eng)
    assert wc_ops.trip_launches - t0 == eng.calls >= 3
    want = plain.place()
    assert wc_ops.trip_launches - t0 == eng.calls
    assert np.array_equal(got.assignment, want.assignment)
    assert got.makespan == want.makespan
    assert np.array_equal(got.makespans, want.makespans)
    assert got.makespan <= got.makespans[-3:].min()
    ev = FleetEvent.device_loss(3)
    r, p = (tr.replace(ev, budget_s=1e9, commit=False) for tr in (kern,
                                                                  plain))
    assert np.array_equal(r.assignment, p.assignment)
    assert (r.makespan, r.cp_makespan, r.source) == (p.makespan,
                                                     p.cp_makespan, p.source)
    assert r.assignment.max() < 7 and r.makespan <= r.cp_makespan


def test_fused_updates_after_a_committed_loss(cuda):
    """A device loss committed (8 -> 7 devices) drops the captured
    engines; the next captured updates equal a fresh 7-device trainer's
    from the same state, bit for bit."""
    tr = _hier_trainer(cuda, n_layers=16)
    tr.stage2_fused(2, batch_size=8, updates_per_dispatch=2)
    tr.replace(FleetEvent.device_loss(3), budget_s=1e9)
    assert tr._fused_cache == {} and tr.gd.nd == 7
    fresh = DopplerTrainer(tr.flat_graph, tr.dev, seed=5, device=cuda,
                           hierarchy=HIER)
    fresh.params = tree_map(torch.clone, tr.params)
    fresh.opt_state = AdamState(tr.opt_state.step,
                                tree_map(torch.clone, tr.opt_state.mu),
                                tree_map(torch.clone, tr.opt_state.nu))
    fresh.episode = tr.episode
    fresh.best_assignment, fresh.best_time = (tr.best_assignment.copy(),
                                              tr.best_time)
    fresh.generator.set_state(tr.generator.get_state())
    want = fresh.stage2_fused(2, batch_size=8, updates_per_dispatch=2)
    assert tr.stage2_fused(2, batch_size=8, updates_per_dispatch=2) == want
    for x, y in zip(tree_leaves((tr.params, tr.opt_state.mu,
                                 tr.opt_state.nu)),
                    tree_leaves((fresh.params, fresh.opt_state.mu,
                                 fresh.opt_state.nu))):
        assert torch.equal(x, y)


def test_fused_updates_are_deterministic(cuda):
    """Two trainers from one state run the same captured updates bit for
    bit on a graph whose predecessors carry distinct flops (the device
    features' per-device sums must not depend on the order of atomic
    adds)."""
    a = _hier_trainer(cuda, n_layers=64)
    a.stage2_fused(1, batch_size=16, updates_per_dispatch=1)
    b = _hier_trainer(cuda, n_layers=64, seed=3)
    b.params = tree_map(torch.clone, a.params)
    b.opt_state = AdamState(a.opt_state.step, tree_map(torch.clone,
                                                       a.opt_state.mu),
                            tree_map(torch.clone, a.opt_state.nu))
    b.episode, b._r_sum, b._r_sqsum, b._r_count = (
        a.episode, a._r_sum, a._r_sqsum, a._r_count)
    b.generator.set_state(a.generator.get_state())
    assert a.stage2_fused(2, batch_size=16) == b.stage2_fused(2,
                                                              batch_size=16)
    for x, y in zip(tree_leaves((a.params, a.opt_state.mu, a.opt_state.nu)),
                    tree_leaves((b.params, b.opt_state.mu, b.opt_state.nu))):
        assert torch.equal(x, y)


# ------------------------------------- pretraining and zero-shot serving
def _cpu_params(seed=3):
    from repro_torch.core.policies import init_policies
    return init_policies(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("gname,fleet", [("llama_block", "mixed_gen4"),
                                         ("ffnn", "two_pod_2x2")])
def test_greedy_place_on_the_card_equals_the_cpu(cuda, gname, fleet):
    from repro_torch.core.zero_shot import greedy_place
    g, fm = workloads.get_workload(gname), get_device_model(fleet)
    params = _cpu_params()
    p0 = gnn_ops.pair_launches
    got = greedy_place(params, g, fm, device=cuda)
    assert gnn_ops.pair_launches - p0 == 2          # one a GNN layer
    assert np.array_equal(got, greedy_place(params, g, fm, device="cpu"))


def test_server_miss_on_the_card_equals_the_cpu(cuda):
    from repro_torch.launch.place_server import PlacementServer
    g, fm = workloads.get_workload("llama_block"), get_device_model(
        "straggler8")
    params = _cpu_params()
    srv = PlacementServer(params, device=cuda)
    p0, t0 = gnn_ops.pair_launches, wc_ops.trip_launches
    got = srv.place(g, fm)
    assert (gnn_ops.pair_launches - p0, wc_ops.trip_launches - t0) == (2, 0)
    p0 = gnn_ops.pair_launches
    assert srv.place(g, fm).cache_hit and gnn_ops.pair_launches == p0
    want = PlacementServer(params, device="cpu").place(g, fm)
    assert np.array_equal(got.assignment, want.assignment)
    assert (got.makespan, got.source) == (want.makespan, want.source)


def test_pretrain_first_update_on_the_card_matches_plain(cuda):
    """``pretrain`` on the card (its trainers on the kernel backends); its
    first Stage II update re-run from the same state and generator on a
    kernel-backend and a plain-backend trainer: the update itself and the
    two twins at the training gate."""
    from repro_torch.core import training
    tasks = [training.PretrainTask("ffnn|p100x4", workloads.ffnn(),
                                   get_device_model("p100x4"))]
    first = {}
    orig = DopplerTrainer._batched_rl_update

    def update(tr, reward, batch_size, stage, **k):
        if not first:
            first.update(state=(tree_map(torch.clone, tr.params),
                                tr.opt_state, tr.generator.get_state(),
                                tr.episode), reward=reward)
            out = orig(tr, reward, batch_size, stage, **k)
            first["update"] = tr.last_update
            return out
        return orig(tr, reward, batch_size, stage, **k)

    DopplerTrainer._batched_rl_update = update
    try:
        pre = training.pretrain(tasks, rounds=2, batch_size=8,
                                imitation_episodes=1, device=cuda)
    finally:
        DopplerTrainer._batched_rl_update = orig
    assert np.isfinite(pre["per_task"]["ffnn|p100x4"]["best_time"])
    twins = []
    for backend in ("cuda", "torch"):
        tr = DopplerTrainer(tasks[0].graph, tasks[0].dev, seed=0,
                            d_hidden=64, lr0=3e-3, lr1=1e-5,
                            total_episodes=1 + 2 * 8, device=cuda,
                            encoder_backend=backend)
        params, opt, gen, episode = first["state"]
        tr.params, tr.opt_state, tr.episode = params, opt, episode
        tr.generator.set_state(gen)
        tr._batched_rl_update(first["reward"], 8, "pretrain")
        twins.append(tr)
    kern, plain = twins
    assert np.array_equal(kern.last_update["rewards"],
                          first["update"]["rewards"])
    _assert_same_update(kern, plain)


# ------------------------------------- the dense configs and the driver
def _kernel_vs_plain_logits(cuda, cfg, params, what):
    """Train-mode logits, a prefill and three decode steps of ``cfg`` on
    the kernel path and the plain path -> (the kernel path's largest
    scaled gap, its ``flash_attention`` launches)."""
    from repro_torch.models import steps, transformer
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=cuda)
    dt = getattr(torch, cfg.compute_dtype)
    out, launched = {}, {}
    for backend in ("cuda", "torch"):
        before = dict(fa_ops.kernel_launches)
        with torch.inference_mode():
            full, _, _ = transformer.model_apply(params, cfg,
                                                 {"tokens": toks},
                                                 attn_backend=backend)
            state = transformer.init_decode_state(cfg, 2, 40, dtype=dt,
                                                  device=cuda)
            pre, state = steps.make_prefill_step(cfg, 40, backend)(
                params, {"tokens": toks[:, :37]}, state)
            dec = []
            for i in range(37, 40):
                lg, state = steps.make_decode_step(cfg, backend)(
                    params, {"tokens": toks[:, i:i + 1]}, state, i)
                dec.append(lg)
        launched[backend] = {k: fa_ops.kernel_launches[k] - before[k]
                             for k in before}
        out[backend] = [full, pre, *dec]
    assert not any(launched["torch"].values()), what
    err = max(float((a.float() - b.float()).abs().max())
              / max(float(b.float().abs().max()), 1.0)
              for a, b in zip(out["cuda"], out["torch"]))
    return err, launched["cuda"]


def test_reduced_olmo_mixed_precision_kernel_matches_plain_mixed(cuda):
    """olmo-1b reduced at head_dim 128 in bf16 with
    ``attn_mixed_precision``: the kernel path (``flash_fwd_wgmma``, which
    computes the fp32-P mode) within the bf16 bar 2e-2 of the plain path
    in the mixed mode (P rounded to bf16), one launch a layer a
    full-sequence pass."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("olmo_1b").reduced(), d_model=256,
                              n_heads=2, n_kv_heads=2, head_dim=128,
                              compute_dtype="bfloat16",
                              attn_mixed_precision=True)
    params = transformer.cast_params(
        transformer.init_params(cfg, 0, device=cuda), cfg)
    err, launched = _kernel_vs_plain_logits(cuda, cfg, params, "mixed")
    assert launched == {"flash_fwd_wgmma": 2 * cfg.n_layers,
                        "flash_fwd_mma": 0}
    assert err <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_qwen_bias_kernel_path_matches_plain(cuda, dtype):
    """A qwen1.5-style reduced config (QKV bias, rope theta 1e6, untied
    head, GQA 8:1 at head_dim 64), its biases and norm scales random: the
    kernel path within 1e-4 (fp32) / 2e-2 (bf16) of the plain path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("qwen1p5_110b").reduced(),
                              d_model=256, n_heads=8, n_kv_heads=1,
                              head_dim=64, compute_dtype=dtype)
    assert (cfg.qkv_bias, cfg.rope_theta, cfg.tie_embeddings) == \
        (True, 1e6, False)
    params = transformer.init_params(cfg, 0, device=cuda)
    g = torch.Generator(cuda).manual_seed(2)
    params = tree_map(lambda t: t + 0.3 * torch.randn(
        t.shape, generator=g, device=cuda) if t.dim() == 2
        and t.shape[-1] <= 512 and t.shape[0] == cfg.n_layers else t,
        params)
    params = transformer.cast_params(params, cfg)
    assert float(params["unit"][0]["bq"].abs().max()) > 0
    err, launched = _kernel_vs_plain_logits(cuda, cfg, params, "qwen")
    kernel = "flash_fwd_wgmma" if dtype == "bfloat16" else "flash_fwd_mma"
    assert launched[kernel] == 2 * cfg.n_layers
    assert err <= (1e-4 if dtype == "float32" else 2e-2)


def test_reduced_driver_resume_is_bit_equal_on_the_card(cuda, tmp_path):
    """``launch/train.py`` on the card, reduced olmo-1b in bf16: 6 steps
    with a checkpoint every 2, then steps 4 and 5 deleted and the run
    again, resumed from 2; the two final checkpoints are the same bytes."""
    import shutil
    from repro_torch.launch import train
    argv = ["--arch", "olmo_1b", "--reduced", "--steps", "6", "--batch",
            "2", "--seq", "64", "--ckpt-every", "2", "--log-every", "1"]
    res = train.main([*argv, "--ckpt-dir", str(tmp_path / "a")])
    assert res.params["embed"].device.type == "cuda"
    assert all(bool(torch.isfinite(m["loss"])) for m in res.metrics)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for step in (4, 5):
        shutil.rmtree(tmp_path / "b" / f"step_{step:09d}")
    again = train.main([*argv, "--ckpt-dir", str(tmp_path / "b")])
    assert again.start == 3
    last = "step_000000005/arrays.msgpack"
    assert (tmp_path / "a" / last).read_bytes() == \
        (tmp_path / "b" / last).read_bytes()


def test_dryrun_argument_bytes_match_the_card(cuda):
    """The dry-run's one-card argument bytes (``launch/dryrun.py``: f32
    params, their AdamW moments and an int32 batch, from the specs) for
    reduced olmo-1b against what the card allocates for the params, the
    moments and the batch; within 1% (chip_smoke.py's path 18b gate)."""
    from repro_torch.configs.registry import ShapeCell, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.train.optim import adamw_init
    cfg = get_config("olmo_1b").reduced()
    cell = ShapeCell("t", 64, 4, "train")
    pred = dryrun.argument_bytes(cfg, cell, {"data": 1, "model": 1})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = transformer.init_params(cfg, 0, device=cuda)
    opt = adamw_init(params)
    batch = {k: torch.zeros(4, 64, dtype=torch.int32, device=cuda)
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert len(tree_leaves(opt.mu)) == len(tree_leaves(params))
    assert batch["tokens"].is_cuda
    # the caching allocator rounds each block up to 512 bytes, which at
    # the reduced widths is more than 1%: held exactly, up to that
    n_blocks = 3 * len(tree_leaves(params)) + 2
    assert pred["total"] <= held <= pred["total"] + 512 * n_blocks
