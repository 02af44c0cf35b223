"""The CUDA kernels against their plain versions, on the card.

Every test here needs a GPU (marker ``cuda``) and skips without one.  The
file imports no jax, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: ``wc_step`` bit-exact on run_out and e1 (rho where alive); the
``gnn_mp`` segment-sum within 1e-5 of the plain version relative to the
output's largest magnitude (both sum in fp32, in different orders);
the oracle's makespans with the kernel equal to the plain path's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.devices import get_device_model
from repro_torch.core.sim_torch import SimGraph, makespan_fifo_batch
from repro_torch.core.training import DopplerTrainer
from repro_torch.graphs import workloads
from repro_torch.kernels.gnn_mp import ops as gnn_ops
from repro_torch.kernels.gnn_mp.ref import build_csr, segment_sum_ref
from repro_torch.kernels.wc_oracle import ops as wc_ops
from repro_torch.kernels.wc_oracle.ref import wc_step_ref

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
    before = wc_ops.launches
    ms_k, ok_k = makespan_fifo_batch(sg, A.to(cuda), backend="cuda")
    assert wc_ops.launches > before
    ms_t, ok_t = makespan_fifo_batch(sg, A.to(cuda), backend="torch")
    ms_c, ok_c = makespan_fifo_batch(SimGraph.build(g, dev, "cpu"), A,
                                     backend="torch")
    assert ok_k.all() and ok_t.all() and ok_c.all()
    assert torch.equal(ms_k, ms_t) and torch.equal(ms_k.cpu(), ms_c)


def test_placement_request_on_the_card(cuda):
    g = workloads.ffnn()
    tr = DopplerTrainer(g, get_device_model("p100x4"), seed=0, device=cuda)
    assert (tr.encoder_backend, tr.oracle_backend) == ("cuda", "cuda")
    g0, w0 = gnn_ops.launches, wc_ops.launches
    pl = tr.place(n_samples=16)
    assert gnn_ops.launches - g0 == 4          # 2 layers x 2 directions
    assert wc_ops.launches > w0
    assert pl.population.shape == (16, g.n) and np.isfinite(pl.makespans).all()
    assert pl.makespan == pl.makespans.min()
