"""Port kernels' plain versions vs the JAX reference (Pallas in interpret
mode and the plain jnp refs).

* gnn_mp: ``segment_sum`` within atol 1e-4 of ``segment_sum_mp``
  (the reference suite's bar) and its gradient exactly equal to
  ``jax.grad`` of the same (both are the gather ``g[dst]``).
* wc_oracle: ``wc_step`` bit-exact on run_out and e1, rho where the
  episode is alive (isfinite(e1)).
On the CPU the wrappers take the plain version; the CUDA kernels
themselves are held against it by tests/test_torch_cuda.py on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gnn_mp.ops import segment_sum_mp
from repro.kernels.gnn_mp.ref import segment_sum_ref as jax_segment_sum_ref
from repro.kernels.wc_oracle.ops import wc_step as jax_wc_step
from repro.kernels.wc_oracle.ref import wc_step_ref as jax_wc_step_ref
from repro_torch.kernels.gnn_mp.ops import segment_sum
from repro_torch.kernels.gnn_mp.ref import build_csr, segment_sum_ref
from repro_torch.kernels.wc_oracle.ops import wc_step
from repro_torch.kernels.wc_oracle.ref import wc_step_ref


def _gnn_inputs(m, n, d, seed):
    rng = np.random.default_rng(seed)
    msg = rng.standard_normal((m, d)).astype(np.float32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return msg, dst


def _gnn_check(m, n, d, seed):
    msg, dst = _gnn_inputs(m, n, d, seed)
    ref = np.asarray(segment_sum_mp(jnp.asarray(msg), jnp.asarray(dst), n=n,
                                    interpret=True))
    for backend in ("torch", "cuda"):          # "cuda" on CPU tensors: plain
        got = segment_sum(torch.from_numpy(msg), torch.from_numpy(dst).long(),
                          n, backend=backend).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jax_segment_sum_ref(jnp.asarray(msg),
                                            jnp.asarray(dst), n)),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("m,n,d", [(500, 100, 32), (128, 128, 64),
                                   (1000, 53, 16), (64, 200, 8),
                                   (364, 252, 64)])
def test_segment_sum_sweep(m, n, d):
    _gnn_check(m, n, d, seed=m + n)


def test_segment_sum_randomized_shapes():
    rng = np.random.default_rng(11)
    for i in range(4):
        _gnn_check(int(rng.integers(1, 400)), int(rng.integers(1, 150)),
                   int(rng.integers(1, 80)), seed=100 + i)


def test_segment_sum_degenerate():
    """Empty edge set, single-vertex graph, isolated rows come out zero."""
    out = segment_sum(torch.zeros(0, 8), torch.zeros(0, dtype=torch.long), 5)
    assert out.shape == (5, 8) and not out.any()
    out = segment_sum(torch.ones(1, 1), torch.zeros(1, dtype=torch.long), 1)
    assert torch.equal(out, torch.ones(1, 1))
    msg = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    out = segment_sum(msg, torch.tensor([4, 0, 4]), 6)
    assert torch.equal(out, torch.tensor([[2., 3.], [0, 0], [0, 0], [0, 0],
                                          [4., 6.], [0, 0]]))


def test_csr_groups_edges_stably():
    dst = torch.tensor([2, 0, 2, 1, 0, 2])
    csr = build_csr(dst, 4)
    assert csr.perm.tolist() == [1, 4, 3, 0, 2, 5]
    assert csr.row_ptr.tolist() == [0, 2, 3, 6, 6]
    assert csr.slots.tolist() == [[1, 4, -1], [3, -1, -1], [0, 2, 5],
                                  [-1, -1, -1]]
    msg = torch.randn(6, 3)
    assert torch.equal(segment_sum_ref(msg, dst, 4, csr),
                       segment_sum_ref(msg, dst, 4))


def test_segment_sum_grad_matches_jax():
    """The autograd Function's backward (g[dst]) equals jax.grad exactly."""
    m, n, d = 64, 16, 8
    msg, dst = _gnn_inputs(m, n, d, seed=3)
    w = np.random.default_rng(4).standard_normal((n, d)).astype(np.float32)
    g_jax = jax.grad(lambda z: (segment_sum_mp(z, jnp.asarray(dst), n=n,
                                               interpret=True)
                                * jnp.asarray(w)).sum())(jnp.asarray(msg))
    z = torch.from_numpy(msg).requires_grad_(True)
    (segment_sum(z, torch.from_numpy(dst).long(), n) * torch.from_numpy(w)
     ).sum().backward()
    assert np.array_equal(z.grad.numpy(), np.asarray(g_jax))


def test_segment_sum_rejects_unknown_backend():
    with pytest.raises(ValueError):
        segment_sum(torch.ones(2, 2), torch.zeros(2, dtype=torch.long), 1,
                    backend="pallas")


# ------------------------------------------------------------- wc_oracle
def _rand_wc_state(rng, B, R, K):
    """Random running table + start rows honoring the kernel contract:
    exact-integer f32 keys, duplicate targets carry identical rows, some
    slots idle (end=+inf), some candidates dropped (ridx=-1)."""
    run = rng.integers(0, 50, size=(B, R, 6)).astype(np.float32)
    idle = rng.random((B, R)) < 0.4
    run[..., 0] = np.where(idle, np.inf, run[..., 0] + 1.0)
    tgt = rng.integers(0, R, size=(B, K))
    base = rng.integers(0, 50, size=(B, R, 6)).astype(np.float32)
    rows = np.take_along_axis(base, tgt[:, :, None], axis=1)
    ridx = np.where(rng.random((B, K)) < 0.3, -1, tgt).astype(np.int32)
    return run, rows, ridx


def _wc_check(run, rows, ridx, pallas: bool = True):
    refs = [jax_wc_step_ref(jnp.asarray(run), jnp.asarray(rows),
                            jnp.asarray(ridx))]
    if pallas:
        refs.append(jax_wc_step(jnp.asarray(run), jnp.asarray(rows),
                                jnp.asarray(ridx), interpret=True))
    got = [wc_step(torch.from_numpy(run), torch.from_numpy(rows),
                   torch.from_numpy(ridx), backend=b)
           for b in ("torch", "cuda")]               # "cuda" on CPU: plain
    for out_r, rho_r, e1_r in refs:
        alive = np.isfinite(np.asarray(e1_r))
        for out_t, rho_t, e1_t in got:
            assert np.array_equal(out_t.numpy(), np.asarray(out_r))
            assert np.array_equal(e1_t.numpy(), np.asarray(e1_r))
            assert np.array_equal(rho_t.numpy()[alive],
                                  np.asarray(rho_r)[alive])
            assert rho_t.dtype == torch.int32 and e1_t.dtype == torch.float32
    return got[0]


@pytest.mark.parametrize("B,R,K", [
    (3, 20, 5), (1, 1, 1), (8, 130, 140), (5, 6, 2), (2, 2, 1),
    (16, 257, 129), (257, 72, 8),
])
def test_wc_step_sweep(B, R, K):
    """(2, 2, 1) is the 1-device fleet (R = nd + nd**2 = 2); (257, 72, 8)
    is the main path's shape (v100x8 with K_pop = 256 + greedy)."""
    rng = np.random.default_rng(B * 1000 + R + K)
    _wc_check(*_rand_wc_state(rng, B, R, K), pallas=B * R < 4000)


def test_wc_step_randomized_shapes():
    rng = np.random.default_rng(23)
    for _ in range(5):
        B = int(rng.integers(1, 12))
        R = int(rng.integers(1, 300))
        K = int(rng.integers(1, 150))
        _wc_check(*_rand_wc_state(rng, B, R, K))


def test_wc_step_drained_and_all_dropped():
    """Drained episodes with every candidate dropped: the table passes
    through untouched and e1 is +inf."""
    B, R, K = 3, 7, 4
    run = np.zeros((B, R, 6), np.float32)
    run[..., 0] = np.inf
    rows = np.ones((B, K, 6), np.float32)
    ridx = np.full((B, K), -1, np.int32)
    out, _, e1 = _wc_check(run, rows, ridx)
    assert np.array_equal(out.numpy(), run)
    assert torch.isinf(e1).all()


def test_wc_step_lexicographic_tiebreak():
    """Equal ends, then equal start trips, then equal ready times force the
    pop down to the sequence key."""
    run = np.full((1, 4, 6), 9.0, np.float32)
    run[0, :, 0] = [5.0, 5.0, 5.0, 5.0]
    run[0, :, 1] = [2.0, 1.0, 1.0, 1.0]
    run[0, :, 2] = [0.0, 3.0, 2.0, 2.0]
    run[0, :, 3] = [0.0, 0.0, 7.0, 4.0]
    rows = np.zeros((1, 1, 6), np.float32)
    ridx = np.full((1, 1), -1, np.int32)
    out, rho, e1 = _wc_check(run, rows, ridx)
    assert int(rho[0]) == 3 and float(e1[0]) == 5.0
    assert torch.isinf(out[0, 3, 0])


def test_wc_step_duplicate_targets_and_write_then_pop():
    """A start row written this trip can be popped in the same trip, and
    duplicate targets (identical rows) combine to that row."""
    run = np.zeros((1, 3, 6), np.float32)
    run[..., 0] = np.inf
    row = np.array([1.5, 4.0, 0.5, 11.0, 7.0, 1.5], np.float32)
    rows = np.stack([row, row, row * 0 + 9.0])[None]
    ridx = np.array([[2, 2, -1]], np.int32)
    out, rho, e1 = _wc_check(run, rows, ridx)
    assert int(rho[0]) == 2 and float(e1[0]) == 1.5
    assert np.array_equal(out.numpy()[0, 2, 1:], row[1:])
    assert torch.isinf(out[0, 2, 0])


def test_wc_step_rejects_unknown_backend():
    with pytest.raises(ValueError):
        wc_step(torch.zeros(1, 2, 6), torch.zeros(1, 1, 6),
                torch.zeros(1, 1, dtype=torch.int32), backend="pallas")
