"""The port's Mamba2 / SSD scan against the JAX reference on the CPU.

``repro_torch.kernels.mamba2_scan.ops.ssd_scan`` on CPU tensors is its
plain version; it is held against the Pallas kernel in interpret mode,
``gla_ref`` and ``chunked_gla`` (y and the final state), with a nonzero
initial state and a ragged S.  ``mamba2_forward`` / ``mamba2_step`` and
``gla_step`` are held against the reference's on the same parameters.
Bar (tests/test_kernels.py:222-240): 1e-4 scaled by max(|ref|, 1).  The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan.kernel import mamba2_chunk_scan
from repro.kernels.mamba2_scan.ref import gla_ref
from repro.models import ssm as jax_ssm
from repro.models.config import SSMConfig as JaxSSMConfig
from repro_torch.kernels.mamba2_scan.ops import chunk_cumsum, ssd_scan
from repro_torch.models import ssm
from repro_torch.models.config import SSMConfig
from repro_torch.models.convert import params_from_numpy

TOL = 1e-4


def _scaled_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, rtol=tol)


def _inputs(B, S, H, N, P, seed, state=False):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    log_a = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(
        np.float32)
    st = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if state else None)
    return q, k, v, log_a, st


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("bh,s,n,p,chunk", [(4, 256, 16, 32, 64),
                                            (2, 128, 64, 64, 128),
                                            (1, 256, 32, 128, 32)])
def test_ssd_scan_matches_pallas_interpret(bh, s, n, p, chunk):
    q, k, v, log_a, _ = _inputs(1, s, bh, n, p, bh + s)
    fold = lambda x: jnp.asarray(np.moveaxis(x[0], 1, 0))   # (BH, S, ...)
    ref = mamba2_chunk_scan(fold(q), fold(k), fold(v), fold(log_a),
                            chunk=chunk, interpret=True)
    for backend in ("torch", "cuda"):        # "cuda" on CPU tensors: plain
        y, _ = ssd_scan(_t(q), _t(k), _t(v), _t(log_a), chunk,
                        backend=backend)
        _scaled_close(y[0].permute(1, 0, 2), ref)
    _scaled_close(y[0].permute(1, 0, 2),
                  gla_ref(fold(q), fold(k), fold(v), fold(log_a), chunk))


@pytest.mark.parametrize("B,S,H,N,P,chunk,state", [
    (2, 64, 2, 8, 16, 16, True), (1, 37, 3, 5, 7, 8, True),
    (2, 20, 2, 8, 16, 32, True), (1, 1, 2, 4, 4, 8, False),
    (1, 50, 1, 16, 8, 16, False)])
def test_ssd_scan_matches_chunked_gla(B, S, H, N, P, chunk, state):
    """y and the final state; a nonzero initial state; ragged S (37, 50)
    and S <= chunk (20, 1)."""
    q, k, v, log_a, st = _inputs(B, S, H, N, P, 3 * S + N, state)
    y_r, st_r = jax_ssm.chunked_gla(*(jnp.asarray(x) for x in
                                      (q, k, v, log_a)), chunk,
                                    None if st is None else jnp.asarray(st))
    y, fin = ssd_scan(_t(q), _t(k), _t(v), _t(log_a), chunk, _t(st))
    _scaled_close(y, y_r)
    _scaled_close(fin, st_r)
    y2, fin2 = ssm.chunked_gla(_t(q), _t(k), _t(v), _t(log_a), chunk,
                               _t(st))
    assert torch.equal(y, y2) and torch.equal(fin, fin2)


def test_chunk_cumsum_pads_with_zeros():
    log_a = -torch.rand(2, 10, 3)
    cum = chunk_cumsum(log_a, 4).reshape(2, 3, 3, 4)     # (B, H, nc, L)
    ref = torch.nn.functional.pad(log_a, (0, 0, 0, 2)).reshape(
        2, 3, 4, 3).cumsum(2).permute(0, 3, 1, 2)
    assert torch.allclose(cum, ref)
    assert chunk_cumsum(log_a[:1], 4).is_contiguous()   # what the kernel reads
    assert torch.equal(cum[:, :, 2, 2], cum[:, :, 2, 1])  # decay 1 past S


def test_gla_step_matches_reference():
    q, k, v, log_a, st = _inputs(2, 1, 3, 8, 16, 1, state=True)
    y_r, st_r = jax_ssm.gla_step(*(jnp.asarray(x[:, 0]) for x in
                                   (q, k, v, log_a)), jnp.asarray(st))
    y, st2 = ssm.gla_step(*(_t(x[:, 0]) for x in (q, k, v, log_a)), _t(st))
    _scaled_close(y, y_r)
    _scaled_close(st2, st_r)


@pytest.mark.parametrize("S,chunk", [(24, 8), (13, 8), (6, 8)])
def test_mamba2_forward_and_step_match_reference(S, chunk):
    """mamba2_forward (prefill) and mamba2_step (decode) on the same
    parameters and inputs, in fp32."""
    jcfg = JaxSSMConfig(state_dim=8, conv_width=4, expand=2, chunk=chunk,
                        n_heads=2)
    cfg = SSMConfig(**dataclasses.asdict(jcfg))
    jp = jax_ssm.init_mamba2(jax.random.PRNGKey(S), 32, jcfg, jnp.float32)
    # nonzero A_log / dt_bias / D_skip so every term of the block counts
    rng = np.random.default_rng(S)
    jp = {**jp, **{name: jnp.asarray(rng.standard_normal(2) * 0.5,
                                     jnp.float32)
                   for name in ("A_log", "dt_bias", "D_skip")}}
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    y_r, st_r = jax_ssm.mamba2_forward(jp, jnp.asarray(x), jcfg)
    for backend in ("torch", "cuda"):
        y, st = ssm.mamba2_forward(tp, _t(x), cfg, backend=backend)
        _scaled_close(y, y_r)
        _scaled_close(st, st_r)
    tail = rng.standard_normal((2, 3, 64)).astype(np.float32)
    x1 = x[:, :1]
    y_r, st_r2, tail_r = jax_ssm.mamba2_step(jp, jnp.asarray(x1), jcfg,
                                             st_r, jnp.asarray(tail))
    y, st2, tail2 = ssm.mamba2_step(tp, _t(x1), cfg, st, _t(tail))
    _scaled_close(y, y_r)
    _scaled_close(st2, st_r2)
    _scaled_close(tail2, tail_r)
