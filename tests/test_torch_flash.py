"""The port's attention against the JAX reference on the CPU.

``repro_torch.kernels.flash_attention.ops.flash_attention`` on CPU tensors
is its plain version (``attention_ref``); both are held against the
Pallas kernel in interpret mode, the reference's ``attention_ref``, the
model's ``chunked_attention`` and ``gqa_attention``, including GQA and a
ragged S.  The port's own plain
``gqa_attention`` / ``chunked_attention`` / ``decode_attention`` are held
against the reference's too.  Bars (tests/test_kernels.py): 2e-5 in fp32,
the per-dtype TOL (2e-2) for bf16 inputs.  The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models import attention as jax_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, Hq, Hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, d)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]
    if dtype == "bfloat16":       # the same bf16 values on both sides
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    tdt = getattr(torch, dtype)
    jx = [jnp.asarray(a) for a in arrs]
    th = [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs]
    return jx, th


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(ref, np.float32),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,d", [(2, 256, 4, 2, 64),
                                          (1, 128, 2, 1, 128),
                                          (1, 384, 6, 3, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_pallas_interpret(B, S, Hq, Hkv, d, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(B, S, Hq, Hkv, d, dtype, B * S + Hq)
    ref = jax_flash(q, k, v, causal=True, interpret=True)
    for backend in ("torch", "cuda"):        # "cuda" on CPU tensors: plain
        got = flash_attention(tq, tk, tv, backend=backend)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _close(got, ref, TOL[dtype])


def test_flash_matches_attention_ref_and_chunked_path():
    """The kernel and the model's chunked attention agree (the port's twin
    of test_flash_matches_model_attention_path), chunk 128 at S = 256."""
    (q, k, v), (tq, tk, tv) = _inputs(2, 256, 4, 2, 64, "float32", 5)
    got = flash_attention(tq, tk, tv)
    _close(got, jax_attention.chunked_attention(q, k, v, chunk=128), 2e-5)
    G = 2
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(8, 256, 64)
    bh = jax_attn_ref(fold(q), fold(jnp.repeat(k, G, 2)),
                      fold(jnp.repeat(v, G, 2)))
    bh = np.asarray(bh).reshape(2, 4, 256, 64).transpose(0, 2, 1, 3)
    _close(got, bh, 2e-5)
    _close(attention_ref(tq, tk, tv), bh, 2e-5)


@pytest.mark.parametrize("B,S,Hq,Hkv,d", [(2, 37, 4, 2, 16),
                                          (1, 1, 2, 1, 64),
                                          (3, 100, 6, 6, 32),
                                          (1, 129, 8, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gqa_ragged_matches_gqa_attention(B, S, Hq, Hkv, d, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(B, S, Hq, Hkv, d, dtype, 7 * S + d)
    ref = jax_attention.gqa_attention(q, k, v, causal=True)
    _close(flash_attention(tq, tk, tv), ref, TOL[dtype])
    _close(attention.gqa_attention(tq, tk, tv, causal=True), ref,
           TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mixed", [False, True])
def test_plain_attention_twins(causal, mixed):
    (q, k, v), (tq, tk, tv) = _inputs(2, 64, 4, 2, 16, "bfloat16", 3)
    tol = TOL["bfloat16"]
    _close(attention.gqa_attention(tq, tk, tv, causal=causal, mixed=mixed),
           jax_attention.gqa_attention(q, k, v, causal=causal, mixed=mixed),
           tol)
    _close(attention.chunked_attention(tq, tk, tv, chunk=16, causal=causal,
                                       mixed=mixed),
           jax_attention.chunked_attention(q, k, v, chunk=16, causal=causal,
                                           mixed=mixed), tol)
    _close(flash_attention(tq, tk, tv, causal=causal),
           jax_attention.gqa_attention(q, k, v, causal=causal), tol)


def test_decode_attention_matches_reference():
    (q, k, v), (tq, tk, tv) = _inputs(2, 24, 4, 2, 16, "float32", 11)
    for pos in (0, 9, 23):
        ref = jax_attention.decode_attention(q[:, pos:pos + 1], k, v, pos)
        got = attention.decode_attention(tq[:, pos:pos + 1], tk, tv, pos)
        _close(got, ref, 2e-5)
        # the last query row of full causal attention over [0..pos]
        _close(got[:, 0], flash_attention(tq[:, :pos + 1], tk[:, :pos + 1],
                                          tv[:, :pos + 1])[:, -1], 2e-5)


def test_flash_backend_is_checked():
    _, (tq, tk, tv) = _inputs(1, 8, 2, 1, 8, "float32", 0)
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, backend="xla")
    assert jax.default_backend() == "cpu"
