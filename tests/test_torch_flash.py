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

The tensor-core kernels' arithmetic is emulated here in torch (the
emulations are part of this test, not of any path): ``flash_fwd_wgmma``
(``csrc/flash_attention_sm90.cu``: bf16 q, k, v; fp32 scores over 128-key
tiles with an online max; P split into bf16 hi + lo for the P V product;
fp32 accumulation; bf16 output) against the reference's
``attention_ref``, and ``flash_fwd_mma`` (``csrc/flash_attention.cu``:
3xTF32 products for fp32, 16-bit products with P split hi + lo for fp16
and bf16, the online softmax over the kernel's key tile) against the
Pallas kernel in interpret mode, at head dims up to 256.
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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     uses_wgmma)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}


def _inputs(B, S, Hq, Hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, d)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]
    if dtype == "bfloat16":       # the same bf16 values on both sides
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    elif dtype == "float16":
        arrs = [a.astype(np.float16) for a in arrs]
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


# ------------------------------------ the tensor-core kernel's numerics
def _emulate_wgmma_kernel(q, k, v, causal, split=True):
    """flash_fwd_wgmma's arithmetic in torch: q (B, S, Hq, d), k, v (B, S,
    Hkv, d) in bf16.  Per 128-key tile: fp32 scores of the bf16 values in
    log2 units, masked at -1e30; an online max and denominator; P =
    exp2(s - m) split into bf16 hi + lo, each times the bf16 V tile
    summed in fp32 (``split=False``: hi only, which the kernel does not
    do).  -> (B, S, Hq, d): fp32 before the output cast."""
    B, S, Hq, d = q.shape
    G = Hq // k.shape[2]
    qf = q.float().transpose(1, 2)                          # (B, Hq, S, d)
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    scale_log2 = np.float32(1.4426950408889634) / np.sqrt(np.float32(d))
    m = torch.full((B, Hq, S, 1), -1e30)
    den = torch.zeros(B, Hq, S, 1)
    acc = torch.zeros(B, Hq, S, d)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, 128):
        keys = torch.arange(k0, min(k0 + 128, S))[None, :]
        s = (qf @ kf[:, :, k0:k0 + 128].transpose(-1, -2)) * float(scale_log2)
        if causal:
            s = torch.where(keys > rows, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        hi = p.bfloat16()
        lo = (p - hi.float()).bfloat16() if split else torch.zeros_like(hi)
        vt = vf[:, :, k0:k0 + 128]
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + hi.float() @ vt + lo.float() @ vt
        m = m_new
    return (acc / den.clamp_min(1e-30)).transpose(1, 2)


def _jax_ref_bshd(q, k, v, causal, dtype):
    """The reference's attention_ref on (B, S, H, d) numpy arrays (KV heads
    repeated over their group) in ``dtype``; -> (B, S, Hq, d) float32."""
    B, S, Hq, d = q.shape
    G = Hq // k.shape[2]
    fold = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(
        B * Hq, S, d), dtype)
    out = jax_attn_ref(fold(q), fold(np.repeat(k, G, 2)),
                       fold(np.repeat(v, G, 2)), causal=causal)
    return np.asarray(out, np.float32).reshape(B, Hq, S, d).transpose(
        0, 2, 1, 3)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), for x != 0."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.exp2(e - 7).astype(np.float32)


@pytest.mark.parametrize("B,S,Hq,Hkv,d,causal", [
    (2, 256, 4, 2, 64, True), (1, 200, 4, 2, 64, False),
    (2, 129, 6, 3, 128, True), (1, 1, 2, 1, 64, True),
    (1, 1, 2, 2, 128, False), (1, 300, 2, 1, 128, False),
    (1, 384, 8, 2, 64, True), (3, 77, 4, 4, 64, True)])
def test_wgmma_numerics_scheme_matches_reference(B, S, Hq, Hkv, d, causal):
    """fp32 before the cast within 1e-5 of max(|ref|, 1).  After the bf16
    cast: no further from the fp32 reference than the reference's own
    bf16 rounding plus one bf16 ulp (at the output's largest magnitude),
    and each element at most one bf16 rounding step from the reference's
    bf16 output (plus the fp32 allowance, for elements near zero)."""
    (q, k, v), (tq, tk, tv) = _inputs(B, S, Hq, Hkv, d, "bfloat16",
                                      3 * S + d)
    arrs = [np.asarray(x, np.float32) for x in (q, k, v)]
    ref32 = _jax_ref_bshd(*arrs, causal, jnp.float32)
    ref16 = _jax_ref_bshd(*arrs, causal, jnp.bfloat16)
    emu32 = _emulate_wgmma_kernel(tq, tk, tv, causal).numpy()
    tol32 = 1e-5 * max(np.abs(ref32).max(), 1.0)
    assert np.abs(emu32 - ref32).max() <= tol32
    emu16 = torch.from_numpy(emu32).bfloat16().float().numpy()
    own = np.abs(ref16 - ref32).max()
    assert (np.abs(emu16 - ref32).max()
            <= own + _bf16_ulp(np.abs(ref32).max()))
    assert (np.abs(emu16 - ref16) <= _bf16_ulp(ref32) + tol32).all()


def test_wgmma_numerics_need_the_lo_term():
    """The hi + lo split is what keeps P fp32 in meaning: with P as one
    bf16 term the error before the cast is far above 1e-5."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 512, 2, 1, 64, "bfloat16", 9)
    ref32 = _jax_ref_bshd(*[np.asarray(x, np.float32) for x in (q, k, v)],
                          True, jnp.float32)
    split = _emulate_wgmma_kernel(tq, tk, tv, True).numpy()
    single = _emulate_wgmma_kernel(tq, tk, tv, True, split=False).numpy()
    assert np.abs(split - ref32).max() <= 1e-5
    assert np.abs(single - ref32).max() > 1e-4


@pytest.mark.parametrize("dtype,d,expect", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 96, False), (torch.bfloat16, 32, False),
    (torch.float16, 64, False), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.bfloat16, 256, False),
    (torch.float16, 256, False), (torch.float32, 256, False),
    (torch.bfloat16, 257, None), (torch.float32, 257, None)])
def test_flash_dispatch_by_dtype_and_head_dim(dtype, d, expect):
    """bf16 at d 64 / 128 runs flash_fwd_wgmma, every other case up to d
    256 flash_fwd_mma; d > 256 raises before any launch (``expect``
    None)."""
    q = torch.zeros(1, 8, 8, d, dtype=dtype)
    k = v = torch.zeros(1, 8, 1, d, dtype=dtype)
    if expect is None:
        with pytest.raises(ValueError, match=f"head_dim {d} not in"):
            fa_ops._launch(q, k, v, True)
        return
    assert uses_wgmma(dtype, d) is expect
    assert d <= fa_ops.MAX_HEAD_DIM == 256
    if not expect:
        bq, bk = fa_ops.mma_tiles(dtype, d)
        assert bq % 16 == 0 and bk % 16 == 0


# ------------------------------------- flash_fwd_mma's numerics
def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away
    from zero, on the 13 dropped mantissa bits); tests/test_torch_ssd.py's
    helper."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b, split=True):
    """a @ b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32 (one
    TF32 pass with ``split=False``)."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _emulate_mma_kernel(q, k, v, causal, split=True):
    """flash_fwd_mma's arithmetic in torch: q (B, S, Hq, d), k, v (B, S,
    Hkv, d).  Per key tile of ``ops.mma_tiles``' width: fp32 scores (3xTF32
    products for fp32 inputs; exact products of 16-bit values otherwise)
    times log2(e)/sqrt(d), masked at -1e30; an online max and denominator;
    P = exp2(s - m); O += P V in 3xTF32 (fp32), or as P_hi V + P_lo V with P
    split into two values of the input type (fp16, bf16).  ``split=False``
    (which the kernel does not do): one TF32 pass, or P as one 16-bit
    value.  -> (B, S, Hq, d) in fp32, before the output cast."""
    B, S, Hq, d = q.shape
    G = Hq // k.shape[2]
    dt = q.dtype
    bk = fa_ops.mma_tiles(dt, d)[1]
    qf = q.float().transpose(1, 2)                          # (B, Hq, S, d)
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    scale = float(np.float32(1.4426950408889634) / np.sqrt(np.float32(d)))
    m = torch.full((B, Hq, S, 1), -1e30)
    den = torch.zeros(B, Hq, S, 1)
    acc = torch.zeros(B, Hq, S, d)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        keys = torch.arange(k0, min(k0 + bk, S))[None, :]
        kt = kf[:, :, k0:k0 + bk].transpose(-1, -2)
        vt = vf[:, :, k0:k0 + bk]
        s = (_mm3(qf, kt, split) if dt == torch.float32 else qf @ kt) * scale
        if causal:
            s = torch.where(keys > rows, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        if dt == torch.float32:
            pv = _mm3(p, vt, split)
        else:
            hi = p.to(dt)
            lo = (p - hi.float()).to(dt) if split else torch.zeros_like(hi)
            pv = hi.float() @ vt + lo.float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / den.clamp_min(1e-30)).transpose(1, 2)


@pytest.mark.parametrize("d", [32, 96, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_mma_numerics_scheme_matches_pallas(d, dtype, causal):
    """The emulation of flash_fwd_mma against the Pallas kernel in
    interpret mode, MQA (one KV head): 2e-5 in fp32, 2e-2 for 16-bit
    inputs (the output in the input type), as for the wgmma scheme.  At d
    256 the key tile is 32 wide, so S = 128 spans four tiles."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 128, 2, 1, d, dtype, d + len(dtype))
    ref = np.asarray(jax_flash(q, k, v, causal=causal, interpret=True),
                     np.float32)
    emu = _emulate_mma_kernel(tq, tk, tv, causal)
    tol = TOL[dtype]
    _close(emu.to(tq.dtype), ref, tol)
    if dtype == "float32":
        assert np.abs(emu.numpy() - ref).max() <= 1e-5 * max(
            np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mma_numerics_need_the_split(dtype):
    """One TF32 pass (fp32) or P as one bf16 value is far from the fp32
    reference before the output cast; the kernel's splits are within
    1e-5."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 256, 2, 1, 128, dtype, 4)
    ref32 = _jax_ref_bshd(*[np.asarray(x, np.float32) for x in (q, k, v)],
                          True, jnp.float32)
    split = _emulate_mma_kernel(tq, tk, tv, True).numpy()
    single = _emulate_mma_kernel(tq, tk, tv, True, split=False).numpy()
    assert np.abs(split - ref32).max() <= 1e-5
    assert np.abs(single - ref32).max() > 1e-4
