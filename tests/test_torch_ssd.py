"""The port's Mamba2 / SSD scan against the JAX reference on the CPU.

``repro_torch.kernels.mamba2_scan.ops.ssd_scan`` on CPU tensors is its
plain version; it is held against the Pallas kernel in interpret mode,
``gla_ref`` and ``chunked_gla`` (y and the final state), with a nonzero
initial state and a ragged S.  ``mamba2_forward`` / ``mamba2_step`` and
``gla_step`` are held against the reference's on the same parameters.
Bar (tests/test_kernels.py:222-240): 1e-4 scaled by max(|ref|, 1).  The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py).

The CUDA kernel's arithmetic (``csrc/mamba2_scan.cu``: q kᵀ scores, chunk
states, the state chain, chunk outputs with the decay factored off the
diagonal 64-row tile; every product in 3xTF32, operands rounded to TF32 as
``cvt.rna`` rounds; the depth N of q kᵀ and q S_inᵀ walked in 64-wide
tiles, each summed on its own and added in fp32) is emulated here in
torch and held against the JAX package (the emulation is part of this
test, not of any path), at zamba2's N 64 and at state dims past one tile
(up to xLSTM's 1024), per-head q and k and odd P (xLSTM's values plus
the normalizer channel), on the mLSTM's own gates too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mamba2_scan.kernel import mamba2_chunk_scan
from repro.kernels.mamba2_scan.ref import gla_ref
from repro.models import ssm as jax_ssm
from repro.models.config import SSMConfig as JaxSSMConfig
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
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


@pytest.mark.parametrize("B,S,H,P", [(2, 5, 3, 1025), (1, 4, 2, 33),
                                     (3, 1, 1, 6), (1, 6, 1, 1025)])
def test_pitched_v_is_read_in_place(B, S, H, P):
    """``pitched`` rows sit at P rounded up to 4 floats, the pitch the
    wrapper reads in place; a contiguous v has pitch P (the wrapper pads
    it if P is not a multiple of 4), a v of any other layout none (the
    wrapper rejects it).  The plain version gives the same y and state
    on a pitched v as on a contiguous one."""
    ld = -(-P // 4) * 4
    q, k, v, log_a, st = (None if x is None else torch.from_numpy(x)
                          for x in _inputs(B, S, H, 8, P, 0, state=True))
    vp = ssd_ops.pitched(B, S, H, P)
    vp.copy_(v)
    assert vp.shape == v.shape and ssd_ops._row_pitch(vp) == ld
    assert ssd_ops._row_pitch(v) == P
    if S > 1 and H > 1:
        assert ssd_ops._row_pitch(v.transpose(1, 2).contiguous()
                                  .transpose(1, 2)) is None
    y, fin = ssd_scan(q, k, v, log_a, 4, st)
    y_p, fin_p = ssd_scan(q, k, vp, log_a, 4, st)
    assert torch.equal(y, y_p) and torch.equal(fin, fin_p)


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


# ------------------------------------------ the CUDA kernel's numerics
def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away
    from zero, on the 13 dropped mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, split=True):
    """a @ b on the tensor cores: 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi
    summed in fp32), or one TF32 pass with ``split=False``."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_n(a, b, split=True):
    """a @ b with the contraction (the state dim N) walked in 64-wide
    tiles, as passes 1 and 4 walk it: each tile's product on its own,
    the tiles added in fp32."""
    return sum(_mm(a[..., n0:n0 + 64], b[..., n0:n0 + 64, :], split)
               for n0 in range(0, a.shape[-1], 64))


def _emulate_kernel(q, k, v, log_a, chunk, state=None, split=True):
    """The four passes of csrc/mamba2_scan.cu in torch, q, k: (B, S, H, N);
    v: (B, S, H, P); log_a: (B, S, H); state: (B, H, P, N) or None.
    -> y (B, S, H, P) and the final state."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    nc = -(-S // chunk)
    fold = lambda x: F.pad(x.float(), (0, 0, 0, 0, 0, nc * chunk - S)) \
        .reshape(B, nc, chunk, H, -1).permute(0, 3, 1, 2, 4)
    qc, kc, vc = fold(q), fold(k), fold(v)             # (B, H, nc, L, .)
    cum = chunk_cumsum(log_a, chunk).reshape(B, H, nc, chunk)
    G = _mm_n(qc, kc.transpose(-1, -2), split)         # pass 1
    w = torch.exp(cum[..., -1:] - cum)                 # pass 2
    dS = _mm((vc * w[..., None]).transpose(-1, -2), kc, split)
    x = torch.zeros(B, H, P, N) if state is None else state.float()
    s_in = []                                          # pass 3
    for c in range(nc):
        s_in.append(x)
        x = x * torch.exp(cum[:, :, c, -1])[..., None, None] + dS[:, :, c]
    s_in = torch.stack(s_in, 2)
    y = torch.empty(B, H, nc, chunk, P)                # pass 4
    for t0 in range(0, chunk, 64):
        t1 = min(t0 + 64, chunk)
        ct, c0 = cum[..., t0:t1], cum[..., t0:t0 + 1]
        acc = _mm_n(qc[..., t0:t1, :], s_in.transpose(-1, -2), split) \
            * torch.exp(c0)[..., None]
        if t0:       # off the diagonal tile: a[t] b[s], both <= 1
            b = torch.exp(c0 - cum[..., :t0])
            acc = acc + _mm(G[..., t0:t1, :t0] * b[..., None, :],
                            vc[..., :t0, :], split)
        acc = acc * torch.exp(ct - c0)[..., None]
        tri = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool).tril()
        M = torch.where(tri, torch.exp(ct[..., :, None] - ct[..., None, :]),
                        0.0)
        y[..., t0:t1, :] = acc + _mm(G[..., t0:t1, t0:t1] * M,
                                     vc[..., t0:t1, :], split)
    return y.permute(0, 2, 3, 1, 4).reshape(B, nc * chunk, H, P)[:, :S], x


def _shared_inputs(B, S, H, N, P, seed, shared, state):
    """q and k broadcast over the heads (as mamba2_forward passes them) or
    per head; log decay -softplus(.) as the model's."""
    rng = np.random.default_rng(seed)
    hq = 1 if shared else H
    q = np.broadcast_to(rng.standard_normal((B, S, hq, N)), (B, S, H, N))
    k = np.broadcast_to(rng.standard_normal((B, S, hq, N)), (B, S, H, N))
    v = rng.standard_normal((B, S, H, P))
    log_a = -np.logaddexp(0.0, rng.standard_normal((B, S, H)))
    st = rng.standard_normal((B, H, P, N)) if state else None
    return [None if x is None else np.ascontiguousarray(x, np.float32)
            for x in (q, k, v, log_a, st)]


@pytest.mark.parametrize("B,S,H,N,P,chunk,shared,state", [
    (1, 512, 2, 64, 256, 256, True, False),    # serving widths, shorter S
    (2, 256, 2, 16, 32, 64, False, False),
    (2, 300, 3, 64, 96, 128, True, True),      # ragged, initial state
    (1, 100, 2, 50, 100, 100, False, True),    # S <= chunk, N 50, P 100
    (2, 1, 2, 8, 16, 256, True, True),         # S = 1
    (1, 200, 2, 8, 64, 64, False, True),
    # past one tile of N: per-head q and k, odd P (values + normalizer)
    (1, 128, 2, 130, 131, 64, False, True),    # N 130: a ragged third tile
    (2, 70, 2, 200, 201, 32, False, False),    # ragged S, N 200
    (1, 64, 1, 1024, 33, 64, False, True),     # xLSTM's N, 16 tiles
    (1, 96, 2, 100, 65, 256, True, True)])     # S <= chunk, shared
def test_kernel_numerics_scheme_matches_reference(B, S, H, N, P, chunk,
                                                  shared, state):
    """y and the final state within 1e-4 of max(|ref|, 1) of the JAX
    package's chunked_gla, and of the Pallas kernel (interpret mode) where
    it applies (S a multiple of the chunk, no initial state); within 1e-5
    of the port's plain version, which takes the same cumulative sums."""
    q, k, v, log_a, st = _shared_inputs(B, S, H, N, P, S + N + P, shared,
                                        state)
    y, fin = _emulate_kernel(_t(q), _t(k), _t(v), _t(log_a), chunk, _t(st))
    y_r, st_r = jax_ssm.chunked_gla(*(jnp.asarray(x) for x in
                                      (q, k, v, log_a)), chunk,
                                    None if st is None else jnp.asarray(st))
    _scaled_close(y, y_r)
    _scaled_close(fin, st_r)
    if st is None and S % chunk == 0:
        fold = lambda x: jnp.asarray(np.moveaxis(x, 2, 1).reshape(
            (B * H, S) + x.shape[3:]))
        ref = mamba2_chunk_scan(fold(q), fold(k), fold(v), fold(log_a),
                                chunk=chunk, interpret=True)
        _scaled_close(y.permute(0, 2, 1, 3).reshape(B * H, S, P), ref)
    y_p, fin_p = ssd_scan(_t(q), _t(k), _t(v), _t(log_a), chunk, _t(st))
    _scaled_close(y, y_p, 1e-5)
    _scaled_close(fin, fin_p, 1e-5)


@pytest.mark.parametrize("S,state", [(200, False), (160, True)])
def test_kernel_numerics_on_mlstm_inputs(S, state):
    """The mLSTM's scan inputs (``models/ssm.py::_mlstm_core``): per-head
    q and k / sqrt(P), v scaled by the input gate exp(clip(., -10, 5))
    plus the gate itself as a normalizer channel (P + 1 = 129 columns),
    log decay logsigmoid(.), N = P = 128 (two tiles of N); y and the
    final state within 1e-4 of max(|ref|, 1) of the JAX chunked_gla."""
    rng = np.random.default_rng(S)
    B, H, P, chunk = 2, 2, 128, 64
    q = rng.standard_normal((B, S, H, P))
    k = rng.standard_normal((B, S, H, P)) / np.sqrt(P)
    v = rng.standard_normal((B, S, H, P))
    gates = rng.standard_normal((B, S, 2 * H)) * 3.0
    i_g = np.exp(np.clip(gates[..., :H], -10.0, 5.0))
    log_f = -np.logaddexp(0.0, -gates[..., H:])
    v_aug = np.concatenate([v * i_g[..., None], i_g[..., None]], -1)
    st = rng.standard_normal((B, H, P + 1, P)) * 0.3 if state else None
    args = [None if x is None else np.ascontiguousarray(x, np.float32)
            for x in (q, k, v_aug, log_f, st)]
    y, fin = _emulate_kernel(*map(_t, args[:4]), chunk, _t(args[4]))
    y_r, st_r = jax_ssm.chunked_gla(*(jnp.asarray(x) for x in args[:4]),
                                    chunk, None if st is None
                                    else jnp.asarray(args[4]))
    _scaled_close(y, y_r)
    _scaled_close(fin, st_r)


def test_kernel_numerics_need_the_split():
    """The 3xTF32 split is what keeps the fp32 contract: at zamba2's N 64,
    P 256, chunk 256, one TF32 pass misses the 1e-4 bar."""
    q, k, v, log_a, _ = _shared_inputs(1, 512, 2, 64, 256, 0, True, False)
    args = (_t(q), _t(k), _t(v), _t(log_a), 256)
    y_r, st_r = jax_ssm.chunked_gla(*(jnp.asarray(x) for x in
                                      (q, k, v, log_a)), 256)
    scaled = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                                / max(float(np.abs(np.asarray(b)).max()),
                                      1.0))
    y3, st3 = _emulate_kernel(*args)
    y1, st1 = _emulate_kernel(*args, split=False)
    assert scaled(y3, y_r) <= 1e-4 and scaled(st3, st_r) <= 1e-4
    assert scaled(y1, y_r) > 1e-4
