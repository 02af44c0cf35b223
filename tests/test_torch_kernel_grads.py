"""The flash and scan kernels under autograd, rehearsed on the CPU.

On CUDA tensors ``flash_attention`` and ``ssd_scan`` run their kernels
through ``torch.autograd.Function``s (``fa_ops._Flash``, ``ssd_ops._Scan``):
the forward launches the kernel, the backward differentiates the plain
version recomputed from the saved inputs.  The kernels run only on the
card (``tests/test_torch_cuda.py``); here each ``_launch`` is replaced by
its plain version, so what is held is the Function around it: gradients
of the caller's shapes and strides (the scan's q and k broadcast over
heads, its pitched v, a carried-in state or none) equal to plain
autograd's, and, inside a remat'd model, one more forward a repetition
of the unit.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.nn import tree_leaves, value_and_grad
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan.ref import ssd_scan_ref
from repro_torch.models import transformer
from repro_torch.train.data import DataConfig, SyntheticTokenStream

TOL = 1e-6       # the same plain arithmetic on both sides, in another order


@pytest.fixture
def plain_launches(monkeypatch):
    """Each ``_launch`` replaced by its plain version, counting calls;
    ``flash_attention`` and ``ssd_scan`` sent through their Functions
    on the CPU, as on the card."""
    calls = {"flash": 0, "scan": 0}

    def flash(q, k, v, causal):
        calls["flash"] += 1
        return attention_ref(q, k, v, causal)   # the kernel's fp32-P mode

    def scan(q, k, v, log_a, chunk, state):
        calls["scan"] += 1
        return ssd_scan_ref(q, k, v, log_a, chunk, state)
    monkeypatch.setattr(fa_ops, "_launch", flash)
    monkeypatch.setattr(ssd_ops, "_launch", scan)
    monkeypatch.setattr(
        fa_ops, "flash_attention",
        lambda q, k, v, causal=True, backend="cuda", mixed=False:
        attention_ref(q, k, v, causal, mixed) if backend == "torch" else
        fa_ops._Flash.apply(q, k, v, causal, mixed))
    monkeypatch.setattr(
        ssd_ops, "ssd_scan",
        lambda q, k, v, log_a, chunk, state=None, backend="cuda":
        ssd_scan_ref(q, k, v, log_a, chunk, state) if backend == "torch"
        else ssd_ops._Scan.apply(q, k, v, log_a, chunk, state))
    return calls


def _close(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) <= TOL * max(float(b.abs().max()), 1)


@pytest.mark.parametrize("Hq,Hkv,d,causal", [(4, 4, 16, True),
                                             (4, 1, 32, True),
                                             (6, 2, 8, False)])
def test_flash_function_gradient_is_the_plain_one(plain_launches, Hq, Hkv,
                                                  d, causal):
    gen = torch.Generator().manual_seed(0)
    q0, k0, v0 = (torch.randn(2, 13, h, d, generator=gen)
                  for h in (Hq, Hkv, Hkv))
    g = torch.randn(2, 13, Hq, d, generator=gen)
    grads = []
    for fn in (lambda q, k, v: fa_ops._Flash.apply(q, k, v, causal),
               lambda q, k, v: attention_ref(q, k, v, causal)):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        out = fn(q, k, v)
        out.backward(g)
        grads.append((out, q.grad, k.grad, v.grad))
    assert plain_launches["flash"] == 1
    assert all(_close(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("shared,with_state,P", [(True, False, 8),
                                                 (True, True, 8),
                                                 (False, True, 9),
                                                 (False, False, 9)])
def test_scan_function_gradient_is_the_plain_one(plain_launches, shared,
                                                 with_state, P):
    """q and k as mamba2_forward passes them (one (B, S, N) tensor
    broadcast over the heads, stride 0) or per head; v contiguous or, at
    a P off the kernel's pitch, built in ``ssd_ops.pitched`` as the
    mLSTM does; a carried-in state or none.  Gradients reach each
    caller's leaf in its own shape."""
    B, S, H, N, chunk = 2, 21, 3, 5, 8
    gen = torch.Generator().manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen)
    leaves = {"q": rnd(B, S, N) if shared else rnd(B, S, H, N),
              "k": rnd(B, S, N) if shared else rnd(B, S, H, N),
              "v": rnd(B, S, H, P), "log_a": -rnd(B, S, H).abs(),
              "state": rnd(B, H, P, N)}
    gy, gst = rnd(B, S, H, P), rnd(B, H, P, N)
    results = []
    for fn in (lambda *a: ssd_ops._Scan.apply(*a[:4], chunk, a[4]),
               lambda *a: ssd_scan_ref(*a[:4], chunk, a[4])):
        x = {k: t.clone().requires_grad_() for k, t in leaves.items()}
        q, k = ((x[n][:, :, None].expand(B, S, H, N) if shared else x[n])
                for n in ("q", "k"))
        v = ssd_ops.pitched(B, S, H, P)
        v[...] = x["v"] * 1.0
        y, st = fn(q, k, v, x["log_a"], x["state"] if with_state else None)
        torch.autograd.backward((y, st), (gy, gst))
        results.append((y, st, *(x[n].grad for n in
                                 ("q", "k", "v", "log_a"))) +
                       ((x["state"].grad,) if with_state else ()))
    assert plain_launches["scan"] == 1
    for a, b in zip(*results):
        assert a.shape == b.shape and _close(a, b)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_1p3b"])
def test_model_gradients_through_the_functions(plain_launches, arch):
    """Reduced zamba2 and xLSTM with remat: ``lm_loss``'s gradients through
    the Functions equal the plain path's, and under remat each kernel of
    a repetition of the unit runs forward twice (the recompute), the
    remainder's once."""
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True,
                              compute_dtype="float32")
    params = transformer.init_params(cfg, 0, device="cpu")
    batch = SyntheticTokenStream(cfg, DataConfig(24, 2), "cpu").next_batch()
    (va, _), ga = value_and_grad(
        lambda p: transformer.lm_loss(p, cfg, batch, attn_backend="cuda",
                                      ssm_backend="cuda"),
        params, has_aux=True)
    counts = dict(plain_launches)
    (vb, _), gb = value_and_grad(
        lambda p: transformer.lm_loss(p, cfg, batch, attn_backend="torch",
                                      ssm_backend="torch"),
        params, has_aux=True)
    assert dict(plain_launches) == counts       # the plain path: no launch
    assert float(va) == pytest.approx(float(vb), rel=1e-6)
    assert all(_close(a, b) for a, b in zip(tree_leaves(ga),
                                             tree_leaves(gb)))
    unit, reps, rem = transformer.unit_and_reps(cfg)
    scans = ("mamba", "mlstm")
    want = {"flash": 2 * reps * unit.count("attn_shared"),
            "scan": 2 * reps * sum(unit.count(k) for k in scans)
            + sum(rem.count(k) for k in scans)}
    assert counts == want and counts["scan"] > 0


def test_plain_scan_gradient_is_finite_where_the_decay_overflows():
    """Above the chunk's diagonal exp(cum[t] - cum[s]) overflows once the
    log decay falls by more than ~88 along a chunk (zamba2's chunk of 256
    falls by ~180).  The plain version masks before the exp, so its
    forward is unchanged and its gradient stays finite, equal to the
    float64 one (where nothing overflows)."""
    B, S, H, N, P, chunk = 1, 64, 2, 4, 3, 64
    gen = torch.Generator().manual_seed(2)
    q, k = (torch.randn(B, S, H, N, generator=gen) for _ in range(2))
    v = torch.randn(B, S, H, P, generator=gen)
    log_a = torch.full((B, S, H), -3.0)             # cum falls to -192
    grads = []
    for dt in (torch.float32, torch.float64):
        x = [t.to(dt, copy=True).requires_grad_() for t in (q, k, v, log_a)]
        y, st = ssd_scan_ref(*x, chunk)
        (y.sum() + st.sum()).backward()
        grads.append([t.grad for t in x])
        assert all(bool(torch.isfinite(g).all()) for g in grads[-1])
    for a, b in zip(*grads):
        assert float((a.double() - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1.0)
