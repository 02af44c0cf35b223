"""State-space / recurrent blocks (twin of ``repro/models/ssm.py``):
Mamba2 (SSD), mLSTM, sLSTM.

Mamba2 and mLSTM are both gated linear attention: a (P, N) matrix state
per head, decayed by a scalar gate and updated by v kᵀ.  The chunked scan
core (``chunked_gla``, plain) lives beside its kernel in
``kernels/mamba2_scan/ref.py`` and is re-exported here; prefill of both
runs the kernel through ``kernels/mamba2_scan/ops.py::ssd_scan``.  Decode
(``*_step``) carries O(1) state and runs the plain ``gla_step``, as the
reference's decode has no kernel either.

sLSTM keeps the exponential-gated scalar recurrence with the
max-stabilizer, which is sequential: a Python loop over time (the
reference's ``lax.scan``), in plain PyTorch; each step makes new
tensors, so autograd differentiates it as it is.  No TPU kernel stands behind
it, and none is ported here.

The reference's simplifications are kept: Mamba2's short causal conv is
applied to the input branch only; mLSTM omits the per-step
max-stabilizer in the chunked path; sLSTM has per-head recurrent weights
with a single projection block.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..core.nn import at_least_f32, scan
from ..kernels.mamba2_scan import ops as ssd_ops
from ..kernels.mamba2_scan.ref import _chunk_gla, chunked_gla  # noqa: F401
from ..parallel.annotate import BATCH, constrain, get_mesh
from .common import _normal, dense_init
from .config import SSMConfig


def gla_step(q, k, v, log_a, state):
    """Single-token recurrence.  q, k: (B, H, N); v: (B, H, P); log_a:
    (B, H); state: (B, H, P, N)."""
    a = torch.exp(log_a)[:, :, None, None]
    state = state * a + torch.einsum("bhp,bhn->bhpn", v, k)
    y = torch.einsum("bhn,bhpn->bhp", q, state)
    return y, state


# ----------------------------------------------------------------- Mamba2
def init_mamba2(gen: torch.Generator, d_model: int, cfg: SSMConfig,
                dtype=torch.float32) -> dict:
    di = cfg.expand * d_model
    H, N = cfg.n_heads, cfg.state_dim
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        # in_proj emits [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": dense_init(gen, d_model, 2 * di + 2 * N + H, dtype),
        "conv": _normal(gen, (cfg.conv_width, di), dtype) * 0.2,
        "A_log": torch.zeros(H, **f32),
        "dt_bias": torch.zeros(H, **f32),
        "D_skip": torch.ones(H, **f32),
        "w_out": dense_init(gen, di, d_model, dtype),
    }


def _causal_conv(x, w):
    """x: (B, S, di); w: (W, di) depthwise causal conv."""
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(W))


def _split_proj(proj, di: int, N: int, H: int):
    """[z, x, B, C, dt] of the input projection."""
    return proj.split([di, di, N, N, H], dim=-1)


def mamba2_forward(params, x, cfg: SSMConfig, state=None,
                   backend: str = "cuda", local_gla: bool = False):
    """x: (B, S, D) -> (B, S, D) and the final SSD state (B, H, P, N).
    ``state``: the carried SSD state, or None for zeros.  The scan runs
    the ``mamba2_scan`` kernel on the card (``backend="cuda"``); q and k
    are one (B, S, N) tensor each, broadcast over the heads as views.
    ``local_gla``: constrain the scan's inputs to batch x head sharding on
    a mesh (the reference's option; no-op without one)."""
    B, S, D = x.shape
    di = cfg.expand * D
    H, N = cfg.n_heads, cfg.state_dim
    P = di // H
    z, xin, Bs, Cs, dt = _split_proj(x @ params["w_in"], di, N, H)
    xin = F.silu(_causal_conv(xin, params["conv"]))
    dt = F.softplus(at_least_f32(dt) + params["dt_bias"])    # (B, S, H)
    log_a = dt * -torch.exp(params["A_log"])                 # <= 0
    xh = at_least_f32(xin.reshape(B, S, H, P))
    u = xh * dt[..., None]
    kq = at_least_f32(Bs)[:, :, None, :].expand(B, S, H, N)
    qq = at_least_f32(Cs)[:, :, None, :].expand(B, S, H, N)
    if local_gla:
        spec = (BATCH, None, "model", None)
        u = constrain(u, *spec)
        kq = constrain(kq, *spec)
        qq = constrain(qq, *spec)
        log_a = constrain(log_a, BATCH, None, "model")
    y, st = ssd_ops.ssd_scan(qq, kq, u, log_a, cfg.chunk, state,
                             backend=backend)
    y = y + params["D_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, di).to(x.dtype) * F.silu(z)
    return y @ params["w_out"], st


def mamba2_step(params, x, cfg: SSMConfig, state, conv_tail):
    """Decode one token.  x: (B, 1, D); state: (B, H, P, N); conv_tail:
    (B, W-1, di) previous conv inputs."""
    B, _, D = x.shape
    di = cfg.expand * D
    H, N = cfg.n_heads, cfg.state_dim
    P = di // H
    z, xin, Bs, Cs, dt = _split_proj(x[:, 0] @ params["w_in"], di, N, H)
    hist = torch.cat([conv_tail, xin[:, None, :]], dim=1)    # (B, W, di)
    xin = F.silu(torch.einsum("bwd,wd->bd", hist, params["conv"]))
    dt = F.softplus(at_least_f32(dt) + params["dt_bias"])    # (B, H)
    log_a = dt * -torch.exp(params["A_log"])
    xh = at_least_f32(xin.reshape(B, H, P))
    k = at_least_f32(Bs)[:, None, :].expand(B, H, N)
    q = at_least_f32(Cs)[:, None, :].expand(B, H, N)
    y, state = gla_step(q, k, xh * dt[..., None], log_a, state)
    y = y + params["D_skip"][None, :, None] * xh
    y = y.reshape(B, di).to(x.dtype) * F.silu(z)
    return (y @ params["w_out"])[:, None, :], state, hist[:, 1:]


# ------------------------------------------------------------------ mLSTM
def init_mlstm(gen: torch.Generator, d_model: int, cfg: SSMConfig,
               dtype=torch.float32) -> dict:
    di = cfg.expand * d_model
    H = cfg.n_heads
    return {
        "w_in": dense_init(gen, d_model, 2 * di, dtype),      # x and z-gate
        "w_q": dense_init(gen, di, di, dtype),
        "w_k": dense_init(gen, di, di, dtype),
        "w_v": dense_init(gen, di, di, dtype),
        "w_if": dense_init(gen, di, 2 * H, dtype),            # i, f gates
        "w_out": dense_init(gen, di, d_model, dtype),
    }


def _mlstm_core(params, xin, cfg: SSMConfig, B: int, S: int, di: int,
                state, step: bool, backend: str = "cuda",
                local_gla: bool = False):
    """q, k (k / sqrt(P)) and v per head in fp32, the input gate
    exp(clip(., -10, 5)) and the log forget gate logsigmoid(.); v is
    extended by a channel of the input gate that carries the normalizer
    n, so the scan's state is (B, H, P + 1, P).  Prefill runs ``ssd_scan``
    (the kernel on the card), decode ``gla_step``."""
    H = cfg.n_heads
    P = di // H
    q = at_least_f32((xin @ params["w_q"]).reshape(B, S, H, P))
    k = at_least_f32((xin @ params["w_k"]).reshape(B, S, H, P)) \
        / math.sqrt(P)
    v = at_least_f32((xin @ params["w_v"]).reshape(B, S, H, P))
    gates = at_least_f32(xin @ params["w_if"]).reshape(B, S, 2 * H)
    if local_gla:
        spec = (BATCH, None, "model", None)
        q = constrain(q, *spec)
        k = constrain(k, *spec)
        v = constrain(v, *spec)
        gates = constrain(gates, BATCH, None, None)
    i_g = torch.exp(gates[..., :H].clamp(-10.0, 5.0))        # (B, S, H)
    log_f = F.logsigmoid(gates[..., H:])                     # <= 0
    if get_mesh() is None:
        # v·i and i written into one buffer at the kernel's row pitch
        # (copies into a fresh buffer, which autograd follows)
        v_aug = ssd_ops.pitched(B, S, H, P + 1, v.dtype, v.device)
        v_aug[..., :P] = v * i_g[..., None]
        v_aug[..., P] = i_g
    else:
        # on a device mesh the same values as one (DTensor) operator: the
        # pitched buffer is a plain tensor
        v_aug = torch.cat([v * i_g[..., None], i_g[..., None]], dim=-1)
    if step:
        y_aug, state = gla_step(q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0],
                                state)
        y_aug = y_aug[:, None]
    else:
        y_aug, state = ssd_ops.ssd_scan(q, k, v_aug, log_f, cfg.chunk, state,
                                        backend=backend)
    y, n = y_aug[..., :P], y_aug[..., P:]
    y = y / n.abs().clamp_min(1.0)
    return y.reshape(B, S, di), state


def mlstm_forward(params, x, cfg: SSMConfig, state=None,
                  backend: str = "cuda", local_gla: bool = False):
    """x: (B, S, D) -> (B, S, D) and the final state (B, H, P + 1, P),
    P = expand * D / H; ``state`` None starts from zeros."""
    B, S, D = x.shape
    di = cfg.expand * D
    xin, z = (x @ params["w_in"]).chunk(2, dim=-1)
    y, state = _mlstm_core(params, xin, cfg, B, S, di, state, step=False,
                           backend=backend, local_gla=local_gla)
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["w_out"], state


def mlstm_step(params, x, cfg: SSMConfig, state):
    """Decode one token.  x: (B, 1, D); state: (B, H, P + 1, P)."""
    B, _, D = x.shape
    di = cfg.expand * D
    xin, z = (x @ params["w_in"]).chunk(2, dim=-1)
    y, state = _mlstm_core(params, xin, cfg, B, 1, di, state, step=True)
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["w_out"], state


# ------------------------------------------------------------------ sLSTM
def init_slstm(gen: torch.Generator, d_model: int, cfg: SSMConfig,
               dtype=torch.float32) -> dict:
    H = cfg.n_heads
    P = d_model // H
    return {
        "w_gates": dense_init(gen, d_model, 4 * d_model, dtype),
        # per-head recurrent weights (H, P, 4P)
        "r_gates": _normal(gen, (H, P, 4 * P), dtype) * math.sqrt(1.0 / P),
        "w_out": dense_init(gen, d_model, d_model, dtype),
    }


def slstm_init_state(shape, dtype=torch.float32, device=None) -> tuple:
    """(c, n, m, h), each of ``shape`` (..., B, H, P): zeros, and m at
    -1e30."""
    z = torch.zeros(shape, dtype=dtype, device=device)
    return (z, z, z - 1e30, z)


def _slstm_loop(r, c, n, m, h, wx, local_gla: bool = False):
    """The recurrence over time: r (H, P, 4P); (c, n, m, h) (B, H, P);
    wx (B, S, H, 4P) -> (c, n, m, h, hs (B, S, H, P)).  ``local_gla``
    pins the carry batch-local on a mesh each step."""
    P = r.shape[1]
    hs = []
    for t in range(wx.shape[1]):
        g = wx[:, t] + torch.einsum("bhp,hpq->bhq", h, r)    # (B, H, 4P)
        zi, ii, ff, oo = g.split(P, dim=-1)
        log_i = ii.clamp(-10.0, 5.0)
        log_f = F.logsigmoid(ff)
        m_new = torch.maximum(log_f + m, log_i)
        i_p = torch.exp(log_i - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * torch.tanh(zi)
        n = f_p * n + i_p
        h = torch.sigmoid(oo) * c / n.abs().clamp_min(1.0)
        m = m_new
        if local_gla:
            c, n, m, h = (constrain(t_, BATCH, None, None)
                          for t_ in (c, n, m, h))
        hs.append(h)
    return c, n, m, h, torch.stack(hs, dim=1)


def slstm_forward(params, x, cfg: SSMConfig, state=None,
                  local_gla: bool = False):
    """Sequential exponential-gated scalar LSTM with the max-stabilizer,
    one step per position (the reference's ``lax.scan``, marked as one
    loop for the graph importer).  x: (B, S, D); state: (c, n, m, h), each
    (B, H, P), None for ``slstm_init_state``'s."""
    B, S, D = x.shape
    H = cfg.n_heads
    P = D // H
    wx = at_least_f32(x @ params["w_gates"]).reshape(B, S, H, 4 * P)
    r = at_least_f32(params["r_gates"])
    if state is None:
        state = slstm_init_state((B, H, P), wx.dtype, x.device)
    loop = _slstm_loop
    if local_gla:
        # gather the gate pre-activations once, before the time loop, and
        # pin the recurrent carry batch-local (the reference's option)
        wx = constrain(wx, BATCH, None, "model", None)
        state = tuple(constrain(s, BATCH, None, None) for s in state)
        loop = functools.partial(_slstm_loop, local_gla=True)
    c, n, m, h, hs = scan(loop, r, *state, wx)
    y = hs.reshape(B, S, D).to(x.dtype)
    return y @ params["w_out"], (c, n, m, h)


def slstm_step(params, x, cfg: SSMConfig, state):
    return slstm_forward(params, x, cfg, state)
