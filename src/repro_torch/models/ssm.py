"""State-space blocks (twin of ``repro/models/ssm.py``): Mamba2 (SSD).

Mamba2 is gated linear attention: a (P, N) matrix state per head, decayed
by a scalar gate and updated by v kᵀ.  The chunked scan core
(``chunked_gla``, plain) lives beside its kernel in
``kernels/mamba2_scan/ref.py`` and is re-exported here; prefill runs the
kernel through ``kernels/mamba2_scan/ops.py::ssd_scan``.  Decode (``*_step``)
carries O(1) state.

The reference's simplification is kept: the short causal conv is applied
to the input branch only.  mLSTM and sLSTM (xlstm) are not ported yet
(ROADMAP A11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.nn import at_least_f32
from ..kernels.mamba2_scan import ops as ssd_ops
from ..kernels.mamba2_scan.ref import _chunk_gla, chunked_gla  # noqa: F401
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
                   backend: str = "cuda"):
    """x: (B, S, D) -> (B, S, D) and the final SSD state (B, H, P, N).
    ``state``: the carried SSD state, or None for zeros.  The scan runs
    the ``mamba2_scan`` kernel on the card (``backend="cuda"``); q and k
    are one (B, S, N) tensor each, broadcast over the heads as views."""
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
