"""Plain PyTorch version of the Mamba2 / SSD scan: the chunked
gated-linear-attention core (twin of ``repro/models/ssm.py::_chunk_gla`` /
``chunked_gla``, which ``repro/kernels/mamba2_scan/ref.py::gla_ref``
wraps).

``models/ssm.py`` re-exports ``chunked_gla`` from here, so the model and
the kernel's reference share one plain core.  The CPU path and the card's
comparisons use it; nothing on the card's main path calls it.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ...core.nn import at_least_f32, scan


def _chunk_gla(q, k, v, log_a, state):
    """One chunk.  q, k: (B, L, H, N); v: (B, L, H, P); log_a: (B, L, H)
    <= 0; state: (B, H, P, N).  Returns y: (B, L, H, P), new state."""
    cum = torch.cumsum(log_a, dim=1)                          # (B, L, H)
    # decay matrix M[t, s] = exp(cum[t] - cum[s]) for s <= t (gate applied
    # for r in (s, t]) -- lower-triangular
    diff = cum[:, :, None, :] - cum[:, None, :, :]            # (B, L, L, H)
    L = q.shape[1]
    tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    tri = tri[None, :, :, None]
    # masked before the exp as well: above the diagonal diff > 0 grows
    # along the chunk and exp overflows (cum falls by ~180 over zamba2's
    # 256), and the gradient of where(tri, inf, 0) is 0 * inf = NaN.  The
    # reference's _chunk_gla masks only after it; forward values agree
    M = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    qk = torch.einsum("blhn,bmhn->blmh", q, k)                # (B, L, L, H)
    y_intra = torch.einsum("blmh,bmhp->blhp", qk * M, v)
    # inter-chunk: contribution of the carried state
    P = torch.exp(cum)                                        # (B, L, H)
    y_inter = torch.einsum("blhn,bhpn,blh->blhp", q, state, P)
    # state update
    tot = P[:, -1]                                            # (B, H)
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)            # (B, L, H)
    state_new = (state * tot[:, :, None, None]
                 + torch.einsum("blh,blhp,blhn->bhpn", decay_to_end, v, k))
    return y_intra + y_inter, state_new


def chunked_gla(q, k, v, log_a, chunk: int, state=None):
    """Full-sequence gated linear attention, a loop over chunks.  Shapes as
    ``_chunk_gla`` with L = the full sequence; returns (y, final_state)."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    if state is None:
        wide = torch.float64 if q.dtype == torch.float64 else torch.float32
        state = torch.zeros(B, H, P, N, dtype=wide, device=q.device)
    if S <= chunk:
        return _chunk_gla(q, k, v, log_a, state)
    if S % chunk:
        # zero-pad to a chunk multiple: pads have k = v = 0 (no state
        # contribution) and log_a = 0 (decay 1, state preserved)
        pad = chunk - S % chunk
        padded = [F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
                  for x in (q, k, v, log_a)]
        y, st = chunked_gla(*padded, chunk, state)
        return y[:, :S], st
    state, y = scan(functools.partial(_gla_loop, chunk), state, q, k, v,
                    log_a)
    return y, state


def _gla_loop(chunk: int, state, q, k, v, log_a):
    """The loop over chunks of a chunk-multiple sequence -> (final state,
    y): the reference's ``lax.scan`` (carry first), marked as one loop for
    the graph importer."""
    ys = []
    for c0 in range(0, q.shape[1], chunk):
        y, state = _chunk_gla(q[:, c0:c0 + chunk], k[:, c0:c0 + chunk],
                              v[:, c0:c0 + chunk], log_a[:, c0:c0 + chunk],
                              state)
        ys.append(y)
    return state, torch.cat(ys, dim=1)


def ssd_scan_ref(q, k, v, log_a, chunk: int, state=None):
    """The kernel's function: ``chunked_gla`` in fp32 (fp64 inputs stay
    fp64).  q, k: (B, S, H, N);
    v: (B, S, H, P); log_a: (B, S, H); state: (B, H, P, N) or None.
    Returns y (B, S, H, P) fp32 and the final state (B, H, P, N)."""
    q, k, v, log_a = map(at_least_f32, (q, k, v, log_a))
    return chunked_gla(q, k, v, log_a, chunk,
                       None if state is None else at_least_f32(state))
