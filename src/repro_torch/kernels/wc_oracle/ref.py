"""Plain PyTorch WC-oracle trip step (twin of
``repro/kernels/wc_oracle/ref.py::wc_step_ref``).

One trip of the device-resident oracle does three things to each
episode's (R, 6) running table (columns: end, start trip, ready time,
key, task, free):

  1. write the work-conserving start rows (a one-hot masked max-combine
     over the ≤K candidate rows; ``ridx == -1`` drops a row),
  2. pop the earliest completion via the lexicographic
     (end, start trip, ready time, key) argmin, first matching row,
  3. clear the popped row's end time (only if the episode is alive).

The CUDA kernel must match this bit for bit on ``run_out`` and ``e1``;
``rho`` only where ``isfinite(e1)``.
"""
from __future__ import annotations

import torch

F_BIG = float(2**31 - 1)         # rounds to 2**31 in f32, as in the reference


def wc_step_ref(run: torch.Tensor, rows: torch.Tensor, ridx: torch.Tensor):
    """run: (B, R, 6) f32; rows: (B, K, 6) f32; ridx: (B, K) int, -1 drops.
    Returns (run_out (B, R, 6), rho (B,) int32, e1 (B,) f32)."""
    B, R, _ = run.shape
    lane = torch.arange(R, device=run.device)
    hit = ridx[:, :, None].long() == lane[None, None, :]          # (B, K, R)
    written = hit.any(dim=1)                                      # (B, R)
    # duplicate candidates carry identical rows, so max-combine is exact
    val = torch.where(hit[..., None], rows[:, :, None, :],
                      torch.tensor(-torch.inf, device=run.device)
                      ).amax(dim=1)
    run1 = torch.where(written[..., None], val, run)

    end, strip, rdy, key = run1.unbind(-1)[:4]
    e1 = end.amin(dim=1)
    mk = end == e1[:, None]
    s1 = torch.where(mk, strip, F_BIG).amin(dim=1)
    mk &= strip == s1[:, None]
    r1 = torch.where(mk, rdy, torch.inf).amin(dim=1)
    mk &= rdy == r1[:, None]
    k1 = torch.where(mk, key, F_BIG).amin(dim=1)
    mk &= key == k1[:, None]
    # first matching row (0 if none, as the reference's argmax)
    first = torch.where(mk, lane, R).amin(dim=1)
    rho = torch.where(first < R, first, 0).to(torch.int32)
    alive = torch.isfinite(e1)

    clear = alive[:, None] & (lane[None, :] == rho[:, None])
    run_out = run1.clone()
    run_out[..., 0] = torch.where(clear, torch.inf, end)
    return run_out, rho, e1
