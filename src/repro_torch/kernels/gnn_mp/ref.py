"""Plain PyTorch segment-sum and the segment-sorted (CSR) edge index.

The plain version is deterministic on every device: each segment's
edges are gathered from a padded slot table and summed over the slot
axis, with no atomics (``index_add_`` on CUDA is atomic, so its
summation order changes from run to run).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CSR:
    """Edges grouped by segment id, built once per graph and direction.

    perm:    (m,) int32 edge ids, stably sorted by segment
    row_ptr: (n + 1,) int32 offsets of each segment's run in ``perm``
    slots:   (n, L) int64 edge ids per segment, -1 padded (L = max degree)
    """
    perm: torch.Tensor
    row_ptr: torch.Tensor
    slots: torch.Tensor


def build_csr(index: torch.Tensor, n: int) -> CSR:
    """CSR of ``index`` (m,) over ``n`` segments, on ``index``'s device."""
    index = index.long()
    m = index.shape[0]
    perm = torch.argsort(index, stable=True)
    counts = torch.bincount(index, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.long, device=index.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    width = max(int(counts.max()) if m else 0, 1)
    seg = index[perm]
    rank = torch.arange(m, device=index.device) - row_ptr[seg]
    slots = torch.full((n, width), -1, dtype=torch.long, device=index.device)
    slots[seg, rank] = perm
    return CSR(perm.to(torch.int32), row_ptr.to(torch.int32), slots)


def segment_sum_ref(msg: torch.Tensor, dst: torch.Tensor, n: int,
                    csr: CSR | None = None) -> torch.Tensor:
    """(n, d) with out[v] = sum of msg[e] over e with dst[e] == v."""
    if csr is None:
        csr = build_csr(dst, n)
    valid = csr.slots >= 0
    gathered = msg[csr.slots.clamp(min=0)]                  # (n, L, d)
    return torch.where(valid[..., None], gathered,
                       torch.zeros((), dtype=msg.dtype,
                                   device=msg.device)).sum(1)
