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
    """(n, d) with out[v] = sum of msg[e] over e with dst[e] == v, added
    one slot at a time from zero in edge-sorted order: the kernel's
    order, so on the card the two are bit-equal (a reduction over the
    slot axis associates the adds otherwise, and an ill-conditioned
    gradient downstream can turn that last-bit gap into a large one)."""
    if csr is None:
        csr = build_csr(dst, n)
    out = torch.zeros((n, *msg.shape[1:]), dtype=msg.dtype, device=msg.device)
    zero = torch.zeros((), dtype=msg.dtype, device=msg.device)
    for slot in csr.slots.T:
        valid = (slot >= 0).view(-1, *([1] * (msg.dim() - 1)))
        out = out + torch.where(valid, msg[slot.clamp(min=0)], zero)
    return out


def segment_sum_pair_ref(msg_in: torch.Tensor, dst: torch.Tensor,
                         msg_out: torch.Tensor, src: torch.Tensor, n: int,
                         csr: tuple[CSR, CSR] | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a GNN layer: (segment sum of msg_in by dst,
    segment sum of msg_out by src), each (n, d)."""
    csr_dst, csr_src = csr if csr is not None else (None, None)
    return (segment_sum_ref(msg_in, dst, n, csr_dst),
            segment_sum_ref(msg_out, src, n, csr_src))
