"""Public wrapper: segment-sum over edge messages (twin of
``repro/kernels/gnn_mp/ops.py::segment_sum_mp``).

``segment_sum(msg, dst, n)`` runs the CUDA kernel ``csrc/gnn_mp.cu`` on
CUDA tensors and the plain version (ref.py) on CPU tensors or when
``backend="torch"``.  It is differentiable: the backward pass is the
cotangent gather ``g[dst]``, as in the reference's ``custom_vjp``.  An
empty edge set returns zeros without a launch.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import CSR, build_csr, segment_sum_ref

BACKENDS = ("torch", "cuda")

# kernel launches in this process (read and reset by chip_smoke.py)
launches = 0


def _launch(msg: torch.Tensor, n: int, csr: CSR) -> torch.Tensor:
    global launches
    m, d = msg.shape
    if msg.dtype != torch.float32 or not msg.is_contiguous():
        raise ValueError("gnn_mp: msg must be contiguous float32")
    for name, t, size in (("perm", csr.perm, m), ("row_ptr", csr.row_ptr,
                                                  n + 1)):
        if (t.device != msg.device or t.dtype != torch.int32
                or not t.is_contiguous() or t.shape != (size,)):
            raise ValueError(f"gnn_mp: {name} must be contiguous int32 "
                             f"({size},) on {msg.device}")
    out = torch.empty((n, d), dtype=msg.dtype, device=msg.device)
    if n == 0 or d == 0:
        return out
    lib = _build.load("gnn_mp")
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    rc = lib.gnn_mp_segment_sum(msg.data_ptr(), csr.perm.data_ptr(),
                                csr.row_ptr.data_ptr(), out.data_ptr(),
                                n, d, stream)
    _build.check("gnn_mp", rc)
    launches += 1
    return out


def _forward(msg, dst, n, csr, backend):
    if backend not in BACKENDS:
        raise ValueError(f"unknown gnn_mp backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    if backend == "torch" or msg.device.type == "cpu":
        return segment_sum_ref(msg, dst, n, csr)
    if msg.device.type != "cuda":
        raise ValueError(f"gnn_mp: unsupported device {msg.device}")
    if csr is None:
        csr = build_csr(dst, n)
    return _launch(msg, n, csr)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, dst, n, csr, backend):
        ctx.save_for_backward(dst)
        return _forward(msg, dst, n, csr, backend)

    @staticmethod
    def backward(ctx, g):
        # d/dmsg of a sum by destination is the cotangent gather
        (dst,) = ctx.saved_tensors
        return g[dst], None, None, None, None


def segment_sum(msg: torch.Tensor, dst: torch.Tensor, n: int,
                backend: str = "cuda", csr: CSR | None = None
                ) -> torch.Tensor:
    """msg: (m, d) edge messages; dst: (m,) destination ids in [0, n).
    Returns (n, d) with out[v] = sum over edges with dst == v.  ``csr``
    is ``build_csr(dst, n)``, passed in when the caller keeps it."""
    if msg.shape[0] == 0:
        return msg.new_zeros((n, msg.shape[1]))
    return _SegmentSum.apply(msg, dst, n, csr, backend)
