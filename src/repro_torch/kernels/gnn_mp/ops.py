"""Public wrapper: segment-sum over edge messages (twin of
``repro/kernels/gnn_mp/ops.py::segment_sum_mp``).

``segment_sum(msg, dst, n)`` aggregates one edge direction;
``segment_sum_pair(msg_in, dst, msg_out, src, n)`` aggregates both
directions of a GNN layer (incoming messages by dst, outgoing ones by src)
in one launch, which is what the encoder calls.  Both run the CUDA kernels
of ``csrc/gnn_mp.cu`` on CUDA tensors and the plain version (ref.py) on
CPU tensors or when ``backend="torch"``.  Both are differentiable: the
backward pass is the cotangent gather ``g[dst]`` (and ``g[src]``), as in
the reference's ``custom_vjp``; the gather is plain torch, as it is XLA in
the reference.  An empty edge set returns zeros without a launch.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import CSR, build_csr, segment_sum_pair_ref, segment_sum_ref

BACKENDS = ("torch", "cuda")

# kernel launches in this process (read and reset by chip_smoke.py):
# ``launches`` of the single-direction kernel, ``pair_launches`` of the
# two-direction one
launches = 0
pair_launches = 0

_entry: dict[str, object] = {}       # C entry points, looked up once


def _c(symbol: str):
    fn = _entry.get(symbol)
    if fn is None:
        fn = _entry[symbol] = getattr(_build.load("gnn_mp"), symbol)
    return fn


def _check(msg: torch.Tensor, n: int, csr: CSR) -> None:
    if msg.dtype != torch.float32 or not msg.is_contiguous():
        raise ValueError("gnn_mp: msg must be contiguous float32")
    perm, ptr = csr.perm, csr.row_ptr
    if (perm.device != msg.device or perm.dtype != torch.int32
            or ptr.dtype != torch.int32 or ptr.device != msg.device
            or perm.shape != (msg.shape[0],) or ptr.shape != (n + 1,)
            or not perm.is_contiguous() or not ptr.is_contiguous()):
        raise ValueError(f"gnn_mp: the CSR must be contiguous int32 "
                         f"({msg.shape[0]},) and ({n + 1},) on "
                         f"{msg.device}")


def _launch(msg: torch.Tensor, n: int, csr: CSR) -> torch.Tensor:
    global launches
    _check(msg, n, csr)
    d = msg.shape[1]
    out = torch.empty((n, d), dtype=msg.dtype, device=msg.device)
    if n == 0 or d == 0:
        return out
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    rc = _c("gnn_mp_segment_sum")(msg.data_ptr(), csr.perm.data_ptr(),
                                  csr.row_ptr.data_ptr(), out.data_ptr(),
                                  n, d, stream)
    _build.check("gnn_mp", rc)
    launches += 1
    return out


def _launch_pair(msg_a: torch.Tensor, csr_a: CSR, msg_b: torch.Tensor,
                 csr_b: CSR, n: int) -> torch.Tensor:
    """-> (2, n, d): [0] from (msg_a, csr_a), [1] from (msg_b, csr_b)."""
    global pair_launches
    _check(msg_a, n, csr_a)
    _check(msg_b, n, csr_b)
    m, d = msg_a.shape
    if msg_b.shape != (m, d):
        raise ValueError(f"gnn_mp: messages {(m, d)} and "
                         f"{tuple(msg_b.shape)} differ")
    out = torch.empty((2, n, d), dtype=msg_a.dtype, device=msg_a.device)
    if n == 0 or d == 0:
        return out
    base = out.data_ptr()
    rc = _c("gnn_mp_segment_sum_pair")(
        msg_a.data_ptr(), csr_a.perm.data_ptr(), csr_a.row_ptr.data_ptr(),
        base, msg_b.data_ptr(), csr_b.perm.data_ptr(),
        csr_b.row_ptr.data_ptr(), base + 4 * n * d, n, d,
        torch.cuda.current_stream(msg_a.device).cuda_stream)
    _build.check("gnn_mp", rc)
    pair_launches += 1
    return out


def _pair(msg_in, dst, msg_out, src, n, csrs, backend) -> torch.Tensor:
    """Both directions' sums as one (2, n, d) tensor."""
    if _use_plain(msg_in, backend):
        return torch.stack(segment_sum_pair_ref(msg_in, dst, msg_out, src,
                                                n, csrs))
    csr_dst, csr_src = (csrs if csrs is not None
                        else (build_csr(dst, n), build_csr(src, n)))
    return _launch_pair(msg_in, csr_dst, msg_out, csr_src, n)


def _use_plain(msg: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown gnn_mp backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    if backend == "torch" or msg.device.type == "cpu":
        return True
    if msg.device.type != "cuda":
        raise ValueError(f"gnn_mp: unsupported device {msg.device}")
    return False


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, dst, n, csr, backend):
        ctx.save_for_backward(dst)
        if _use_plain(msg, backend):
            return segment_sum_ref(msg, dst, n, csr)
        return _launch(msg, n, csr if csr is not None else build_csr(dst, n))

    @staticmethod
    def backward(ctx, g):
        # d/dmsg of a sum by destination is the cotangent gather
        (dst,) = ctx.saved_tensors
        return g[dst], None, None, None, None


class _SegmentSumPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg_in, dst, msg_out, src, n, csrs, backend):
        ctx.save_for_backward(dst, src)
        return _pair(msg_in, dst, msg_out, src, n, csrs, backend)

    @staticmethod
    def backward(ctx, g):
        # each direction's cotangent gathered by its own segment ids
        dst, src = ctx.saved_tensors
        return g[0][dst], None, g[1][src], None, None, None, None


def segment_sum(msg: torch.Tensor, dst: torch.Tensor, n: int,
                backend: str = "cuda", csr: CSR | None = None
                ) -> torch.Tensor:
    """msg: (m, d) edge messages; dst: (m,) destination ids in [0, n).
    Returns (n, d) with out[v] = sum over edges with dst == v.  ``csr``
    is ``build_csr(dst, n)``, passed in when the caller keeps it."""
    if msg.shape[0] == 0:
        return msg.new_zeros((n, msg.shape[1]))
    return _SegmentSum.apply(msg, dst, n, csr, backend)


def segment_sum_pair(msg_in: torch.Tensor, dst: torch.Tensor,
                     msg_out: torch.Tensor, src: torch.Tensor, n: int,
                     backend: str = "cuda",
                     csr: tuple[CSR, CSR] | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a GNN layer: msg_in, msg_out (m, d) over the
    edges (src, dst).  Returns (agg_in, agg_out), each (n, d):
    agg_in[v] = sum of msg_in[e] over dst[e] == v, agg_out[v] = sum of
    msg_out[e] over src[e] == v.  ``csr`` is ``(build_csr(dst, n),
    build_csr(src, n))``, passed in when the caller keeps it."""
    if msg_in.shape[0] == 0:
        z = msg_in.new_zeros((n, msg_in.shape[1]))
        return z, z.clone()
    if torch.is_grad_enabled() and (msg_in.requires_grad
                                    or msg_out.requires_grad):
        out = _SegmentSumPair.apply(msg_in, dst, msg_out, src, n, csr,
                                    backend)
    else:                            # no graph to record: skip autograd
        out = _pair(msg_in, dst, msg_out, src, n, csr, backend)
    return out[0], out[1]
