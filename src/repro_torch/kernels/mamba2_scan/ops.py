"""Public wrapper: the Mamba2 / SSD chunked scan (twin of
``repro/kernels/mamba2_scan/ops.py::ssd_scan``, which also returns the
carried state here).

``ssd_scan(q, k, v, log_a, chunk, state)`` runs the CUDA kernels of
``csrc/mamba2_scan.cu`` on CUDA tensors and the plain version (ref.py) on
CPU tensors or when ``backend="torch"``.  As in the reference launcher,
the within-chunk cumulative sum of ``log_a`` is taken here, outside the
kernel, after ``log_a`` is zero-padded to a multiple of the chunk.  The
kernel treats q, k and v past S as that same zero padding, so a ragged S
needs no padded copy of them.  q and k are read through their strides:
``mamba2_forward`` passes one (B, S, N) tensor broadcast over the heads
(head stride 0), which is never materialised; ``mlstm_forward`` passes
per-head q and k.

The kernel takes a state dim N up to ``MAX_STATE_DIM`` (1024: xLSTM's
mLSTM has N = P = 1024 a head), walking N in 64-wide tiles, and any P.
v and y rows are kept at a pitch of P rounded up to a multiple of 4, so
that every tile of v stays 16-byte aligned; y comes back as a view of
its first P columns.  A v built in ``pitched(B, S, H, P)`` (as
``mlstm_forward`` builds xLSTM's 1025 columns: the values and the
normalizer channel) is read in place; any other v of such a P is copied
into a padded buffer first.

One call launches four passes (``KERNELS``, in order): the q kᵀ scores
(once per batch row when q and k are broadcast over the heads, else once
per head), the per-chunk states, the state chain over the chunks, and the
chunk outputs.  The wrapper allocates their scratch: the scores' lower
64 x 64 tiles and the (B*H, n_chunks, P, N) chunk states (537 MB a call
at xLSTM's prefill).

Under autograd a CUDA call is a ``torch.autograd.Function``: its forward
launches the kernels (one count a call, also when activation
checkpointing runs it again), its backward recomputes the plain version
(``ssd_scan_ref``) from the saved inputs and differentiates that, giving
q, k, v, ``log_a`` and the carried-in state gradients of the caller's
shapes (the broadcast q and k and a pitched v included).  The reference
has no backward kernel either: its models train through ``chunked_gla``.

DTensor arguments (a model on a device mesh) run shard by shard
(``_scan_shards``): the kernels, or on CPU shards the plain version, on
each rank's batch rows and heads; a CUDA DTensor never takes the plain
version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...parallel import local_shards
from ...parallel.annotate import is_dtensor, replicate_like
from .. import _build
from .ref import ssd_scan_ref

BACKENDS = ("torch", "cuda")
MAX_STATE_DIM = 1024
TILE = 64                    # the kernels' tile of positions
# the kernels one call launches, in order (profiler names)
KERNELS = ("ssd_qk_scores", "ssd_chunk_state", "ssd_state_pass",
           "ssd_chunk_y")

# ssd_scan calls that launched the kernels, in this process (read and
# reset by chip_smoke.py)
launches = 0


def chunk_cumsum(log_a: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, H) log decay -> (B*H, n_chunks*chunk) inclusive cumulative
    sums within each chunk, zero-padded past S, head-major."""
    B, S, H = log_a.shape
    n_chunks = -(-S // chunk)
    la = F.pad(log_a.float(), (0, 0, 0, n_chunks * chunk - S))
    cum = la.reshape(B, n_chunks, chunk, H).cumsum(dim=2)
    # contiguous: with B == 1 the reshape alone would be a strided view
    return cum.permute(0, 3, 1, 2).contiguous().view(B * H, -1)


def pitched(B: int, S: int, H: int, P: int, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """An empty (B, S, H, P) tensor whose rows sit at the kernel's pitch
    (P rounded up to a multiple of 4): ``ssd_scan`` reads it as v in
    place, where a contiguous v of such a P is copied into a padded
    buffer first.  The columns past P are never read."""
    ldv = -(-P // 4) * 4
    return torch.empty(B, S, H, ldv, dtype=dtype, device=device)[..., :P]


def _row_pitch(v: torch.Tensor) -> int | None:
    """The pitch of v's rows, if v is laid out as a contiguous tensor of
    that last dim cut to P columns (size-1 dims' strides aside); else
    None."""
    B, S, H, P = v.shape
    ld = v.stride(2) if H > 1 else (v.stride(1) if S > 1 else
                                    (v.stride(0) if B > 1 else P))
    want = (S * H * ld, H * ld, ld, 1)
    if ld < P or any(n > 1 and st != w for n, st, w
                     in zip(v.shape, v.stride(), want)):
        return None
    return ld


def _launch(q, k, v, log_a, chunk, state):
    global launches
    B, S, H, N = q.shape
    P = v.shape[-1]
    for name, t, shape in (("q", q, (B, S, H, N)), ("k", k, (B, S, H, N)),
                           ("v", v, (B, S, H, P)), ("log_a", log_a,
                                                    (B, S, H))):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"mamba2_scan: {name} must be float32 {shape} "
                             f"on {q.device}")
    ldv = _row_pitch(v)                  # v's and y's row pitch
    if q.stride(-1) != 1 or k.stride(-1) != 1 or ldv is None:
        raise ValueError("mamba2_scan: q and k need a unit stride on N and "
                         "v must be contiguous or built in pitched()")
    if state is not None and (state.device != q.device
                              or state.dtype != torch.float32
                              or tuple(state.shape) != (B, H, P, N)
                              or not state.is_contiguous()):
        raise ValueError(f"mamba2_scan: state must be contiguous float32 "
                         f"{(B, H, P, N)} on {q.device}")
    if not 1 <= N <= MAX_STATE_DIM or chunk < 1:
        raise ValueError(f"mamba2_scan: state dim {N} not in "
                         f"[1, {MAX_STATE_DIM}] or chunk {chunk} < 1")
    if ldv != -(-P // 4) * 4:
        ldv = -(-P // 4) * 4
        v = F.pad(v, (0, ldv - P))
    y = torch.empty(B, S, H, ldv, dtype=torch.float32, device=q.device)
    st = torch.empty(B, H, P, N, dtype=torch.float32, device=q.device)
    if S == 0 or P == 0 or B * H == 0:
        return y[..., :P], (st.zero_() if state is None else st.copy_(state))
    cum = chunk_cumsum(log_a, chunk)
    n_chunks = cum.shape[1] // chunk
    shared = q.stride(2) == 0 and k.stride(2) == 0
    nt = -(-chunk // TILE)
    scores = torch.empty((B if shared else B * H) * n_chunks
                         * (nt * (nt + 1) // 2) * TILE * TILE,
                         dtype=torch.float32, device=q.device)
    states = torch.empty(B * H * n_chunks * P * N, dtype=torch.float32,
                         device=q.device)
    lib = _build.load("mamba2_scan")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.mamba2_scan_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cum.data_ptr(),
        0 if state is None else state.data_ptr(), y.data_ptr(),
        st.data_ptr(), scores.data_ptr(), states.data_ptr(), B, S, H, N, P,
        ldv, chunk, n_chunks, int(shared), q.stride(0), q.stride(1),
        q.stride(2), k.stride(0), k.stride(1), k.stride(2), stream)
    _build.check("mamba2_scan", rc)
    launches += 1
    return y[..., :P], st


class _Scan(torch.autograd.Function):
    """The kernels forward; the backward of the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, chunk, state):
        ctx.chunk = chunk
        ctx.save_for_backward(q, k, v, log_a, state)
        return _launch(q, k, v, log_a, chunk, state)

    @staticmethod
    def backward(ctx, gy, gst):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_()
                  for t in saved]
        wrt = [t for t in inputs if t is not None]
        with torch.enable_grad():
            y, st = ssd_scan_ref(*inputs[:4], ctx.chunk, inputs[4])
        grads = iter(torch.autograd.grad((y, st), wrt, (gy, gst)))
        g = [None if t is None else next(grads) for t in inputs]
        return (*g[:4], None, g[4])


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, chunk: int,
             state: torch.Tensor | None = None, backend: str = "cuda"):
    """Chunked gated linear attention.  q, k: (B, S, H, N); v: (B, S, H,
    P); log_a: (B, S, H) <= 0; state: (B, H, P, N) carried in, or None for
    zeros.  Returns y (B, S, H, P) and the final state (B, H, P, N), both
    float32.  On CUDA the kernels run forward under autograd too, the
    plain version's gradient backward."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown mamba2_scan backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if any(is_dtensor(t) for t in (q, k, v, log_a, state)):
        return _scan_shards(q, k, v, log_a, chunk, state, backend)
    if backend == "torch" or q.device.type == "cpu":
        return ssd_scan_ref(q, k, v, log_a, chunk, state)
    if q.device.type != "cuda":
        raise ValueError(f"mamba2_scan: unsupported device {q.device}")
    return _Scan.apply(q, k, v, log_a, chunk, state)


def _scan_shards(q, k, v, log_a, chunk: int, state, backend: str):
    """``ssd_scan`` on DTensors: every input laid out by v's batch (dim 0)
    and head (dim 2) splits, another split of v moved to the heads or
    gathered (log_a's heads are its dim 2, the state's its dim 1); the
    kernels run on each rank's local tensors; y has v's placements, the
    state the same split of its batch and heads."""
    from torch.distributed.tensor import Shard
    like = next(t for t in (v, q, k, log_a, state) if is_dtensor(t))
    mesh = like.device_mesh
    v = replicate_like(v, like)
    vp = local_shards.layout(v, keep=(0, 2), to=2)
    sp = [Shard(1) if local_shards.is_shard(p, 2) else p for p in vp]
    q, k, v, log_a = (local_shards.laid_out(replicate_like(t, like), vp)
                      for t in (q, k, v, log_a))
    if state is not None:
        state = local_shards.laid_out(replicate_like(state, like),
                                      sp).to_local().contiguous()
    # a split of the heads may leave v a strided view: the kernel reads it
    # contiguous or pitched (q and k keep their strides: a head stride of
    # 0 is the kernel's shared case)
    vl = v.to_local()
    if _row_pitch(vl) is None:
        vl = vl.contiguous()
    y, st = ssd_scan(q.to_local(), k.to_local(), vl, log_a.to_local(), chunk,
                     state, backend)
    B, S, H, N = q.shape
    P = v.shape[-1]
    return (local_shards.wrap(y, mesh, vp, (B, S, H, P)),
            local_shards.wrap(st, mesh, sp, (B, H, P, N)))
