"""Public wrapper: causal flash attention (twin of
``repro/kernels/flash_attention/ops.py::flash_attention``).

``flash_attention(q, k, v)`` runs a CUDA kernel on CUDA tensors and the
plain version (ref.py) on CPU tensors or when ``backend="torch"``.  Which
kernel is dispatch by dtype and head dim, not a fallback:

- bf16 with d = 64 or 128: ``flash_fwd_wgmma``
  (``csrc/flash_attention_sm90.cu``), wgmma on the tensor cores;
- every other dtype (fp32, fp16) and head dim, d up to 256:
  ``flash_fwd_mma`` (``csrc/flash_attention.cu``), mma.sync on the tensor
  cores (3xTF32 for fp32, 16-bit products with P split hi + lo).

Both compute the same function and raise if they cannot launch.  Both take
the model's (B, S, H, d) layout as it is and map query head h to KV head
h // G, so the reference wrapper's ``repeat`` of K and V and its transposes
to (B*H, S, d) have no counterpart here.  Any S is taken (the ragged last
tile is masked); the reference's Pallas launcher asks for a multiple of
its block.

Under autograd a CUDA call is a ``torch.autograd.Function``: its forward
launches the kernel (and counts the launch, also when activation
checkpointing runs it again), its backward recomputes the plain version
from the saved q, k and v and differentiates that.  The reference has no
backward kernel either: its models train through the XLA twin.

``mixed`` (the model's ``attn_mixed_precision``) selects the plain
version's mode: the probabilities rounded to v's dtype before the product
with v.  The kernels have one mode, the fp32-P one, as the Pallas kernel:
a CUDA call launches the same kernel either way (``flash_fwd_wgmma``
splits P into bf16 hi + lo, ``flash_fwd_mma`` likewise in 16 bits), and
its backward differentiates the plain version in the mode asked for.  In
bf16 the two modes differ by P's rounding, within the bf16 bar.

DTensor arguments (a model on a device mesh) run shard by shard
(``_flash_shards``): the kernel, or on CPU shards the plain version, on
each rank's batch rows and query heads, with the KV heads those heads
map to; a CUDA DTensor never takes the plain version.
"""
from __future__ import annotations

import torch

from ...parallel import local_shards
from ...parallel.annotate import is_dtensor, replicate_like
from .. import _build
from .ref import attention_ref, chunked_attention

BACKENDS = ("torch", "cuda")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128)        # bf16 head dims of flash_fwd_wgmma
# flash_fwd_mma's tiles (csrc/flash_attention.cu, ``Tiles``) by element
# size in bytes and padded head dim: (query rows, keys) a block
MMA_TILES = {(4, 64): (128, 32), (4, 128): (128, 32), (4, 256): (64, 32),
             (2, 64): (128, 32), (2, 128): (128, 64), (2, 256): (64, 64)}

# kernel launches in this process, of either kernel, and of each by name
# (read and reset by chip_smoke.py)
launches = 0
kernel_launches = {"flash_fwd_wgmma": 0, "flash_fwd_mma": 0}


def uses_wgmma(dtype: torch.dtype, d: int) -> bool:
    """Whether a CUDA call on this dtype and head dim runs
    ``flash_fwd_wgmma`` (else ``flash_fwd_mma``)."""
    return dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS


def mma_tiles(dtype: torch.dtype, d: int) -> tuple[int, int]:
    """(query rows, keys) of a ``flash_fwd_mma`` block at this dtype and
    head dim (d is padded to 64, 128 or 256)."""
    dp = 64 if d <= 64 else (128 if d <= 128 else 256)
    return MMA_TILES[(4 if dtype == torch.float32 else 2, dp)]


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    global launches
    B, S, H, d = q.shape
    Hkv = k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"{q.dtype} on {q.device}")
    if (k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != d
            or Hkv == 0 or H % Hkv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k, v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match (B, S, Hq, d) / (B, S, Hkv, d)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if uses_wgmma(q.dtype, d):
        if any(p % 16 for p in ptrs):          # TMA reads 16-byte aligned
            raise ValueError("flash_attention: bf16 q, k, v must be "
                             "16-byte aligned")
        lib = _build.load("flash_attention_sm90")
        rc = lib.flash_attention_wgmma_fwd(*ptrs, B, S, H, Hkv, d,
                                           int(causal), stream)
        name = "flash_fwd_wgmma"
    else:
        lib = _build.load("flash_attention")
        rc = lib.flash_attention_fwd(*ptrs, B, S, H, Hkv, d, int(causal),
                                     DTYPE_CODES[q.dtype], stream)
        name = "flash_fwd_mma"
    _build.check(name, rc)
    launches += 1
    kernel_launches[name] += 1
    return out


class _Flash(torch.autograd.Function):
    """The kernel forward; the backward of the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, mixed=False):
        ctx.causal, ctx.mixed = causal, mixed
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_ref(*inputs, ctx.causal, ctx.mixed)
        return (*torch.autograd.grad(out, inputs, g), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, backend: str = "cuda",
                    mixed: bool = False) -> torch.Tensor:
    """q: (B, S, Hq, d); k, v: (B, S, Hkv, d) with Hq % Hkv == 0, one
    float dtype.  Softmax(q kᵀ / sqrt(d)) v with fp32 scores, running max,
    denominator and accumulator; masked scores are -1e30 and the
    denominator is floored at 1e-30.  Returns (B, S, Hq, d) in q's dtype.
    On CUDA the kernel runs forward under autograd too, the plain
    version's gradient backward.  ``mixed``: the plain version rounds the
    probabilities to v's dtype (on the CPU, and in the backward); the
    kernel computes its fp32-P mode either way."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown flash_attention backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if is_dtensor(q):
        return _flash_shards(q, k, v, causal, backend, mixed)
    if backend == "torch" or q.device.type == "cpu":
        # the reference's train and prefill path, a loop over chunks of
        # 512 queries (one chunk where S is no multiple of 512: the kernel
        # takes any S)
        S = q.shape[1]
        return chunked_attention(q, k, v, chunk=512 if S % 512 == 0 else S,
                                 causal=causal, mixed=mixed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _Flash.apply(q, k, v, causal, mixed)


def _flash_shards(q, k, v, causal: bool, backend: str, mixed: bool):
    """``flash_attention`` on DTensors: q laid out by batch (dim 0) and
    heads (dim 2), another split moved to the heads or gathered; k and v
    split alike where the KV heads divide, else replicated, and then
    each rank takes the KV heads its query heads map to (h // G over the
    global h), their gradient a partial sum over those mesh dims.  The
    kernel runs on each rank's local tensors; the result has q's
    placements."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    G = H // Hkv
    qp = local_shards.layout(q, keep=(0, 2), to=2)
    heads = [i for i, p in enumerate(qp) if local_shards.is_shard(p, 2)]
    n_heads = 1
    for i in heads:
        n_heads *= mesh.size(i)
    split_kv = Hkv % n_heads == 0
    kp = [p if local_shards.is_shard(p, 0)
          or (local_shards.is_shard(p, 2) and split_kv) else Replicate()
          for p in qp]
    q = local_shards.laid_out(q, qp)
    k, v = (local_shards.laid_out(replicate_like(t, q), kp) for t in (k, v))
    if split_kv:
        kl, vl = (t.to_local().contiguous() for t in (k, v))
    else:
        h0, hl = local_shards.block(mesh, qp, 2, H)
        if hl % G and G % hl:
            raise ValueError(
                f"flash_attention: {hl} query heads a rank do not cover "
                f"whole groups of {G} over {Hkv} KV heads")
        lo, hi = h0 // G, (h0 + hl - 1) // G + 1
        gp = [Partial() if i in heads else p for i, p in enumerate(kp)]
        kl, vl = (t.to_local(grad_placements=gp)[:, :, lo:hi].contiguous()
                  for t in (k, v))
    # a local shard may be a strided view (a split of the heads); the
    # kernel reads contiguous tensors
    out = flash_attention(q.to_local().contiguous(), kl, vl, causal,
                          backend, mixed)
    return local_shards.wrap(out, mesh, qp, q.shape)
