"""Public wrapper: causal flash attention (twin of
``repro/kernels/flash_attention/ops.py::flash_attention``).

``flash_attention(q, k, v)`` runs the CUDA kernel
``csrc/flash_attention.cu`` on CUDA tensors and the plain version
(ref.py) on CPU tensors or when ``backend="torch"``.  The kernel takes the
model's (B, S, H, d) layout as it is and maps query head h to KV head
h // G, so the reference wrapper's ``repeat`` of K and V and its transposes
to (B*H, S, d) have no counterpart here.  Any S is taken (the ragged last
tile is masked); the reference's Pallas launcher asks for a multiple of
its block.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

BACKENDS = ("torch", "cuda")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 128

# kernel launches in this process (read and reset by chip_smoke.py)
launches = 0


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
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), B, S, H, Hkv, d,
                                 int(causal), DTYPE_CODES[q.dtype], stream)
    _build.check("flash_attention", rc)
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, backend: str = "cuda"
                    ) -> torch.Tensor:
    """q: (B, S, Hq, d); k, v: (B, S, Hkv, d) with Hq % Hkv == 0, one
    float dtype.  Softmax(q kᵀ / sqrt(d)) v with fp32 scores, running max,
    denominator and accumulator; masked scores are -1e30 and the
    denominator is floored at 1e-30.  Returns (B, S, Hq, d) in q's dtype."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown flash_attention backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "torch" or q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal)
