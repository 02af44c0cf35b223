"""Public wrapper: batched WC-oracle trip step (twin of
``repro/kernels/wc_oracle/ops.py::wc_step``).

``wc_step(run, rows, ridx)`` runs the CUDA kernel ``csrc/wc_oracle.cu``
on CUDA tensors and the plain version (ref.py) on CPU tensors or when
``backend="torch"``.  The kernel takes the (B, R, 6) table as it is: the
reference wrapper's transpose to (B, 8, Rp) and lane padding to 128 are
TPU tiling and have no counterpart here.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import wc_step_ref

BACKENDS = ("torch", "cuda")

# kernel launches in this process (read and reset by chip_smoke.py)
launches = 0


def _launch(run, rows, ridx):
    global launches
    B, R, _ = run.shape
    K = ridx.shape[1]
    for name, t, dtype, shape in (("run", run, torch.float32, (B, R, 6)),
                                  ("rows", rows, torch.float32, (B, K, 6)),
                                  ("ridx", ridx, torch.int32, (B, K))):
        if (t.device != run.device or t.dtype != dtype
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"wc_oracle: {name} must be contiguous {dtype} "
                             f"{shape} on {run.device}")
    out = torch.empty_like(run)
    rho = torch.empty(B, dtype=torch.int32, device=run.device)
    e1 = torch.empty(B, dtype=torch.float32, device=run.device)
    if B == 0:
        return out, rho, e1
    if R == 0:
        raise ValueError("wc_oracle: the running table needs R >= 1 rows")
    lib = _build.load("wc_oracle")
    stream = torch.cuda.current_stream(run.device).cuda_stream
    rc = lib.wc_oracle_step(run.data_ptr(), rows.data_ptr(), ridx.data_ptr(),
                            out.data_ptr(), rho.data_ptr(), e1.data_ptr(),
                            B, R, K, stream)
    _build.check("wc_oracle", rc)
    launches += 1
    return out, rho, e1


def wc_step(run: torch.Tensor, rows: torch.Tensor, ridx: torch.Tensor,
            backend: str = "cuda"):
    """run: (B, R, 6) f32 running table; rows: (B, K, 6) f32 start rows;
    ridx: (B, K) int32 target row per start row, -1 drops.
    Returns (run_out (B, R, 6), rho (B,) int32, e1 (B,) f32)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown wc_oracle backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    if backend == "torch" or run.device.type == "cpu":
        return wc_step_ref(run, rows, ridx)
    if run.device.type != "cuda":
        raise ValueError(f"wc_oracle: unsupported device {run.device}")
    return _launch(run, rows, ridx)
