"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for and none is present (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           f"not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
