"""Gradient compression (twin of ``repro/train/compression.py``).

int8 quantization with one scale a tensor, as a ``grad_transform`` for
``models.steps.make_train_step``: quantize, then dequantize (on a fleet
the all-reduce would carry the int8 codes between the two), with optional
error feedback carrying the quantization residual to the next step.  On
one device nothing crosses a link, so the transform only changes the
gradients' values, as the reference's does on one host.

The arithmetic is the reference's as XLA compiles it inside the jitted
train step, bit for bit: the scale is max|x| floored at 1e-12, times the
float32 reciprocal of 127 (XLA turns the reference's division by the
constant 127 into that product; its eager form, a true division, can
differ in the scale's last bit); the codes are x / scale, a true division
by a tensor, rounded half to even and clipped to [-127, 127].
"""
from __future__ import annotations

import torch

from ..core.nn import tree_map


def int8_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 codes, the 0-d scale in x's dtype)."""
    top = torch.clamp(x.abs().max(), min=1e-12)
    scale = top * torch.tensor(1 / 127.0, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    q, s = int8_quantize(x)
    return int8_dequantize(q, s).to(x.dtype)


def make_int8_grad_transform():
    """Tree-wise int8 round trip (a compressed all-reduce's values)."""
    def transform(grads):
        return tree_map(quantize_dequantize, grads)
    return transform


class ErrorFeedbackCompressor:
    """EF-SGD: the residual g + r - Q(g + r) is carried to the next step.
    Its state sits beside the optimizer's (the same tree as the params)."""

    def init(self, params):
        return tree_map(torch.zeros_like, params)

    def compress(self, grads, residual):
        """-> (the dequantized corrected gradients, the new residual)."""
        corrected = tree_map(lambda g, r: g + r, grads, residual)
        return (tree_map(quantize_dequantize, corrected),
                tree_map(_residual, corrected))


def _residual(x: torch.Tensor) -> torch.Tensor:
    """x - Q(x) rounded once, as the reference's jitted step computes it
    (XLA fuses the product q * scale and the difference into a
    multiply-add): in float64 both are exact (q has 7 bits, and the
    difference is at most half a code), so one rounding to x's dtype
    remains."""
    q, scale = int8_quantize(x)
    return (x.double() - q.double() * scale.double()).to(x.dtype)
