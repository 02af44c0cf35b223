"""Shared model components: norms, RoPE, activations, init helpers (twin of
``repro/models/common.py``).

Init helpers draw from an explicit ``torch.Generator``: torch's Philox
stream differs from JAX's threefry, so parity tests carry the reference's
parameters across (``models/convert.py``) instead of re-drawing them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.nn import at_least_f32, tree_map

IGNORE_ID = -1          # a label position the loss skips

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def _normal(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), dtype) * float(
        np.sqrt(1.0 / d_in).astype(np.float32))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return _normal(gen, (vocab, d), dtype) * 0.02


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
             eps: float = 1e-6) -> torch.Tensor:
    xf = at_least_f32(x)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + at_least_f32(scale))
    return y.to(x.dtype)


def nonparametric_layernorm(x: torch.Tensor, eps: float = 1e-6
                            ) -> torch.Tensor:
    """OLMo-style LayerNorm without learned scale/bias."""
    xf = at_least_f32(x)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, scale=None) -> torch.Tensor:
    if kind == "nonparametric":
        return nonparametric_layernorm(x)
    return rms_norm(x, scale)


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    split-halves layout: the first hd/2 channels rotate with the second."""
    hd = x.shape[-1]
    xf = at_least_f32(x)
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=xf.dtype,
                            device=x.device)
    ang = positions[..., None].to(xf.dtype) * freqs        # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xf.chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gated_act(kind: str, gate: torch.Tensor, up: torch.Tensor
              ) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return gelu(gate) * up
    raise ValueError(kind)


def cast_block_params(p, dtype: torch.dtype, stacked: bool = False):
    """Mixed-precision policy: float32 matrices go to the compute dtype,
    vectors and scalars (norm scales, ``A_log``, ``dt_bias``, ``D_skip``)
    stay float32.  ``stacked`` marks leaves with a leading repetition
    axis, which does not count towards a matrix's rank.  Casting once at
    load gives the same values as the reference's cast at every use; a
    leaf already in ``dtype`` is returned as it is."""
    def cast(x):
        if (isinstance(x, torch.Tensor) and x.dtype == torch.float32
                and x.ndim - int(stacked) >= 2):
            return x.to(dtype)
        return x
    return tree_map(cast, p)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Mean token cross-entropy in fp32 (fp64 logits stay fp64) over the
    labels that are not ``ignore_id``, the count floored at 1.  logits
    (..., V), labels (...)."""
    logits = at_least_f32(logits)
    mask = labels != ignore_id
    gold = logits.gather(-1, torch.where(mask, labels, 0)[..., None].long())
    nll = torch.logsumexp(logits, dim=-1) - gold[..., 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
