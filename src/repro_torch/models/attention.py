"""Grouped-query attention, plain PyTorch (twin of
``repro/models/attention.py``): full, chunked over query blocks, and
KV-cache decode.

The model's train and prefill paths call the flash-attention kernel
(``kernels/flash_attention/ops.py``), the one attention call of prefill;
``gqa_attention`` and ``chunked_attention`` (the plain cores, kept beside
the kernel in its ``ref.py``; the wrapper's plain path is the chunked
one) are the plain twins the tests hold it against.  Decode attention
has no kernel in the JAX package and stays plain here.

Two numerics modes, as in the reference:
  * mixed=False: q, k, v upcast to fp32 before the score / value products.
  * mixed=True: bf16 products with fp32 accumulation.  bf16 products are
    exact in fp32, so this is the fp32 product on the upcast inputs, with
    the probabilities rounded to v's dtype before the value product.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ref import (  # noqa: F401
    _scores_softmax_out, chunked_attention, gqa_attention)


def decode_attention(q, k_cache, v_cache, pos, *, softcap: float = 0.0,
                     mixed: bool = False):
    """Single-step decode.  q: (B, 1, Hq, hd); caches: (B, T, Hkv, hd);
    pos: index of the current token (attends to [0..pos])."""
    B, _, Hq, hd = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, Hkv, Hq // Hkv, hd)
    mask = torch.arange(T, device=q.device) <= pos
    out = _scores_softmax_out(qg, k_cache, v_cache, mask, softcap, mixed)
    return out.reshape(B, 1, Hq, hd)
