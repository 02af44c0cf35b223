"""Grouped-query attention, plain PyTorch (twin of
``repro/models/attention.py``): full, chunked over query blocks, and
KV-cache decode.

The model's train and prefill paths call the flash-attention kernel
(``kernels/flash_attention/ops.py``), the one attention call of prefill;
``gqa_attention`` (the plain core, kept beside the kernel in its
``ref.py``) and ``chunked_attention`` are the plain twins the tests hold
it against.  Decode attention has no kernel in the JAX package and stays
plain here.

Two numerics modes, as in the reference:
  * mixed=False: q, k, v upcast to fp32 before the score / value products.
  * mixed=True: bf16 products with fp32 accumulation.  bf16 products are
    exact in fp32, so this is the fp32 product on the upcast inputs, with
    the probabilities rounded to v's dtype before the value product.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ref import _scores_softmax_out, gqa_attention


def chunked_attention(q, k, v, *, chunk: int = 512, causal: bool = True,
                      softcap: float = 0.0, mixed: bool = False):
    """A loop over query chunks: peak memory O(chunk x T) rather than
    O(S x T).  The flash-attention kernel computes the same function."""
    B, S, Hq, hd = q.shape
    if S <= chunk:
        return gqa_attention(q, k, v, causal=causal, softcap=softcap,
                             mixed=mixed)
    assert S % chunk == 0, (S, chunk)
    T = k.shape[1]
    kpos = torch.arange(T, device=q.device)
    outs = []
    for c0 in range(0, S, chunk):
        qc = q[:, c0:c0 + chunk]
        if causal:
            qpos = c0 + torch.arange(chunk, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
        else:
            mask = torch.ones(chunk, T, dtype=torch.bool, device=q.device)
        qg = qc.reshape(B, chunk, k.shape[2], Hq // k.shape[2], hd)
        outs.append(_scores_softmax_out(qg, k, v, mask, softcap, mixed)
                    .reshape(B, chunk, Hq, hd))
    return torch.cat(outs, dim=1)


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
