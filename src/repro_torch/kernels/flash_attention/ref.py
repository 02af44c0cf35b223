"""Plain PyTorch version of the flash-attention kernel (twin of
``repro/kernels/flash_attention/ref.py::attention_ref``, in the model's
layout with the GQA mapping), and the plain attention core that the
model's ``models/attention.py`` builds on.

The CPU path and the card's comparisons use it; nothing on the card's
main path calls it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.nn import at_least_f32, scan

NEG_INF = -1e30


def _scores_softmax_out(q, k, v, mask, softcap: float = 0.0,
                        mixed: bool = False):
    """q: (B, C, Hkv, G, hd); k, v: (B, T, Hkv, hd); mask broadcastable to
    (B, Hkv, G, C, T).  Returns (B, C, Hkv, G, hd)."""
    hd = q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    s = torch.einsum("bckgh,btkh->bkgct", at_least_f32(q),
                     at_least_f32(k)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if mixed:
        p = p.to(v.dtype)
    out = torch.einsum("bkgct,btkh->bckgh", at_least_f32(p),
                       at_least_f32(v))
    return out.to(v.dtype)


def gqa_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  softcap: float = 0.0, mixed: bool = False):
    """Full-matrix GQA.  q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd)."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, hd)
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)
        mask = qpos[:, None] >= torch.arange(T, device=q.device)[None, :]
    else:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    out = _scores_softmax_out(qg, k, v, mask, softcap, mixed)
    return out.reshape(B, S, Hq, hd)


def chunked_attention(q, k, v, *, chunk: int = 512, causal: bool = True,
                      softcap: float = 0.0, mixed: bool = False):
    """A loop over query chunks: peak memory O(chunk x T) rather than
    O(S x T).  The flash-attention kernel computes the same function."""
    B, S, Hq, hd = q.shape
    if S <= chunk:
        return gqa_attention(q, k, v, causal=causal, softcap=softcap,
                             mixed=mixed)
    assert S % chunk == 0, (S, chunk)
    loop = functools.partial(_query_chunks, chunk, causal, softcap, mixed)
    return scan(loop, k, v, q)[0]


def _query_chunks(chunk, causal, softcap, mixed, k, v, q):
    """The loop over query chunks -> (out,): the reference's ``lax.scan``
    (k and v its consts), marked as one loop for the graph importer."""
    B, S, Hq, hd = q.shape
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
    return (torch.cat(outs, dim=1),)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, mixed: bool = False) -> torch.Tensor:
    """q: (B, S, Hq, d); k, v: (B, S, Hkv, d) with Hq % Hkv == 0; query
    head h reads KV head h // G (G = Hq / Hkv), as the reference's
    ``repeat`` does.  Scores and softmax in fp32, scale 1/sqrt(d), masked
    scores -1e30; returns (B, S, Hq, d) in q's dtype.  This is
    ``gqa_attention``: in its fp32 mode, or with ``mixed`` the
    probabilities rounded to v's dtype before the product with v (the
    reference's ``attn_mixed_precision``)."""
    return gqa_attention(q, k, v, causal=causal, mixed=mixed)
