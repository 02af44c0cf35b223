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
from ..parallel import local_shards
from ..parallel.annotate import is_dtensor, replicate_like

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


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  A DTensor table (a model on a device mesh) is
    looked up on each rank's local shards, laid out as GSPMD lays out the
    gather: a split of the vocab (dim 0) moves to the embedding dim where
    that divides (else it is gathered), the ids are gathered over the mesh
    dims that split the table and keep their own split elsewhere; the
    lookup and its gradient (a local ``index_put``, a partial sum where
    the ids are split) then need no rank to hold the whole table.  The
    same layout on every torch version (DTensor's own rule for the gather
    differs between them)."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tp = local_shards.layout(table, keep=(1,), to=1)
    ids = replicate_like(ids, table)
    col = [local_shards.is_shard(p, 1) for p in tp]
    ip = [Replicate() if c or not isinstance(p, Shard) else p
          for c, p in zip(col, ids.placements)]
    ids = local_shards.laid_out(ids, ip)
    grad = [Shard(1) if c else (Partial() if isinstance(p, Shard)
                                 else Replicate())
            for c, p in zip(col, ip)]
    local = local_shards.laid_out(table, tp).to_local(
        grad_placements=grad)[ids.to_local()]
    out = [Shard(ids.ndim) if c else p for c, p in zip(col, ip)]
    return local_shards.wrap(local, mesh, out,
                             (*ids.shape, table.shape[1]))


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
    # on a mesh the tables are replicated constants beside a DTensor x
    cos = replicate_like(torch.cos(ang)[..., None, :], xf)  # (..., S, 1, hd/2)
    sin = replicate_like(torch.sin(ang)[..., None, :], xf)
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
    (..., V), labels (...).  DTensor logits (a model on a device mesh)
    take ``_sharded_nll``."""
    logits = at_least_f32(logits)
    if is_dtensor(logits):
        nll, mask = _sharded_nll(logits, labels, ignore_id)
    else:
        mask = labels != ignore_id
        gold = logits.gather(-1, torch.where(mask, labels, 0)[..., None]
                             .long())
        nll = torch.logsumexp(logits, dim=-1) - gold[..., 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def _sharded_nll(logits, labels, ignore_id: int):
    """(nll, mask) of DTensor logits (..., V) as GSPMD partitions the
    loss: split over the vocab, each rank's logsumexp terms and gold
    logit from its own block of the vocab, reduced over the mesh dims
    that split it (the max, then the sum of exponentials and the gold
    logit as partial sums), so no rank gathers the logits; with whole
    rows on each rank, the one-device expressions on its rows.  The two
    results are laid out as the logits' other dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, V, vd = logits.device_mesh, logits.shape[-1], logits.ndim - 1
    lp = [p if isinstance(p, Shard) else Replicate()
          for p in logits.placements]
    vocab = [i for i, p in enumerate(lp)
             if local_shards.is_shard(p, vd) and mesh.size(i) > 1]
    rows = [Replicate() if i in vocab else p for i, p in enumerate(lp)]
    logits = local_shards.laid_out(logits, lp)
    labels = local_shards.laid_out(replicate_like(labels, logits), rows)

    def reduced(local, op="sum"):
        red = [Partial(op) if i in vocab else p for i, p in enumerate(rows)]
        t = local_shards.wrap(local, mesh, red, labels.shape)
        return t.redistribute(mesh, rows)
    x, lab = logits.to_local(), labels.to_local()
    mask = lab != ignore_id
    if not vocab:
        # each rank holds whole rows: the one-device expressions
        gold = x.gather(-1, torch.where(mask, lab, 0)[..., None].long())
        nll = torch.logsumexp(x, dim=-1) - gold[..., 0]
        return (local_shards.wrap(nll, mesh, rows, labels.shape),
                local_shards.wrap(mask, mesh, rows, labels.shape))
    m = reduced(x.detach().amax(-1), "max").to_local()
    sum_exp = reduced(torch.exp(x - m[..., None]).sum(-1)).to_local()
    first, n = local_shards.block(mesh, lp, vd, V)
    at = lab - first
    mine = mask & (at >= 0) & (at < n)
    gold = x.gather(-1, torch.where(mine, at, 0)[..., None].long())[..., 0]
    gold = reduced(torch.where(mine, gold, 0.0)).to_local()
    nll = m + torch.log(sum_exp) - gold
    return (local_shards.wrap(nll, mesh, rows, labels.shape),
            local_shards.wrap(mask, mesh, rows, labels.shape))
