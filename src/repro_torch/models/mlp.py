"""Feed-forward layers (twin of ``repro/models/mlp.py``): the dense FFN
and the token-choice MoE (granite, qwen3-moe).

The MoE is the reference's ``gspmd`` dispatch, split in two steps:
``moe_route`` (router, softmax, top-k, renormalised gate values, the
Switch aux loss) and ``moe_experts`` (sort-based capacity dispatch: an
(E, cap, D) buffer gathered from the tokens, batched expert products,
combine).  Capacity and drops are the reference's bit for bit: the
stable sort by expert lets earlier flat (token, slot) indices win a full
expert.  The expert
products are batched matmuls, as the reference's ``einsum``s are (no
Pallas kernel stands behind them).  The combine adds each token's K
contributions one at a time in ascending expert order, in the compute
dtype, which is the order of the reference's scatter-add; it uses no
atomic adds, so its bits do not vary run to run on CUDA.

On a device mesh (``parallel/annotate.py``) the dispatch buffer takes the
reference's ``constrain_first`` annotations.

``MoEConfig.dispatch="shard_map"`` takes the reference's expert-parallel
branch under its condition (an ambient mesh with a 'model' axis that
divides E; otherwise the ``gspmd`` plan): tokens split over the batch
axes and replicated over 'model', each 'model' rank owning E/m
contiguous experts, routing local, assignments to other ranks' experts
sorted into a trash bucket, capacity per shard, local ``bmm``s, and the
partial outputs summed over 'model' once.  The aux loss is the mean over
the batch shards of each shard's Switch loss, the reference's (not the
global loss).  Both reductions are DTensor placements: the output is
``Partial`` over 'model', the aux loss a ``Partial`` sum of each rank's
share, each redistributed to ``Replicate``, so autograd gives each rank
the cotangent JAX's transposes give (``Partial("avg")`` is not used: its
backward hands every rank the whole cotangent, not its share).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.nn import at_least_f32, tracing
from ..parallel import local_shards
from ..parallel.annotate import (BATCH, MODEL, constrain_first, get_mesh,
                                 replicated)
from .common import dense_init, gated_act, gelu
from .config import MoEConfig


# ------------------------------------------------------------------ dense
def init_dense_ffn(gen: torch.Generator, d_model: int, d_ff: int, act: str,
                   dtype=torch.float32) -> dict:
    if act in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d_model, d_ff, dtype),
                "w_up": dense_init(gen, d_model, d_ff, dtype),
                "w_down": dense_init(gen, d_ff, d_model, dtype)}
    return {"w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype)}


def dense_ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if "w_gate" in params:
        h = gated_act(act, x @ params["w_gate"], x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return h @ params["w_down"]


# -------------------------------------------------------------------- MoE
def init_moe_ffn(gen: torch.Generator, d_model: int, cfg: MoEConfig,
                 act: str, dtype=torch.float32) -> dict:
    """The reference's layout: ``router`` (D, E) in float32 whatever
    ``dtype``; ``w_gate`` / ``w_up`` (E, D, F), ``w_down`` (E, F, D)."""
    E, F = cfg.n_experts, cfg.d_expert
    s_in = float(np.sqrt(1.0 / d_model).astype(np.float32))
    s_out = float(np.sqrt(1.0 / F).astype(np.float32))

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=dtype)
    return {"router": dense_init(gen, d_model, E, torch.float32),
            "w_gate": normal(E, d_model, F) * s_in,
            "w_up": normal(E, d_model, F) * s_in,
            "w_down": normal(E, F, d_model) * s_out}


class Route(NamedTuple):
    probs: torch.Tensor     # (T, E) router probabilities, fp32
    gate: torch.Tensor      # (T, K) gate values, renormalised over the K
    experts: torch.Tensor   # (T, K) chosen experts, by falling probability
    aux: torch.Tensor       # () Switch load-balancing loss


def moe_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Rows of each expert's buffer: the reference's expression, Python's
    ``round`` (half to even) included."""
    return int(max(1, round(n_tokens * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def moe_route(params: dict, xf: torch.Tensor, cfg: MoEConfig,
              experts: torch.Tensor | None = None) -> Route:
    """Router, softmax, top-k and the aux loss for ``xf`` (T, D).  The
    logits are fp32 (the router cast to the compute dtype, then both
    operands upcast: JAX's promotion).  ``experts`` (T, K) forces the
    choices; the gate values are then this router's probabilities at
    them, renormalised the same way."""
    T = xf.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(at_least_f32(xf) @ at_least_f32(params["router"]),
                          dim=-1)
    if experts is None:
        gate, experts = torch.topk(probs, K, dim=-1)
    else:
        gate = probs.gather(-1, experts)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch aux loss: mean probability x share of assignments, per expert;
    # the counts by comparison (exact, no scatter)
    counts = (experts.reshape(-1, 1)
              == torch.arange(E, device=xf.device)).sum(0)
    aux = E * (probs.mean(0) * (counts.to(probs.dtype) / (T * K))).sum()
    return Route(probs, gate, experts, aux)


class Slots(NamedTuple):
    order: torch.Tensor     # (T*K,) flat (token, slot) indices by expert
    keep: torch.Tensor      # (T*K,) in that order: within its capacity
    slot: torch.Tensor      # (T*K,) in that order: its buffer row
    source: torch.Tensor    # (E*cap,) each buffer row's token, T if empty


def moe_slots(experts: torch.Tensor, n_experts: int, cap: int) -> Slots:
    """The dispatch plan of the (T, K) choices ``experts``: the flat
    (token, slot) indices sorted by expert, stably, each kept when it is
    among the first ``cap`` of its expert; its row of the (E * cap)
    buffer; and, the other way round, the token each buffer row holds."""
    T, K = experts.shape
    dev = experts.device
    se, order = torch.sort(experts.reshape(-1), stable=True)
    ids = torch.arange(n_experts, device=dev)
    starts = torch.searchsorted(se, ids)
    counts = torch.searchsorted(se, ids, right=True) - starts
    pos = torch.arange(T * K, device=dev) - starts[se]
    c = torch.arange(cap, device=dev)
    at = (starts[:, None] + c).clamp(max=T * K - 1)
    source = torch.where(c < counts[:, None], order[at] // K, T)
    return Slots(order, pos < cap, se * cap + pos.clamp(0, cap - 1),
                 source.reshape(-1))


def _weigh_kept(keep, w, rows):
    """(N, D) ``rows`` times (N,) ``w``, a dropped row (``keep`` False)
    zero: one product with the masked weights.  Traced by the graph
    importer it is the reference's form, the product and then a ``where``
    over the rows, whose gradient reads the forward ``where`` (the same
    values, and the critical path of the reference's graph)."""
    if tracing():
        return torch.where(keep[:, None], w[:, None].to(rows.dtype) * rows,
                           0.0)
    # a dropped assignment's weight is 0: its (finite) row adds nothing
    return (w * keep)[:, None].to(rows.dtype) * rows


def moe_experts(params: dict, xf: torch.Tensor, route: Route,
                cfg: MoEConfig, act: str) -> torch.Tensor:
    """Capacity dispatch, the experts and the combine for ``xf`` (T, D)
    routed by ``route`` -> (T, D) in ``xf``'s dtype.  No host sync and no
    scatter: the buffer is gathered from ``xf`` and a zero row."""
    # expert-parallel dispatch on a mesh: the buffer's experts over
    # 'model' when E divides it, else (the 'token_parallel' fallback) its
    # capacity; no-ops without a mesh
    dims = (0, 1) if cfg.fallback == "token_parallel" else (0,)
    return _dispatch(params, xf, route.gate, route.experts, cfg.n_experts,
                     moe_capacity(xf.shape[0], cfg), act, dims)


def _dispatch(params, xf, gate, experts, n_experts: int, cap: int, act: str,
              dims=None, trash: bool = False) -> torch.Tensor:
    """Buffer, expert products and combine of ``xf`` (T, D) for the (T,
    K) choices ``experts`` of ``params``' ``n_experts`` experts.  With
    ``trash`` a choice may equal ``n_experts`` (another rank's expert: the
    trash bucket), which is never kept.  ``dims``: the buffer's
    ``constrain_first`` dims, or None (a rank's local dispatch)."""
    T, D = xf.shape
    K = experts.shape[1]
    plan = moe_slots(experts, n_experts + int(trash), cap)
    keep, slot, src = plan.keep, plan.slot, plan.source
    if trash:
        keep = keep & (experts.reshape(-1)[plan.order] < n_experts)
        slot = torch.where(keep, slot, 0)
        src = src[:n_experts * cap]

    def annotate(t):
        return t if dims is None else constrain_first(t, MODEL, dims)
    buf = annotate(torch.cat([xf, xf.new_zeros(1, D)])[src].view(
        n_experts, cap, D))
    h = gated_act(act if act in ("swiglu", "geglu") else "swiglu",
                  torch.bmm(buf, params["w_gate"]),
                  torch.bmm(buf, params["w_up"]))
    out = annotate(torch.bmm(h, params["w_down"])).reshape(
        n_experts * cap, D)

    contrib = _weigh_kept(keep, gate.reshape(-1)[plan.order], out[slot])
    # each token's K rows of the sorted order, ascending = by expert
    rank = torch.empty_like(plan.order)
    rank[plan.order] = torch.arange(T * K, device=xf.device)
    rows = rank.view(T, K).sort(-1).values
    y = contrib[rows[:, 0]]
    for j in range(1, K):
        y = y + contrib[rows[:, j]]
    return y


def shard_map_applies(cfg: MoEConfig, mesh) -> bool:
    """The reference's condition for its ``shard_map`` branch."""
    if cfg.dispatch != "shard_map" or mesh is None:
        return False
    names = tuple(mesh.mesh_dim_names or ())
    return MODEL in names and cfg.n_experts % mesh.size(
        names.index(MODEL)) == 0


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str):
    """x: (B, S, D) -> ((B, S, D), aux load-balancing loss)."""
    mesh = get_mesh()
    if shard_map_applies(cfg, mesh):
        return _moe_ffn_shard_map(params, x, cfg, act, mesh)
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    route = moe_route(params, xf, cfg)
    return moe_experts(params, xf, route, cfg, act).view(B, S, D), route.aux


class LocalPlan(NamedTuple):
    """One rank's view of the ``shard_map`` dispatch (``local_plan``)."""
    route: Route            # its tokens' routing over all E experts
    experts: torch.Tensor   # (T, K) its local expert ids, n_local = trash
    n_local: int            # its experts
    cap: int                # its capacity

    def kept_dropped(self) -> tuple[int, int]:
        """(kept, dropped) of its own experts' assignments (a host
        read)."""
        own = torch.bincount(self.experts.reshape(-1),
                             minlength=self.n_local + 1)[:self.n_local]
        kept = int(own.clamp(max=self.cap).sum())
        return kept, int(own.sum()) - kept


def local_plan(params: dict, xf: torch.Tensor, cfg: MoEConfig, first: int,
               n_local: int) -> LocalPlan:
    """The routing and dispatch plan of one shard's tokens ``xf`` (T, D)
    on the rank owning experts [first, first + n_local)."""
    route = moe_route(params, xf, cfg)
    e = route.experts
    mine = (e >= first) & (e < first + n_local)
    return LocalPlan(route, torch.where(mine, e - first, n_local), n_local,
                     moe_capacity(xf.shape[0], cfg))


def _moe_ffn_shard_map(params: dict, x, cfg: MoEConfig, act: str, mesh):
    """The reference's ``_moe_ffn_shard_map`` on DTensors (plain
    arguments are taken as replicated).  Per rank: its batch shard of the
    tokens, the whole router, its E/m experts; routing, softmax and
    top-k on its tokens; its own experts' assignments bucketed at the
    shard's capacity round(T_loc K / E * factor), the rest into the
    trash; local products and combine; the partial outputs summed over
    'model'.  aux: each shard's Switch loss, meaned over the batch
    shards.  Gradients: x's and the router's are each rank's partial
    sums (over 'model'; the router's over every axis), the experts'
    partial over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = list(mesh.mesh_dim_names)
    mi = names.index(MODEL)
    m = mesh.size(mi)
    n_local = cfg.n_experts // m
    # the batch axes that split anything (a mesh dim of one rank is
    # replicated: DTensor cannot view a split dim of size 1)
    batch = [i for i, a in enumerate(names)
             if a in BATCH and mesh.size(i) > 1]
    n_batch = 1
    for i in batch:
        n_batch *= mesh.size(i)
    B, S, D = x.shape
    dims = range(mesh.ndim)
    xp = [Shard(0) if i in batch else Replicate() for i in dims]
    wp = [Shard(0) if i == mi else Replicate() for i in dims]
    partial = [Partial()] * mesh.ndim
    # x's gradient: each 'model' rank's share (its experts) summed
    x_grad = [Shard(0) if i in batch else (Partial() if i == mi
                                            else Replicate()) for i in dims]

    x_l = local_shards.laid_out(replicated(x, mesh), xp).to_local(
        grad_placements=x_grad)
    router = local_shards.laid_out(replicated(params["router"], mesh),
                                   [Replicate()] * mesh.ndim).to_local(
        grad_placements=partial)
    w = {k: local_shards.laid_out(replicated(params[k], mesh), wp).to_local(
        grad_placements=[Shard(0) if i == mi else Partial() for i in dims])
        for k in ("w_gate", "w_up", "w_down")}

    Bl = x_l.shape[0]
    xf = x_l.reshape(Bl * S, D)
    plan = local_plan({"router": router}, xf, cfg,
                      mesh.get_coordinate()[mi] * n_local, n_local)
    y = _dispatch(w, xf, plan.route.gate, plan.experts, n_local, plan.cap,
                  act, trash=True)
    y = local_shards.wrap(y.view(Bl, S, D), mesh, x_grad, (B, S, D))
    # each rank's share of the mean over batch shards (the 'model' ranks
    # hold equal copies): a sum of powers-of-two fractions, exact as the
    # reference's pmean for the meshes' sizes
    aux = local_shards.wrap(plan.route.aux / (n_batch * m), mesh, partial,
                            ())
    return (y.redistribute(mesh, xp),
            aux.redistribute(mesh, [Replicate()] * mesh.ndim))
