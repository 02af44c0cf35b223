"""ASSIGN, paper Alg. 3 / Fig. 2 (twin of ``repro/core/assign.py``).

One episode places every vertex: SEL picks a candidate vertex, PLC picks
its device, and the ETF estimator updates the dynamic device features.
The GNN runs once per episode; each step evaluates the small PLC head
plus a masked softmax over the precomputed SEL logits.

The reference's per-episode ``lax.scan`` (vmapped over K episodes)
becomes a Python loop over the n steps with the K episodes as a
written-out leading batch axis; the episode state is updated in place.

Three modes, as in the reference:
  * sampled (``greedy=False``): ``argmax(logp + gumbel)`` per pick, and
    with probability eps a uniform pick over the candidates instead
    (``argmax`` of an explore gumbel row over them);
  * greedy: pure argmax;
  * forced replay (``forced_actions``): the given (vertex, device) steps.
Draws are either injected as step-major tables or drawn per step from
the caller's ``torch.Generator`` (gumbel = -log(-log U)).  Six tables
``(g_sel (n,K,n), g_plc (n,K,nd), u_sel (n,K), u_plc (n,K), e_sel
(n,K,n), e_plc (n,K,nd))`` replay the reference's ``rollout``: each
pick splits its key in three (policy gumbel, explore gumbel, explore
uniform), and ``e_*`` are the rows of the second key.  Four tables (no
``e_*``) are the layout of the reference's fused
``train_fused._episode_rng_tables``, whose sampler has no explore key:
the explore branch reuses the policy draw's gumbel row, exactly as
``train_fused._sample_scan`` samples.  The generator draws its own
explore rows, as the reference's key does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.gnn_mp.ref import CSR, build_csr
from .device import resolve_device
from .devices import DeviceModel
from .features import (COMM_FACTOR_DEFAULT, compute_fleet_features,
                       compute_static_features)
from .graph import DataflowGraph
from .nn import (argmax_first, argmin_first, masked_entropy,
                 masked_log_softmax)
from .policies import episode_encodings, plc_logits

BIG = 1e30


@dataclasses.dataclass
class GraphData:
    """Static per-(graph, fleet) tensors on one device."""
    x: torch.Tensor            # (n, 5) normalized static features
    edges: torch.Tensor        # (m, 2) int64
    edge_feat: torch.Tensor    # (m, 1) normalized comm cost
    b_path: torch.Tensor       # (n, Lb) int64, -1 padded
    t_path: torch.Tensor       # (n, Lt)
    preds: torch.Tensor        # (n, P) int64, -1 padded
    succs: torch.Tensor        # (n, S) int64, -1 padded
    exec_time: torch.Tensor    # (n, nd) seconds (0 for inputs)
    xfer_lat: torch.Tensor     # (nd, nd)
    xfer_spb: torch.Tensor     # (nd, nd) seconds per byte
    out_bytes: torch.Tensor    # (n,)
    flops: torch.Tensor        # (n,)
    total_flops: torch.Tensor  # ()
    t_level: torch.Tensor      # (n,) raw t-level cost (CP-ablation select)
    dev_x: torch.Tensor        # (nd, N_FLEET_FEATS) static fleet descriptors
    csr: tuple[CSR, CSR]       # edges grouped by dst and by src (gnn_mp)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def nd(self) -> int:
        return self.exec_time.shape[1]


def _pad_lists(lists, fill=-1):
    L = max(max((len(l) for l in lists), default=0), 1)
    out = np.full((len(lists), L), fill, dtype=np.int64)
    for i, l in enumerate(lists):
        out[i, :len(l)] = l
    return out


def build_graph_data(g: DataflowGraph, dev: DeviceModel,
                     comm_factor: float = COMM_FACTOR_DEFAULT,
                     device: str | torch.device = "cuda") -> GraphData:
    """Features and costs in numpy float64 (as the reference), stored as
    float32 tensors on ``device``, plus the CSR of both edge directions."""
    device = resolve_device(device)
    sf = compute_static_features(g, comm_factor)
    n = g.n
    flops = g.flops_array()
    exec_t = np.zeros((n, dev.n))
    for v in range(n):
        if not g.is_input(v):
            exec_t[v] = dev.exec_overhead + flops[v] / dev.flops_per_sec
    spb = 1.0 / dev.link_bw
    np.fill_diagonal(spb, 0.0)
    edge_feat = (sf.edge_cost_norm[:, None] if g.m else np.zeros((0, 1)))

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    edges = i64(g.edge_array().reshape(-1, 2))
    return GraphData(
        x=f32(sf.x_norm), edges=edges, edge_feat=f32(edge_feat),
        b_path=i64(sf.b_path), t_path=i64(sf.t_path),
        preds=i64(_pad_lists(g.preds)), succs=i64(_pad_lists(g.succs)),
        exec_time=f32(exec_t), xfer_lat=f32(dev.link_latency),
        xfer_spb=f32(spb), out_bytes=f32(g.out_bytes_array()),
        flops=f32(flops), total_flops=f32(max(flops.sum(), 1e-9)),
        t_level=f32(sf.t_level), dev_x=f32(compute_fleet_features(dev)),
        csr=(build_csr(edges[:, 1], n), build_csr(edges[:, 0], n)))


def encode(params, gd: GraphData, backend: str = "torch"):
    """(H, sel_logits, z_plc) for ``gd``: the once-per-episode encodings."""
    return episode_encodings(params, gd.x, gd.edges, gd.edge_feat,
                             gd.b_path, gd.t_path, backend=backend,
                             csr=gd.csr)


# --------------------------------------------------------------- dynamics
def _device_features(gd: GraphData, v, placed, assigned, est_end,
                     device_avail, dev_comp):
    """[X_D || X_F] for target vertices v (K,) — (K, nd, 5 + N_FLEET_FEATS)
    — and the raw per-device ready time f3 (K, nd) the update reuses."""
    K, nd = v.shape[0], gd.nd
    p = gd.preds[v]                                   # (K, P)
    ps = p.clamp(min=0)
    pm = (p >= 0) & placed.gather(1, ps)              # placed preds
    src = assigned.gather(1, ps)                      # device of each pred
    # arrival time of each pred's result on each device: (K, P, nd)
    arr = (est_end.gather(1, ps)[..., None] + gd.xfer_lat[src]
           + gd.out_bytes[ps][..., None] * gd.xfer_spb[src])
    arr_min = torch.where(pm[..., None], arr, BIG).amin(1)
    arr_max = torch.where(pm[..., None], arr, -BIG).amax(1)
    any_pred = pm.any(1)[:, None]
    f2 = torch.where(any_pred, arr_min, 0.0)
    f3 = torch.where(any_pred, arr_max, 0.0)
    f4 = torch.maximum(device_avail, f3)
    vals = torch.where(pm, gd.flops[ps], 0.0)
    if v.is_cuda:
        # scatter_add_ adds colliding floats atomically on CUDA, so its
        # bits vary run to run; a one-hot sum over the preds does not
        onehot = src[..., None] == torch.arange(nd, device=v.device)
        pred_flops_on = torch.where(onehot, vals[..., None], 0.0).sum(1)
    else:
        # in pred order, as the reference's segment_sum; the CPU's sum of
        # the one-hot would add through interleaved accumulators instead
        pred_flops_on = torch.zeros(K, nd).scatter_add_(1, src, vals)
    scale = torch.clamp(torch.maximum(device_avail.amax(1), f4.amax(1)),
                        min=1e-9)[:, None]
    feats = torch.stack([dev_comp / gd.total_flops,
                         pred_flops_on / gd.total_flops,
                         f2 / scale, f3 / scale, f4 / scale], dim=2)
    feats = torch.cat([feats, gd.dev_x.expand(K, nd, -1)], dim=2)
    return feats, f3


@dataclasses.dataclass
class _State:
    """Per-episode ETF state for K episodes, updated in place."""
    placed: torch.Tensor            # (K, n) bool
    assigned: torch.Tensor          # (K, n) int64
    est_end: torch.Tensor           # (K, n)
    device_avail: torch.Tensor      # (K, nd)
    dev_comp: torch.Tensor          # (K, nd)
    unassigned_preds: torch.Tensor  # (K, n + 1) int64; slot n = trash
    dev_hsum: torch.Tensor          # (K, nd, dh)
    dev_cnt: torch.Tensor           # (K, nd)

    @classmethod
    def initial(cls, gd: GraphData, K: int, dh: int) -> "_State":
        n, nd, dev = gd.n, gd.nd, gd.x.device
        n_preds = (gd.preds >= 0).sum(1)
        return cls(
            placed=torch.zeros(K, n, dtype=torch.bool, device=dev),
            assigned=torch.zeros(K, n, dtype=torch.long, device=dev),
            est_end=torch.zeros(K, n, device=dev),
            device_avail=torch.zeros(K, nd, device=dev),
            dev_comp=torch.zeros(K, nd, device=dev),
            unassigned_preds=torch.cat(
                [n_preds, n_preds.new_zeros(1)]).expand(K, n + 1).clone(),
            dev_hsum=torch.zeros(K, nd, dh, device=dev),
            dev_cnt=torch.zeros(K, nd, device=dev))


def _etf_update(gd: GraphData, v, d, ready_d, st: _State) -> None:
    """Commit vertex v (K,) to device d (K,) in every episode."""
    k = torch.arange(v.shape[0], device=v.device)
    end = torch.maximum(st.device_avail[k, d], ready_d) + gd.exec_time[v, d]
    st.est_end[k, v] = end
    st.device_avail[k, d] = end
    st.dev_comp[k, d] += gd.flops[v]
    st.placed[k, v] = torch.ones_like(v, dtype=torch.bool)  # no host copy
    st.assigned[k, v] = d
    s = gd.succs[v]
    sm = s >= 0
    st.unassigned_preds.scatter_add_(1, torch.where(sm, s, gd.n),
                                     -sm.long())


# ---------------------------------------------------------------- rollout
def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u))


def _episodes(params, gd: GraphData, K: int, enc, eps: float, greedy: bool,
              forced, draws, generator, sel_mode: str, plc_mode: str):
    n, nd = gd.n, gd.nd
    H, sel_logits, z_plc = enc
    dev = H.device
    k = torch.arange(K, device=dev)
    st = _State.initial(gd, K, H.shape[1])
    sampled = forced is None and not greedy
    if sampled and draws is None and generator is None:
        raise ValueError("a sampled rollout needs injected draws or a "
                         "torch.Generator")
    if draws is not None:
        if len(draws) not in (4, 6):
            raise ValueError(f"draws are 4 or 6 step-major tables, not "
                             f"{len(draws)}")
        tables = [torch.as_tensor(x, device=dev) for x in draws]
        g_sel, g_plc, u_sel, u_plc = tables[:4]
        # four tables: the explore branch reuses the policy's gumbel rows
        e_sel, e_plc = tables[4:] if len(tables) == 6 else (g_sel, g_plc)
        for name, t, want in (("g_sel", g_sel, (n, K, n)),
                              ("g_plc", g_plc, (n, K, nd)),
                              ("e_sel", e_sel, (n, K, n)),
                              ("e_plc", e_plc, (n, K, nd))):
            if t.shape != want:
                raise ValueError(f"draws must be step-major: {name} is "
                                 f"{tuple(t.shape)}, not {want}")
    dmask = torch.ones(K, nd, dtype=torch.bool, device=dev)
    outs = {key: [] for key in ("v", "d", "logp_v", "logp_d", "ent_v",
                                "ent_d")}
    for s in range(n):
        cand = ~st.placed & (st.unassigned_preds[:, :n] == 0)
        logp_v = masked_log_softmax(sel_logits.expand(K, n), cand)
        if sampled:
            if draws is not None:
                gs, gp, us, up = g_sel[s], g_plc[s], u_sel[s], u_plc[s]
                es, ep = e_sel[s], e_plc[s]
            else:
                gs, gp = _gumbel(generator, (K, n)), _gumbel(generator,
                                                             (K, nd))
                us = torch.rand(K, generator=generator, device=dev)
                up = torch.rand(K, generator=generator, device=dev)
                es, ep = _gumbel(generator, (K, n)), _gumbel(generator,
                                                             (K, nd))
        if forced is not None:
            v = forced[:, s, 0]
        elif sel_mode == "cp":
            v = argmax_first(torch.where(cand, gd.t_level, -BIG))
        elif greedy:
            v = argmax_first(logp_v)
        else:
            v_soft = argmax_first(logp_v + gs)
            # == categorical(k2, where(cand, 0, -inf)): uniform over the
            # candidates
            v_unif = argmax_first(torch.where(cand, es, -torch.inf))
            v = torch.where(us < eps, v_unif, v_soft)

        x_dev, ready = _device_features(gd, v, st.placed, st.assigned,
                                        st.est_end, st.device_avail,
                                        st.dev_comp)
        h_dev = st.dev_hsum / torch.clamp(st.dev_cnt[..., None], min=1.0)
        logits_d = plc_logits(params, H[v], h_dev, x_dev, z_plc[v])
        logp_d = masked_log_softmax(logits_d, dmask)
        if forced is not None:
            d = forced[:, s, 1]
        elif plc_mode == "etf":
            d = argmin_first(torch.maximum(st.device_avail, ready)
                             + gd.exec_time[v])
        elif greedy:
            d = argmax_first(logp_d)
        else:
            d = torch.where(up < eps, argmax_first(ep),
                            argmax_first(logp_d + gp))

        outs["v"].append(v)
        outs["d"].append(d)
        outs["logp_v"].append(logp_v[k, v])
        outs["logp_d"].append(logp_d[k, d])
        outs["ent_v"].append(masked_entropy(sel_logits.expand(K, n), cand))
        outs["ent_d"].append(masked_entropy(logits_d, dmask))
        _etf_update(gd, v, d, ready[k, d], st)
        st.dev_hsum[k, d] += H[v]
        st.dev_cnt[k, d] += 1.0

    cols = {key: torch.stack(val, 1) for key, val in outs.items()}
    return {"order": cols["v"], "devices": cols["d"],
            "actions": torch.stack([cols["v"], cols["d"]], 2),
            "assignment": st.assigned,
            "sel_logp": cols["logp_v"], "plc_logp": cols["logp_d"],
            "sel_ent": cols["ent_v"], "plc_ent": cols["ent_d"],
            "est_makespan": st.device_avail.amax(1)}


def rollout_batch(params, gd: GraphData, K: int, eps: float = 0.0,
                  draws=None, generator: torch.Generator | None = None,
                  greedy: bool = False, forced_actions=None,
                  sel_mode: str = "learned", plc_mode: str = "learned",
                  encoder_backend: str = "torch", enc=None):
    """K episodes with a leading batch axis.  ``forced_actions`` (K, n, 2)
    replays given steps; ``draws`` are the injected step-major tables
    (six, or the fused sampler's four: the module docstring);
    ``enc`` reuses precomputed ``encode(...)`` output.

    Returns a dict: order, devices (K, n), actions (K, n, 2), assignment
    (K, n), per-step sel_logp / plc_logp / sel_ent / plc_ent (K, n) and
    est_makespan (K,)."""
    if enc is None:
        enc = encode(params, gd, encoder_backend)
    if forced_actions is not None:
        forced_actions = torch.as_tensor(forced_actions, dtype=torch.long,
                                         device=gd.x.device)
    return _episodes(params, gd, K, enc, eps, greedy, forced_actions,
                     draws, generator, sel_mode, plc_mode)


def rollout(params, gd: GraphData, eps: float = 0.0, greedy: bool = False,
            forced_actions=None, draws=None,
            generator: torch.Generator | None = None,
            sel_mode: str = "learned", plc_mode: str = "learned",
            encoder_backend: str = "torch", enc=None):
    """One episode: ``rollout_batch`` with K = 1, batch axis removed
    (``forced_actions`` (n, 2); ``draws`` still carry a K = 1 axis)."""
    if forced_actions is not None:
        forced_actions = torch.as_tensor(forced_actions)[None]
    out = rollout_batch(params, gd, 1, eps, draws, generator, greedy,
                        forced_actions, sel_mode, plc_mode,
                        encoder_backend, enc)
    return {key: val[0] for key, val in out.items()}
