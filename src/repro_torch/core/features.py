"""Copy of ``src/repro/core/features.py`` (the port imports nothing of ``repro``).

Graph features X_G and device features X_D — paper Appendix E.

Static graph features (n x 5, per vertex v):
  0. computation cost of v                       (FLOPs)
  1. sum of communication cost into v            (bytes * comm_factor)
  2. sum of communication cost out of v
  3. t-level cost: longest comp+comm path v -> exit   (paper's t-path)
  4. b-level cost: longest comp+comm path v -> entry  (paper's b-path)

Dynamic device features (n_dev x 5, per device d, at step h, given node v):
  0. total computation cost of nodes assigned to d so far
  1. total computation cost of v's predecessors assigned to d
  2. min over preds p of (est_end[p] + transfer_est(p -> d))
  3. max over preds p of (est_end[p] + transfer_est(p -> d))
  4. earliest start time for v on d = max(device_avail[d], feature 3)

The dynamic features are maintained by an ETF-style incremental estimator
(`EpisodeState`) so they can be recomputed each MDP step *without* any
message passing (§4.3's efficiency trick).

The paper's communication factor (bytes -> cost) is 4, calibrated against
their engine (App. E); we keep it as the default and expose it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .devices import DeviceModel
from .graph import DataflowGraph

COMM_FACTOR_DEFAULT = 4.0

# Static per-device fleet descriptors X_F (cross-graph serving, PR 6):
# the dynamic features X_D describe the episode, not the hardware — on a
# heterogeneous fleet every device looks identical at step 0, so a policy
# pretrained across fleets cannot prefer the fast devices zero-shot.
# X_F fixes that with fleet-normalized (scale-free) per-device columns:
#   0. compute rate          flops_per_sec / max fleet rate
#   1. launch overhead       exec_overhead / max fleet overhead
#   2. memory capacity       mem_bytes / max fleet capacity (1 if unmodeled)
#   3. mean outgoing link bw / max such mean over devices
#   4. mean incoming link bw / max such mean over devices
#   5. mean outgoing latency / max such mean over devices
N_FLEET_FEATS = 6


def compute_fleet_features(dev: DeviceModel) -> np.ndarray:
    """Per-device static hardware descriptors — (n_dev, N_FLEET_FEATS),
    normalized within the fleet so one policy reads any hardware."""
    n = dev.n
    off = ~np.eye(n, dtype=bool)
    bw = np.where(np.isfinite(dev.link_bw), dev.link_bw, 0.0)
    bw_out = np.where(off, bw, 0.0).sum(1) / max(n - 1, 1)
    bw_in = np.where(off, bw, 0.0).sum(0) / max(n - 1, 1)
    lat_out = np.where(off, dev.link_latency, 0.0).sum(1) / max(n - 1, 1)
    mem = (dev.mem_bytes if dev.mem_bytes is not None
           else np.ones(n))
    cols = [dev.flops_per_sec, dev.exec_overhead_vec, mem,
            bw_out, bw_in, lat_out]
    out = np.empty((n, N_FLEET_FEATS))
    for j, c in enumerate(cols):
        c = np.asarray(c, dtype=np.float64)
        out[:, j] = c / max(float(c.max()), 1e-30)
    return out


# ----------------------------------------------------------------- static
@dataclasses.dataclass
class StaticFeatures:
    x: np.ndarray              # (n, 5) raw features
    x_norm: np.ndarray         # (n, 5) column-normalized
    edge_cost: np.ndarray      # (m,) per-edge communication cost
    edge_cost_norm: np.ndarray
    b_path: np.ndarray         # (n, Lb) padded vertex ids of the b-path (-1 pad)
    t_path: np.ndarray         # (n, Lt) padded vertex ids of the t-path
    t_level: np.ndarray        # (n,)
    b_level: np.ndarray        # (n,)


def _normalize(x: np.ndarray) -> np.ndarray:
    scale = np.abs(x).max(axis=0, keepdims=True)
    scale = np.where(scale > 0, scale, 1.0)
    return x / scale


def compute_static_features(g: DataflowGraph,
                            comm_factor: float = COMM_FACTOR_DEFAULT
                            ) -> StaticFeatures:
    n = g.n
    flops = g.flops_array()
    out_bytes = g.out_bytes_array()
    E = g.edge_array().astype(np.int64)
    src, dst = E[:, 0], E[:, 1]

    edge_cost = out_bytes[src] * comm_factor
    comm_in = np.zeros(n)
    comm_out = np.zeros(n)
    # np.add.at accumulates in index order == edge order (matches the
    # per-edge loop it replaced bit-for-bit).
    np.add.at(comm_in, dst, edge_cost)
    np.add.at(comm_out, src, edge_cost)

    # CSR adjacency.  freeze() appends to succs/preds in deduped-edge
    # order, so a *stable* sort over g.edges reproduces the adjacency
    # order exactly — ties in the DP below break identically.
    def _csr(keys: np.ndarray, vals: np.ndarray):
        order = np.argsort(keys, kind="stable")
        indptr = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=n))])
        return indptr, vals[order]

    s_ptr, s_adj = _csr(src, dst)     # succs
    p_ptr, p_adj = _csr(dst, src)     # preds

    # cost of traversing vertex v then edge (v,w):
    # comp(v) + comm(v->w);  longest-path DP both directions.
    # t-level: v -> exit (forwards);  b-level: v -> entry (backwards).
    # np.argmax takes the first of equal maxima — same winner as the
    # strict-> scalar scan it replaced.
    t_level = np.zeros(n)
    t_next = np.full(n, -1, dtype=np.int64)      # successor on the t-path
    for v in reversed(g.topo_order):
        sw = s_adj[s_ptr[v]:s_ptr[v + 1]]
        best = 0.0
        if sw.size:
            cand = out_bytes[v] * comm_factor + t_level[sw]
            j = int(np.argmax(cand))
            if cand[j] > 0.0:
                best = cand[j]
                t_next[v] = sw[j]
        t_level[v] = flops[v] + best

    b_level = np.zeros(n)
    b_next = np.full(n, -1, dtype=np.int64)      # predecessor on the b-path
    for v in g.topo_order:
        pw = p_adj[p_ptr[v]:p_ptr[v + 1]]
        best = 0.0
        if pw.size:
            cand = out_bytes[pw] * comm_factor + b_level[pw]
            j = int(np.argmax(cand))
            if cand[j] > 0.0:
                best = cand[j]
                b_next[v] = pw[j]
        b_level[v] = flops[v] + best

    def walk(nxt: np.ndarray) -> np.ndarray:
        # column-wise pointer chase: one vectorized hop per path depth
        # instead of one python loop per vertex.
        cur = np.arange(n, dtype=np.int64)
        cols = [cur]
        step = nxt[cur]
        while (step >= 0).any():
            cur = step
            cols.append(cur)
            step = np.where(cur >= 0, nxt[np.maximum(cur, 0)], -1)
        return np.stack(cols, axis=1)

    x = np.stack([flops, comm_in, comm_out, t_level, b_level], axis=1)
    return StaticFeatures(x=x, x_norm=_normalize(x),
                          edge_cost=edge_cost,
                          edge_cost_norm=_normalize(edge_cost[:, None])[:, 0]
                          if len(edge_cost) else edge_cost,
                          b_path=walk(b_next), t_path=walk(t_next),
                          t_level=t_level, b_level=b_level)


# ---------------------------------------------------------------- dynamic
class EpisodeState:
    """Incremental per-episode state: assignment so far, candidate frontier,
    and the ETF estimator that powers the dynamic device features X_D.

    This is the plain-numpy reference implementation; `assign.py` holds the
    jit-compiled lax.scan twin used for training (they are cross-checked in
    tests)."""

    def __init__(self, g: DataflowGraph, dev: DeviceModel,
                 comm_factor: float = COMM_FACTOR_DEFAULT):
        self.g, self.dev = g, dev
        self.comm_factor = comm_factor
        n, nd = g.n, dev.n
        self.assigned = np.full(n, -1, dtype=np.int64)
        self.placed = np.zeros(n, dtype=bool)
        self.est_end = np.zeros(n)              # estimated completion per vertex
        self.device_avail = np.zeros(nd)        # estimated device free time
        self.dev_comp = np.zeros(nd)            # feature 0 accumulator
        self.dev_bytes = np.zeros(nd)           # bytes resident per device
                                                # (memory-aware placement)
        # candidate frontier bookkeeping
        self.unassigned_preds = np.array([len(g.preds[v]) for v in range(n)])
        self.candidate = np.zeros(n, dtype=bool)
        for v in range(n):
            if self.unassigned_preds[v] == 0:
                self.candidate[v] = True
        # inputs are "pre-placed" conceptually? No: the paper assigns every
        # vertex, including inputs (they are vertices of G). Inputs cost 0.
        self._flops = g.flops_array()
        self._tt = {}
        self.fleet_x = compute_fleet_features(dev)

    def _xfer(self, nbytes: float, src: int, dst: int) -> float:
        return self.dev.transfer_time(nbytes, src, dst)

    @property
    def done(self) -> bool:
        return bool(self.placed.all())

    def candidates(self) -> np.ndarray:
        return np.flatnonzero(self.candidate)

    def device_features(self, v: int) -> np.ndarray:
        """[X_D || X_F] for target node v — (n_dev, 5 + N_FLEET_FEATS):
        the Appendix-E.2 dynamic columns followed by the static fleet
        descriptors (so PLC reads the hardware, not just the episode)."""
        g, dev = self.g, self.dev
        nd = dev.n
        feats = np.zeros((nd, 5))
        feats[:, 0] = self.dev_comp
        preds = [p for p in g.preds[v] if self.placed[p]]
        for d in range(nd):
            if preds:
                arr = [self.est_end[p] +
                       self._xfer(g.vertices[p].out_bytes, self.assigned[p], d)
                       for p in preds]
                feats[d, 1] = sum(self._flops[p] for p in preds
                                  if self.assigned[p] == d)
                feats[d, 2] = min(arr)
                feats[d, 3] = max(arr)
            feats[d, 4] = max(self.device_avail[d], feats[d, 3])
        # normalize: times relative to current max avail for scale stability
        scale = max(self.device_avail.max(initial=0.0), feats[:, 4].max(), 1e-9)
        out = feats.copy()
        out[:, 0] = feats[:, 0] / max(self._flops.sum(), 1e-9)
        out[:, 1] = feats[:, 1] / max(self._flops.sum(), 1e-9)
        out[:, 2:5] = feats[:, 2:5] / scale
        return np.concatenate([out, self.fleet_x], axis=1)

    def step(self, v: int, d: int) -> None:
        """Commit assignment of vertex v to device d; update estimators."""
        assert self.candidate[v] and not self.placed[v]
        g = self.g
        preds = [p for p in g.preds[v] if self.placed[p]]
        ready = max((self.est_end[p] +
                     self._xfer(g.vertices[p].out_bytes, self.assigned[p], d)
                     for p in preds), default=0.0)
        start = max(self.device_avail[d], ready)
        dur = self.dev.exec_time(self._flops[v], d) if not g.is_input(v) else 0.0
        self.est_end[v] = start + dur
        self.device_avail[d] = start + dur
        self.dev_comp[d] += self._flops[v]
        self.dev_bytes[d] += g.vertices[v].out_bytes
        self.assigned[v] = d
        self.placed[v] = True
        self.candidate[v] = False
        for w in g.succs[v]:
            self.unassigned_preds[w] -= 1
            if self.unassigned_preds[w] == 0:
                self.candidate[w] = True
