"""Message-passing GNN encoder, paper Eq. 2 (twin of ``repro/core/gnn.py``).

h_v^[k] = phi(h_v^[k-1], (+)_{u in N(v)} psi(h_u^[k-1], h_v^[k-1], e_uv))

Aggregation runs over both edge directions with separate psi networks,
and (+) is the ``gnn_mp`` segment-sum, both directions of a layer in one
call (``segment_sum_pair``): one CUDA launch on the card, the plain
version on the CPU or with ``backend="torch"``.
"""
from __future__ import annotations

import torch

from ..kernels.gnn_mp.ops import segment_sum_pair
from ..kernels.gnn_mp.ref import CSR
from .nn import apply_mlp, init_mlp

ENCODER_BACKENDS = ("torch", "cuda")


def init_gnn(gen: torch.Generator, d_in: int, d_hidden: int,
             n_layers: int = 2, d_edge: int = 1):
    params = {"embed": init_mlp(gen, [d_in, d_hidden]), "layers": []}
    for _ in range(n_layers):
        params["layers"].append({
            "psi_fwd": init_mlp(gen, [2 * d_hidden + d_edge, d_hidden,
                                      d_hidden]),
            "psi_bwd": init_mlp(gen, [2 * d_hidden + d_edge, d_hidden,
                                      d_hidden]),
            "phi": init_mlp(gen, [3 * d_hidden, d_hidden, d_hidden]),
        })
    return params


def apply_gnn(params, x, edges, edge_feat, backend: str = "torch",
              csr: tuple[CSR, CSR] | None = None):
    """x: (n, d_in) node features; edges: (m, 2) int (src, dst);
    edge_feat: (m, d_edge).  Returns H: (n, d_hidden).

    ``csr`` is the (by dst, by src) edge grouping, built once per graph
    (``assign.build_graph_data`` keeps it); without it each aggregation
    builds its own."""
    if backend not in ENCODER_BACKENDS:
        raise ValueError(f"unknown encoder backend {backend!r}; "
                         f"expected one of {ENCODER_BACKENDS}")
    n = x.shape[0]
    h = apply_mlp(params["embed"], x)
    src, dst = edges[:, 0], edges[:, 1]
    for lp in params["layers"]:
        hs, hd = h[src], h[dst]
        msg_f = apply_mlp(lp["psi_fwd"], torch.cat([hs, hd, edge_feat], -1))
        msg_b = apply_mlp(lp["psi_bwd"], torch.cat([hd, hs, edge_feat], -1))
        agg_in, agg_out = segment_sum_pair(msg_f, dst, msg_b, src, n,
                                           backend=backend, csr=csr)
        h_new = apply_mlp(lp["phi"], torch.cat([h, agg_in, agg_out], -1))
        h = h + h_new                        # residual for depth stability
    return h


def path_embedding(h, path_idx):
    """Mean of node embeddings along each vertex's critical path.
    h: (n, d); path_idx: (n, L) int, -1 padded.  Returns (n, d)."""
    mask = path_idx >= 0
    gathered = h[path_idx.clamp(min=0)]                  # (n, L, d)
    w = mask[..., None].to(h.dtype)
    return (gathered * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
