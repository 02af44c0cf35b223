"""Dual policy networks SEL and PLC, paper Eq. 3-8 (twin of
``repro/core/policies.py``).

SEL (node policy):   h_v = [ H[v] || h_{v,b} || h_{v,t} || Z[v] ]
PLC (device policy): h_{v,d} = [ H[v] || h_d || Y[d] || Z[v] ]

with H = GNN(G, X_G) once per episode, Z = FFNN(X_V), Y = FFNN(X_D) from
the per-step device features, and h_d the mean embedding of the vertices
already placed on device d.
"""
from __future__ import annotations

import torch

from .features import N_FLEET_FEATS
from .gnn import apply_gnn, init_gnn, path_embedding
from .nn import apply_mlp, init_mlp, leaky_relu

N_STATIC_FEATS = 5      # Appendix E.1
N_DEVICE_FEATS = 5      # Appendix E.2
N_PLC_DEV_FEATS = N_DEVICE_FEATS + N_FLEET_FEATS


def init_policies(gen: torch.Generator, d_hidden: int = 64, d_z: int = 32,
                  d_y: int = 32, gnn_layers: int = 2):
    """Fresh parameters on ``gen``'s device, drawn from the reference's
    distributions (normal x 1/sqrt(d_in) weights, zero biases)."""
    return {
        "gnn": init_gnn(gen, N_STATIC_FEATS, d_hidden, gnn_layers, d_edge=1),
        "sel_z": init_mlp(gen, [N_STATIC_FEATS, d_z]),
        "sel_head": init_mlp(gen, [3 * d_hidden + d_z, d_hidden, 1]),
        "plc_z": init_mlp(gen, [N_STATIC_FEATS, d_z]),
        "plc_y": init_mlp(gen, [N_PLC_DEV_FEATS, d_y]),
        "plc_head1": init_mlp(gen, [2 * d_hidden + d_y + d_z, d_hidden]),
        "plc_head2": init_mlp(gen, [d_hidden, 1]),
    }


def episode_encodings(params, x, edges, edge_feat, b_path, t_path,
                      backend: str = "torch", csr=None):
    """Once-per-episode encodings (H, sel_logits, z_plc): the GNN pass,
    path embeddings and the static SEL logits."""
    H = apply_gnn(params["gnn"], x, edges, edge_feat, backend=backend,
                  csr=csr)
    h_b = path_embedding(H, b_path)
    h_t = path_embedding(H, t_path)
    z_sel = apply_mlp(params["sel_z"], x)
    sel_in = torch.cat([H, h_b, h_t, z_sel], dim=-1)
    sel_logits = apply_mlp(params["sel_head"], sel_in)[..., 0]
    z_plc = apply_mlp(params["plc_z"], x)
    return H, sel_logits, z_plc


def plc_logits(params, h_v, h_dev, x_dev, z_v):
    """Per-step device logits, with any leading batch axes.  h_v: (..., dh);
    h_dev: (..., nd, dh) mean embedding of placed vertices per device;
    x_dev: (..., nd, N_PLC_DEV_FEATS); z_v: (..., dz).  -> (..., nd)."""
    nd = h_dev.shape[-2]
    y = apply_mlp(params["plc_y"], x_dev)                       # (..., nd, dy)
    hv = h_v.unsqueeze(-2).expand(*h_v.shape[:-1], nd, h_v.shape[-1])
    zv = z_v.unsqueeze(-2).expand(*z_v.shape[:-1], nd, z_v.shape[-1])
    inp = torch.cat([hv, h_dev, y, zv], dim=-1)
    hid = leaky_relu(apply_mlp(params["plc_head1"], inp))
    return apply_mlp(params["plc_head2"], hid)[..., 0]
