"""PLACETO-style baseline (Addanki et al., 2019) (twin of
``repro/core/placeto.py``).

Single *device* policy, no learned node selection: vertices are visited in
a fixed topological order; at every MDP step the GNN re-encodes the graph
with the current partial assignment baked into the node features (this
per-step message passing is exactly what makes PLACETO slow — §4.3 and
Table 6), then a feedforward head scores the devices for the current node.

The reference's ``lax.scan`` over the order becomes a Python loop; each
step's re-encode runs the ``gnn_mp`` pair on the card, one launch a GNN
layer, so a rollout launches it 2·n times with 2 layers, and its replay
under autograd as many again.  Trained with the REINFORCE loop GDP uses
(``gdp.BaselineTrainer``).
"""
from __future__ import annotations

import torch

from .assign import GraphData
from .devices import DeviceModel
from .gdp import BaselineTrainer, rollout_draws
from .gnn import apply_gnn, init_gnn
from .graph import DataflowGraph
from .nn import apply_mlp, argmax_first, init_mlp, masked_entropy

N_DYN = 3   # [placed, assigned_dev/nd, is_current]


def init_placeto(gen: torch.Generator, n_devices: int, d_hidden: int = 64,
                 gnn_layers: int = 2):
    """Fresh parameters on ``gen``'s device, from the reference's
    distributions."""
    return {
        "gnn": init_gnn(gen, 5 + N_DYN, d_hidden, gnn_layers, d_edge=1),
        "head": init_mlp(gen, [2 * d_hidden, d_hidden, n_devices]),
    }


def placeto_rollout(params, gd: GraphData, order: torch.Tensor, eps=0.0,
                    draws=None, generator: torch.Generator | None = None,
                    forced=None, greedy: bool = False,
                    encoder_backend: str = "torch"):
    """One episode over the fixed visit ``order`` (n,).  ``forced`` (n,)
    is an assignment to replay (by vertex); ``draws`` the per-step draws
    of the reference's ``k1, k2, k3 = split(kd, 3)``, step-major: gumbel
    (n, nd) for ``categorical(k1)``, ints (n,) for ``randint(k2)``,
    uniforms (n,) for ``bernoulli(k3, eps)`` (else drawn from
    ``generator``).  Returns assignment (n,) and per-step logp and
    entropy."""
    n, nd = gd.n, gd.nd
    dev = gd.x.device
    sampled = forced is None and not greedy
    if sampled:
        gum, unif, u = rollout_draws(draws, generator, n, nd, dev)
    if forced is not None:
        forced = torch.as_tensor(forced, device=dev).long()
    assigned = torch.zeros(n, dtype=torch.long, device=dev)
    placed = torch.zeros(n, dtype=torch.bool, device=dev)
    ids = torch.arange(n, device=dev)
    nd_t = torch.tensor(float(nd), device=dev)   # a device divisor: exact
    ones = torch.ones(nd, dtype=torch.bool, device=dev)
    logps, ents = [], []
    for s, v in enumerate(order.tolist()):
        dyn = torch.stack([placed.float(), assigned.float() / nd_t,
                           (ids == v).float()], 1)
        x = torch.cat([gd.x, dyn], 1)
        h = apply_gnn(params["gnn"], x, gd.edges, gd.edge_feat,
                      backend=encoder_backend, csr=gd.csr)   # per-step MP!
        hv = torch.cat([h[v], h.mean(0)])
        logits = apply_mlp(params["head"], hv)          # (nd,)
        logp_all = torch.log_softmax(logits, -1)
        if forced is not None:
            d = forced[v]
        elif greedy:
            d = argmax_first(logp_all)
        else:
            d = torch.where(u[s] < eps, unif[s],
                            argmax_first(logp_all + gum[s]))
        logps.append(logp_all[d])
        ents.append(masked_entropy(logits, ones))
        assigned[v] = d
        placed[v] = True
    return {"assignment": assigned, "logp": torch.stack(logps),
            "ent": torch.stack(ents)}


class PlacetoTrainer(BaselineTrainer):
    """REINFORCE trainer for the PLACETO baseline.  Hyperparameters per
    paper §6.1: lr 1e-3 -> 1e-6, eps 0.5 -> 0, entropy 1e-2."""

    name = "placeto"
    rollout = staticmethod(placeto_rollout)
    init = staticmethod(init_placeto)

    def __init__(self, graph: DataflowGraph, dev: DeviceModel, seed: int = 0,
                 d_hidden: int = 64, lr0: float = 1e-3, lr1: float = 1e-6,
                 eps0: float = 0.5, eps1: float = 0.0,
                 entropy_weight: float = 1e-2, total_episodes: int = 4000,
                 encoder_backend: str | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(graph, dev, seed, d_hidden, lr0, lr1, eps0, eps1,
                         entropy_weight, total_episodes, encoder_backend,
                         device)
