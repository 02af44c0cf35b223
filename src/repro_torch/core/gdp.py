"""GDP-style baseline (Zhou et al., 2019): graph embedding + sequential
attention, single placement policy (twin of ``repro/core/gdp.py``).

One GNN pass encodes the graph; a causal single-head self-attention layer
over the topologically-ordered node sequence (with sinusoidal positions)
produces all device logits in one forward — the "sequential attention"
placer.  No node-selection policy and no per-step dynamic features, which
is exactly the modeling gap DOPPLER's dual policy closes.

The attention is a plain product (the reference computes it outside any
Pallas kernel); the GNN's aggregation is the ``gnn_mp`` pair on the card
(``encoder_backend="cuda"``: one launch a GNN layer a rollout, and one
more a layer in the replay).  ``BaselineTrainer`` is the REINFORCE loop
that this trainer and ``placeto.PlacetoTrainer`` share, as the
reference's two trainers do line for line.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..train.optim import adamw_init, adamw_update, linear_schedule
from .assign import GraphData, build_graph_data
from .device import resolve_device
from .devices import DeviceModel
from .gnn import ENCODER_BACKENDS, apply_gnn, init_gnn
from .graph import DataflowGraph
from .nn import (apply_linear, apply_mlp, argmax_first, init_linear,
                 init_mlp, tree_map)
from .simulator import WCSimulator
from .training import _PhaseClock, _value_and_grad


def _positions(n: int, d: int) -> np.ndarray:
    """Sinusoidal positions, computed in float64 and cast to float32 as
    the reference does."""
    pos = np.arange(n)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d)
    pe = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return pe.astype(np.float32)


def init_gdp(gen: torch.Generator, n_devices: int, d_hidden: int = 64,
             gnn_layers: int = 2):
    """Fresh parameters on ``gen``'s device, from the reference's
    distributions."""
    return {
        "gnn": init_gnn(gen, 5, d_hidden, gnn_layers, d_edge=1),
        "wq": init_linear(gen, d_hidden, d_hidden),
        "wk": init_linear(gen, d_hidden, d_hidden),
        "wv": init_linear(gen, d_hidden, d_hidden),
        "head": init_mlp(gen, [2 * d_hidden, d_hidden, n_devices]),
    }


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u))


def rollout_draws(draws, generator, n: int, nd: int, dev: torch.device):
    """A rollout's draws as tensors on ``dev``: the injected ``draws``
    (gumbel (n, nd), uniform device ints (n,), uniforms (n,)), else
    fresh ones from ``generator``."""
    if draws is None:
        if generator is None:
            raise ValueError("a sampled rollout needs injected draws or a "
                             "torch.Generator")
        draws = [_gumbel(generator, (n, nd)),
                 torch.randint(0, nd, (n,), generator=generator,
                               device=generator.device),
                 torch.rand(n, generator=generator, device=generator.device)]
    gum, unif, u = (torch.as_tensor(x, device=dev) for x in draws)
    if gum.shape != (n, nd) or unif.shape != (n,) or u.shape != (n,):
        raise ValueError(f"draws must be gumbel (n, nd), ints (n,), "
                         f"uniforms (n,); got {tuple(gum.shape)}, "
                         f"{tuple(unif.shape)}, {tuple(u.shape)}")
    return gum, unif.long(), u


def gdp_rollout(params, gd: GraphData, order: torch.Tensor, eps=0.0,
                draws=None, generator: torch.Generator | None = None,
                forced=None, greedy: bool = False,
                encoder_backend: str = "torch"):
    """Place every vertex in one forward.  ``order`` (n,) is the
    topological order; ``forced`` (n,) an assignment to replay (by
    vertex); ``draws`` the reference's three draws of ``split(key, 3)``:
    gumbel (n, nd) for ``categorical(keys[0], logp)``, ints (n,) for
    ``randint(keys[1])`` and uniforms (n,) for ``bernoulli(keys[2],
    eps)``, all in the order's positions (else drawn from
    ``generator``).  Returns assignment (n,) and, per position, logp and
    the entropy of the full row."""
    n, nd = gd.n, gd.nd
    dev = gd.x.device
    h = apply_gnn(params["gnn"], gd.x, gd.edges, gd.edge_feat,
                  backend=encoder_backend, csr=gd.csr)
    hseq = h[order] + torch.as_tensor(_positions(n, h.shape[1]), device=dev)
    q = apply_linear(params["wq"], hseq)
    k = apply_linear(params["wk"], hseq)
    v = apply_linear(params["wv"], hseq)
    scale = torch.sqrt(torch.tensor(float(q.shape[-1]), device=dev))
    scores = q @ k.T / scale
    causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    scores = torch.where(causal, scores, -torch.inf)
    attn = torch.softmax(scores, -1) @ v
    feats = torch.cat([hseq, attn], -1)
    logits = apply_mlp(params["head"], feats)            # (n, nd) in order
    logp_all = torch.log_softmax(logits, -1)

    if forced is not None:
        d_seq = torch.as_tensor(forced, device=dev).long()[order]
    elif greedy:
        d_seq = argmax_first(logp_all)
    else:
        gum, unif, u = rollout_draws(draws, generator, n, nd, dev)
        d_seq = torch.where(u < eps, unif, argmax_first(logp_all + gum))
    logps = logp_all.gather(1, d_seq[:, None])[:, 0]
    ents = -(torch.exp(logp_all) * logp_all).sum(-1)
    assignment = torch.zeros(n, dtype=torch.long, device=dev)
    assignment[order] = d_seq
    return {"assignment": assignment, "logp": logps, "ent": ents}


def replay_loss_and_grad(rollout_fn, params, gd: GraphData, order,
                         forced_assignment, advantage: float,
                         entropy_w: float, encoder_backend: str = "torch"):
    """-(A * sum of log-probs + w * mean entropy) of a forced replay at
    eps 0, and its gradient (the reference's ``_gdp_grad`` /
    ``_placeto_grad``)."""
    adv, ew = float(np.float32(advantage)), float(np.float32(entropy_w))

    def loss_fn(p):
        out = rollout_fn(p, gd, order, 0.0, forced=forced_assignment,
                         encoder_backend=encoder_backend)
        return -(adv * out["logp"].sum() + ew * out["ent"].mean())
    return _value_and_grad(loss_fn, params)


class BaselineTrainer:
    """The REINFORCE loop of the GDP and Placeto baselines: one episode
    an update, rewards from the copied ``WCSimulator.exec_time(a,
    seed=episode)``, the advantage standardised by the running reward
    statistics in the reference's own arithmetic (not
    ``DopplerTrainer._baseline``'s), the gradient a forced replay under
    autograd at eps 0, and AdamW.

    Entry points run on the card (``device="cuda"``) unless the caller
    asks for the CPU; ``encoder_backend`` defaults to "cuda" on the card
    and "torch" on the CPU.  Parameters come from a CPU generator on
    ``seed`` (the same bits on every device); sampling draws from a
    generator on the device seeded ``seed + 1``, or from injected
    tables (``train(..., draws=[one rollout's tables an episode])``).
    ``seconds`` sums each phase's wall seconds (sample, reward,
    replay_backward, adamw), each ended by a device sync;
    ``last_update`` holds the latest episode's assignment, reward,
    advantage, loss and gradients."""

    name = "baseline"
    rollout: Callable = None          # the subclass's rollout function
    init: Callable = None             # and its parameter init

    def __init__(self, graph: DataflowGraph, dev: DeviceModel, seed: int,
                 d_hidden: int, lr0: float, lr1: float, eps0: float,
                 eps1: float, entropy_weight: float, total_episodes: int,
                 encoder_backend: str | None,
                 device: str | torch.device):
        self.device = resolve_device(device)
        self.encoder_backend = encoder_backend or (
            "cuda" if self.device.type == "cuda" else "torch")
        if self.encoder_backend not in ENCODER_BACKENDS:
            raise ValueError(f"unknown encoder backend "
                             f"{self.encoder_backend!r}; expected one of "
                             f"{ENCODER_BACKENDS}")
        self.g, self.dev = graph, dev
        self.gd = build_graph_data(graph, dev, device=self.device)
        self.order = torch.as_tensor(np.array(graph.topo_order),
                                     dtype=torch.long, device=self.device)
        init_gen = torch.Generator().manual_seed(seed)
        self.params = tree_map(lambda x: x.to(self.device),
                               type(self).init(init_gen, dev.n, d_hidden))
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.opt_state = adamw_init(self.params)
        self.lr = linear_schedule(lr0, lr1, total_episodes)
        self.eps = linear_schedule(eps0, eps1, total_episodes)
        self.entropy_weight = entropy_weight
        self.episode = 0
        self._rsum = self._rsq = 0.0
        self._rcount = 0
        self.best_time = np.inf
        self.best_assignment = None
        self.history: list[float] = []
        self.seconds: dict[str, float] = {}
        self.last_update: dict = {}

    def train(self, n_episodes: int, sim: WCSimulator, log_every: int = 0,
              draws=None) -> list[float]:
        """``n_episodes`` REINFORCE episodes against ``sim``; ``draws``
        holds one rollout's injected tables an episode (None: the
        trainer's generator).  -> the history of makespans."""
        rollout = type(self).rollout
        for i in range(n_episodes):
            mark = _PhaseClock(self.device, self.seconds)
            out = rollout(self.params, self.gd, self.order,
                          float(self.eps(self.episode)),
                          draws=None if draws is None else draws[i],
                          generator=self.generator,
                          encoder_backend=self.encoder_backend)
            a = out["assignment"].cpu().numpy()
            mark("sample")
            t = sim.exec_time(a, seed=self.episode)
            mark("reward")
            r = -t
            mean = self._rsum / self._rcount if self._rcount else 0.0
            var = (self._rsq / self._rcount - mean ** 2) if self._rcount \
                else 1.0
            adv = (r - mean) / (np.sqrt(max(var, 1e-12)) + 1e-9)
            self._rsum += r
            self._rsq += r * r
            self._rcount += 1
            loss, grads = replay_loss_and_grad(
                rollout, self.params, self.gd, self.order, out["assignment"],
                adv, self.entropy_weight, self.encoder_backend)
            mark("replay_backward")
            self.params, self.opt_state = adamw_update(
                grads, self.opt_state, self.params, self.lr(self.episode))
            mark("adamw")
            self.last_update = dict(actions=a, rewards=r, advantages=adv,
                                    loss=loss, grads=grads)
            self.episode += 1
            if t < self.best_time:
                self.best_time, self.best_assignment = t, a
            self.history.append(t)
            if log_every and (i + 1) % log_every == 0:
                print(f"[{self.name}] ep {i+1}: t={t*1e3:.2f}ms "
                      f"best={self.best_time*1e3:.2f}ms")
        return self.history


class GDPTrainer(BaselineTrainer):
    """Hyperparameters per paper §6.1 (same schedule family as DOPPLER:
    lr 1e-4 -> 1e-7, eps 0.2 -> 0, entropy 1e-2)."""

    name = "gdp"
    rollout = staticmethod(gdp_rollout)
    init = staticmethod(init_gdp)

    def __init__(self, graph: DataflowGraph, dev: DeviceModel, seed: int = 0,
                 d_hidden: int = 64, lr0: float = 1e-4, lr1: float = 1e-7,
                 eps0: float = 0.2, eps1: float = 0.0,
                 entropy_weight: float = 1e-2, total_episodes: int = 4000,
                 encoder_backend: str | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(graph, dev, seed, d_hidden, lr0, lr1, eps0, eps1,
                         entropy_weight, total_episodes, encoder_backend,
                         device)
