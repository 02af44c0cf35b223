"""The placement half of ``DopplerTrainer`` (twin of
``repro/core/training.py``).

A placement request: encode the graph once (``gnn_mp``), take the greedy
episode and a sampled population, score them all in one oracle batch
(``wc_oracle``), and return the best.  The training stages (imitation,
REINFORCE, the fused engine) and hierarchical placement are not part of
this package yet.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .assign import build_graph_data, encode, rollout_batch
from .device import resolve_device, sync
from .devices import DeviceModel
from .features import COMM_FACTOR_DEFAULT
from .gnn import ENCODER_BACKENDS
from .graph import DataflowGraph
from .nn import tree_map
from .policies import init_policies
from .sim_torch import ORACLE_BACKENDS, TorchWCEngine


@dataclasses.dataclass
class Placement:
    """One answered placement request."""
    assignment: np.ndarray      # (n,) the best candidate
    makespan: float             # its oracle makespan (seconds)
    greedy: np.ndarray          # (n,) the greedy episode
    population: np.ndarray      # (K, n) the sampled episodes
    makespans: np.ndarray       # (1 + K,) greedy first, then the samples
    seconds: dict               # wall time of encode / rollout / oracle


class DopplerTrainer:
    """Owns the dual-policy parameters and answers placement requests.

    Entry points run on the card (``device="cuda"``) unless the caller
    asks for the CPU; a CUDA device without a GPU raises.  Both kernel
    backends default to "cuda" on the card and "torch" on the CPU."""

    def __init__(self, graph: DataflowGraph, dev: DeviceModel, seed: int = 0,
                 d_hidden: int = 64, gnn_layers: int = 2,
                 comm_factor: float = COMM_FACTOR_DEFAULT,
                 sel_mode: str = "learned", plc_mode: str = "learned",
                 encoder_backend: str | None = None,
                 oracle_backend: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        default = "cuda" if self.device.type == "cuda" else "torch"
        self.encoder_backend = encoder_backend or default
        self.oracle_backend = oracle_backend or default
        if self.encoder_backend not in ENCODER_BACKENDS:
            raise ValueError(f"unknown encoder backend "
                             f"{self.encoder_backend!r}; expected one of "
                             f"{ENCODER_BACKENDS}")
        if self.oracle_backend not in ORACLE_BACKENDS:
            raise ValueError(f"unknown oracle backend "
                             f"{self.oracle_backend!r}; expected one of "
                             f"{ORACLE_BACKENDS}")
        if sel_mode not in ("learned", "cp") or plc_mode not in ("learned",
                                                                 "etf"):
            raise ValueError(f"unknown ablation modes {sel_mode!r} / "
                             f"{plc_mode!r}")
        self.g, self.dev = graph, dev
        self.comm_factor = comm_factor
        self.sel_mode, self.plc_mode = sel_mode, plc_mode
        self.gd = build_graph_data(graph, dev, comm_factor, self.device)
        # parameters from a CPU generator (the same bits on every device);
        # sampling draws from a generator on the device
        init_gen = torch.Generator().manual_seed(seed)
        self.params = tree_map(lambda x: x.to(self.device), init_policies(
            init_gen, d_hidden=d_hidden, gnn_layers=gnn_layers))
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.best_assignment: np.ndarray | None = None
        self.best_time = np.inf

    # ------------------------------------------------------------ rollouts
    def _rollout(self, K: int, greedy: bool, eps: float = 0.0, draws=None,
                 enc=None):
        return rollout_batch(self.params, self.gd, K, eps, draws,
                             self.generator, greedy, None, self.sel_mode,
                             self.plc_mode, self.encoder_backend, enc)

    def greedy_assignment(self) -> np.ndarray:
        return self._rollout(1, True)["assignment"][0].cpu().numpy()

    def sample_assignment(self, eps: float = 0.2):
        """One sampled episode -> (assignment (n,), actions (n, 2))."""
        out = self._rollout(1, False, eps)
        return (out["assignment"][0].cpu().numpy(),
                out["actions"][0].cpu().numpy())

    def default_engine(self) -> TorchWCEngine:
        return TorchWCEngine(self.g, self.dev, backend=self.oracle_backend,
                             device=self.device)

    # ----------------------------------------------------------- placement
    def place(self, engine=None, n_samples: int = 0, eps: float = 0.2,
              draws=None) -> Placement:
        """Answer one placement request.

        Candidates: the greedy episode, ``n_samples`` sampled episodes
        (``draws`` injects the step-major tables of ``assign.rollout_batch``)
        and the best assignment so far, all scored in ONE ``engine`` batch
        (default: the oracle on this trainer's device).  The best wins
        (first on ties) and becomes ``best_assignment``.  With
        ``n_samples=0`` this is the reference's flat ``place()``: the
        best-so-far or greedy assignment, scored."""
        eng = engine if engine is not None else self.default_engine()
        t0 = time.perf_counter()
        enc = encode(self.params, self.gd, self.encoder_backend)
        sync(self.device)
        t1 = time.perf_counter()
        greedy = self._rollout(1, True, enc=enc)["assignment"]
        if n_samples:
            pop = self._rollout(n_samples, False, eps, draws, enc)
            cands = torch.cat([greedy, pop["assignment"]])
        else:
            cands = greedy
        cands = cands.cpu().numpy()
        t2 = time.perf_counter()
        pool = cands if self.best_assignment is None else np.concatenate(
            [cands, self.best_assignment[None]])
        ts = np.asarray(eng.exec_times(pool), dtype=float)
        t3 = time.perf_counter()
        k = int(ts.argmin())
        self.best_assignment, self.best_time = pool[k].copy(), float(ts[k])
        return Placement(assignment=self.best_assignment.copy(),
                         makespan=self.best_time, greedy=cands[0],
                         population=cands[1:], makespans=ts[:len(cands)],
                         seconds={"encode": t1 - t0, "rollout": t2 - t1,
                                  "oracle": t3 - t2})

    def evaluate(self, engine=None, assignment: np.ndarray | None = None):
        """(mean, std, assignment) of the best (or greedy) assignment.  The
        oracle is noise-free, so one run is every run: std is 0."""
        a = assignment if assignment is not None else self.best_assignment
        if a is None:
            a = self.greedy_assignment()
        eng = engine if engine is not None else self.default_engine()
        t = float(np.asarray(eng.exec_times(np.asarray(a)[None]))[0])
        return t, 0.0, a

