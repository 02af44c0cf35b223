"""DOPPLER training and placement (twin of ``repro/core/training.py``).

Stage I   imitation of the CRITICAL-PATH teacher (Eq. 9)
Stage II  REINFORCE against the WC digital twin (Eq. 10): the oracle on
          the card (``TorchWCEngine``, one ``wc_trips`` launch per reward
          batch) or the numpy ``WCSimulator``
Stage III REINFORCE against the real system: the measured wall-clock of
          the work-conserving executor (``core/executor.py``, one CUDA
          stream a logical device) through ``ExecutorRewardEngine``

Policy-gradient details per §6.1, as in the reference: lr 1e-4 linearly
decayed to 1e-7, exploration eps 0.2 linearly decayed to 0, entropy
weight 1e-2, baseline = running mean of all previous episode rewards,
advantages normalized by the running reward std.

Every loss is a forced replay of the episodes' actions through
``assign.rollout_batch`` under autograd (the encoder's ``gnn_mp`` pair
records its gather backward); where the reference ``vmap``s K
single-episode replays, the port replays the K episodes as one batch.

The fused engine (``core/train_fused.py``; ``stage2_fused``,
``stage1_imitation_fused``) trains without the second |V|-step replay:
the sampler records what the gradient needs, the loss is parallel over
steps, AdamW and the reward statistics stay on the device, and on the
card each update is one CUDA graph replay.

A placement request: encode the graph once (``gnn_mp``), take the greedy
episode and a sampled population, score them all in one oracle batch
(``wc_oracle``), and return the best.  Checkpoints and resume:
``core/policy_io.py``.  Not in this package yet: hierarchical
placement, re-placement, pretraining and ``FleetTrainer``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..train.optim import AdamState, adamw_init, adamw_update, linear_schedule
from .assign import GraphData, build_graph_data, encode, rollout_batch
from .device import resolve_device, sync
from .devices import DeviceModel
from .engine import (ExecutorRewardEngine, RewardEngine, SimRewardEngine,
                     as_engine)
from .executor import WCExecutor
from .features import COMM_FACTOR_DEFAULT
from .gnn import ENCODER_BACKENDS
from .graph import DataflowGraph
from .heuristics import critical_path_assignment
from .nn import tree_leaves, tree_map
from .policies import init_policies
from .sim_torch import ORACLE_BACKENDS, SimGraph, TorchWCEngine
from .simulator import WCSimulator

Mark = Callable[[str], None]


# ------------------------------------------------------------------ losses
def _value_and_grad(loss_fn, params, mark: Mark | None = None):
    """(loss, grads shaped like ``params``); a leaf the loss does not
    reach gets a zero gradient, as in JAX.  ``mark`` (Stage I) ends the
    "replay" and "backward" phases."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = loss_fn(p)
    if mark:
        mark("replay")
    leaves = tree_leaves(p)
    gs = (torch.autograd.grad(loss, leaves, allow_unused=True)
          if loss.requires_grad else [None] * len(leaves))
    by_id = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, gs)}
    grads = tree_map(lambda x: by_id[id(x)], p)
    if mark:
        mark("backward")
    return loss.detach(), grads


def _replay(params, gd: GraphData, actions, encoder_backend: str):
    actions = torch.as_tensor(actions, device=gd.x.device)
    return rollout_batch(params, gd, actions.shape[0],
                         forced_actions=actions,
                         encoder_backend=encoder_backend)


def _pg_loss_and_grad_batch(params, gd: GraphData, actions, advantages,
                            entropy_w: float, sel_learned: bool = True,
                            plc_learned: bool = True,
                            encoder_backend: str = "torch"):
    """Batch-averaged REINFORCE: K replayed episodes (``actions`` (K, n,
    2), ``advantages`` (K,)), one gradient.  The Table-3 ablation modes
    drop the heuristic-replaced policy's log-prob and entropy terms, so
    its parameters get a zero gradient.  (The reference also takes PRNG
    keys: a forced replay draws nothing.)"""
    def loss_fn(p):
        out = _replay(p, gd, actions, encoder_backend)
        adv = torch.as_tensor(advantages, dtype=torch.float32,
                              device=gd.x.device)
        logp = ent = 0.0
        if sel_learned:
            logp = logp + out["sel_logp"].sum(1)
            ent = ent + out["sel_ent"].mean(1)
        if plc_learned:
            logp = logp + out["plc_logp"].sum(1)
            ent = ent + out["plc_ent"].mean(1)
        return (-(adv * logp + entropy_w * ent)).mean()

    return _value_and_grad(loss_fn, params)


def _pg_loss_and_grad(params, gd: GraphData, actions, advantage: float,
                      entropy_w: float, sel_learned: bool = True,
                      plc_learned: bool = True,
                      encoder_backend: str = "torch"):
    """Single-episode REINFORCE (``actions`` (n, 2)): the batch loss at
    K = 1."""
    return _pg_loss_and_grad_batch(
        params, gd, torch.as_tensor(actions)[None], [advantage], entropy_w,
        sel_learned, plc_learned, encoder_backend)


def _imitation_loss_and_grad(params, gd: GraphData, teacher_actions,
                             encoder_backend: str = "torch",
                             mark: Mark | None = None):
    """-(mean SEL log-prob + mean PLC log-prob) of the teacher's (n, 2)
    actions."""
    def loss_fn(p):
        out = _replay(p, gd, torch.as_tensor(teacher_actions)[None],
                      encoder_backend)
        return -(out["sel_logp"].mean() + out["plc_logp"].mean())

    return _value_and_grad(loss_fn, params, mark)


# ----------------------------------------------------------------- trainer
@dataclasses.dataclass
class EpisodeRecord:
    episode: int
    stage: str
    exec_time: float
    best_so_far: float


@dataclasses.dataclass
class Placement:
    """One answered placement request."""
    assignment: np.ndarray      # (n,) the best candidate
    makespan: float             # its oracle makespan (seconds)
    greedy: np.ndarray          # (n,) the greedy episode
    population: np.ndarray      # (K, n) the sampled episodes
    makespans: np.ndarray       # (1 + K,) greedy first, then the samples
    seconds: dict               # wall time of encode / rollout / oracle


class _PhaseClock:
    """Adds each phase's wall seconds, ended by a device sync, to
    ``seconds``."""

    def __init__(self, device: torch.device, seconds: dict):
        self.device, self.seconds = device, seconds
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[phase] = self.seconds.get(phase, 0.0) + now - self.t
        self.t = now


class DopplerTrainer:
    """Owns the dual-policy parameters, trains them (Stages I, II and III)
    and answers placement requests.

    Entry points run on the card (``device="cuda"``) unless the caller
    asks for the CPU; a CUDA device without a GPU raises.  Both kernel
    backends default to "cuda" on the card and "torch" on the CPU.

    Sampling draws from ``generator`` (torch's Philox stream, not the
    reference's threefry keys); the sampling entry points also take
    injected step-major draw tables (``assign.rollout_batch``'s
    ``draws``), which is how the tests replay the reference's streams.
    ``seconds`` sums the wall seconds of each training phase, each ended
    by a device sync (Stage I: teacher, replay, backward, adamw; Stages
    II and III: sample, oracle (for Stage III the executor's
    measurements), replay_backward, adamw; the fused engines:
    teacher and dynamics (Stage I), warmup and capture (the first
    dispatch of a graph), updates); a caller may clear it.  ``losses``
    holds the loss of every Stage I episode and RL update in order, and
    ``last_update`` the actions, loss and gradients (and, for RL, the
    rewards and advantages) of the latest one.  ``_fused_cache`` keeps
    the fused engines (their graphs) by configuration, and the oracle's
    ``SimGraph`` under "sim_graph"."""

    def __init__(self, graph: DataflowGraph, dev: DeviceModel, seed: int = 0,
                 d_hidden: int = 64, gnn_layers: int = 2,
                 lr0: float = 1e-4, lr1: float = 1e-7,
                 eps0: float = 0.2, eps1: float = 0.0,
                 entropy_weight: float = 1e-2,
                 total_episodes: int = 4000,
                 normalize_adv: bool = True,
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
        # a reference checkpoint's PRNG key, kept to be written back
        # unchanged (``policy_io``); the port never draws from it
        self.key: np.ndarray | None = None
        self.opt_state: AdamState = adamw_init(self.params)
        self.lr_sched = linear_schedule(lr0, lr1, total_episodes)
        self.eps_sched = linear_schedule(eps0, eps1, total_episodes)
        self.entropy_weight = entropy_weight
        self.total_episodes = total_episodes
        self.normalize_adv = normalize_adv
        # running reward statistics (baseline = mean of past rewards, §4.1)
        self._r_sum = 0.0
        self._r_sqsum = 0.0
        self._r_count = 0
        self.episode = 0
        self.history: list[EpisodeRecord] = []
        self.best_assignment: np.ndarray | None = None
        self.best_time = np.inf
        self.seconds: dict[str, float] = {}
        self.losses: list[float] = []
        self.last_update: dict = {}
        self._fused_cache: dict = {}

    # ------------------------------------------------------------- utils
    def _baseline(self) -> tuple[float, float]:
        if self._r_count == 0:
            return 0.0, 1.0
        mean = self._r_sum / self._r_count
        var = max(self._r_sqsum / self._r_count - mean * mean, 1e-12)
        return mean, float(np.sqrt(var))

    def _update_reward_stats(self, r: float):
        self._r_sum += r
        self._r_sqsum += r * r
        self._r_count += 1

    def _clock(self) -> _PhaseClock:
        return _PhaseClock(self.device, self.seconds)

    def _apply_grads(self, grads, loss, **record):
        lr = self.lr_sched(self.episode)
        self.params, self.opt_state = adamw_update(
            grads, self.opt_state, self.params, lr)
        self.losses.append(float(loss))
        self.last_update = dict(record, loss=loss, grads=grads)

    def _learned(self, sel_learned, plc_learned) -> tuple[bool, bool]:
        return (self.sel_mode == "learned" if sel_learned is None
                else sel_learned,
                self.plc_mode == "learned" if plc_learned is None
                else plc_learned)

    # ------------------------------------------------------------ rollouts
    def _rollout(self, K: int, greedy: bool, eps: float = 0.0, draws=None,
                 enc=None):
        return rollout_batch(self.params, self.gd, K, float(eps), draws,
                             self.generator, greedy, None, self.sel_mode,
                             self.plc_mode, self.encoder_backend, enc)

    def greedy_assignment(self) -> np.ndarray:
        return self._rollout(1, True)["assignment"][0].cpu().numpy()

    def sample_assignment(self, eps: float | None = None, draws=None):
        """One sampled episode at ``eps`` (default: the schedule's value)
        -> (assignment (n,), actions (n, 2))."""
        eps = self.eps_sched(self.episode) if eps is None else eps
        out = self._rollout(1, False, eps, draws)
        return (out["assignment"][0].cpu().numpy(),
                out["actions"][0].cpu().numpy())

    def default_engine(self) -> TorchWCEngine:
        return TorchWCEngine(self.g, self.dev, backend=self.oracle_backend,
                             device=self.device)

    # ----------------------------------------------------------- Stage I
    def stage1_imitation(self, n_episodes: int, seed: int = 0,
                         log_every: int = 0) -> list[float]:
        """Teach SEL+PLC to replicate CRITICAL PATH decisions (Eq. 9)."""
        losses = []
        for i in range(n_episodes):
            mark = self._clock()
            _, acts = critical_path_assignment(self.g, self.dev,
                                               seed=seed + i,
                                               return_actions=True)
            mark("teacher")
            loss, grads = _imitation_loss_and_grad(
                self.params, self.gd, acts, self.encoder_backend, mark)
            self._apply_grads(grads, loss, actions=acts)
            mark("adamw")
            self.episode += 1
            losses.append(self.losses[-1])
            if log_every and (i + 1) % log_every == 0:
                print(f"[stage1] ep {i+1}/{n_episodes} nll={losses[-1]:.4f}")
        return losses

    # ----------------------------------------------------------- Stage II
    def train_rl(self, system, n_updates: int, batch_size: int = 8,
                 stage: str | None = None, serial: bool = False,
                 log_every: int = 0, draws: Sequence | None = None,
                 **ablation) -> list[float]:
        """The engine-driven REINFORCE core shared by every RL stage.

        ``system`` is anything :func:`engine.as_engine` accepts — a
        :class:`RewardEngine` (``TorchWCEngine`` among them), a
        ``WCSimulator``, or a plain callable.  Each update samples
        ``batch_size`` episodes in one batched rollout, scores them with
        ONE ``engine.exec_times`` call, and takes one batch-averaged
        gradient step; ``serial=True`` (requires ``batch_size == 1``)
        instead runs the per-episode loop (single-episode advantage
        against the running baseline, per-episode gradient).  ``draws``
        holds one entry of injected draw tables per update (None: the
        trainer's generator)."""
        eng = as_engine(system)
        if serial and batch_size != 1:
            raise ValueError("serial mode is the batch_size=1 loop")
        stage = stage or eng.name
        times: list[float] = []
        for i in range(n_updates):
            d = None if draws is None else draws[i]
            if serial:
                times.append(self._rl_episode(
                    lambda a: eng.exec_time(a, self.episode), stage,
                    draws=d, **ablation))
            else:
                ts = self._batched_rl_update(eng, batch_size, stage,
                                             draws=d, **ablation)
                times.extend(ts.tolist())
            if log_every and (i + 1) % log_every == 0:
                print(f"[{stage}] upd {i+1}/{n_updates} "
                      f"t={times[-1]*1e3:.2f}ms "
                      f"best={self.best_time*1e3:.2f}ms")
        return times

    def _rl_episode(self, exec_time_fn: Callable[[np.ndarray], float],
                    stage: str, sel_learned=None, plc_learned=None,
                    draws=None):
        sel_learned, plc_learned = self._learned(sel_learned, plc_learned)
        mark = self._clock()
        assignment, actions = self.sample_assignment(draws=draws)
        mark("sample")
        t = float(exec_time_fn(assignment))
        mark("oracle")
        r = -t                                   # reward = -ExecTime (§4.1)
        mean, std = self._baseline()
        adv = r - mean
        if self.normalize_adv:
            adv = adv / (std + 1e-9)
        self._update_reward_stats(r)
        loss, grads = _pg_loss_and_grad(
            self.params, self.gd, actions, adv, self.entropy_weight,
            sel_learned, plc_learned, self.encoder_backend)
        mark("replay_backward")
        self._apply_grads(grads, loss, actions=actions, rewards=r,
                          advantages=adv)
        mark("adamw")
        self.episode += 1
        if t < self.best_time:
            self.best_time, self.best_assignment = t, assignment
        self.history.append(EpisodeRecord(self.episode, stage, t,
                                          self.best_time))
        return t

    def stage2_sim(self, n_episodes: int, sim: WCSimulator | None = None,
                   log_every: int = 0, draws: Sequence | None = None,
                   **ablation) -> list[float]:
        """Per-episode Stage II (the paper's serial protocol): at K=1 the
        engine's ``episode*K + k`` seeds reduce to ``seed=episode``."""
        sim = sim or WCSimulator(self.g, self.dev, choose="fifo",
                                 noise_sigma=0.05)
        return self.train_rl(sim, n_episodes, batch_size=1, stage="sim",
                             serial=True, log_every=log_every, draws=draws,
                             **ablation)

    def _batched_rl_update(self, reward, batch_size: int, stage: str,
                           sel_learned=None, plc_learned=None,
                           draws=None) -> np.ndarray:
        """One population REINFORCE update: sample ``batch_size`` episodes
        in one batched rollout (``draws``: injected tables, else the
        generator), score them with ONE reward query — ``reward`` is a
        :class:`RewardEngine` (queried as ``exec_times(assignments,
        episode)``) or a callable ``reward_fn(assignments) -> (K,)`` — and
        take one batch-averaged gradient step."""
        sel_learned, plc_learned = self._learned(sel_learned, plc_learned)
        mark = self._clock()
        eps = self.eps_sched(self.episode)
        out = self._rollout(batch_size, False, eps, draws)
        assigns = out["assignment"].cpu().numpy()
        mark("sample")
        if isinstance(reward, RewardEngine):
            ts = np.asarray(reward.exec_times(assigns, self.episode))
        else:
            ts = np.asarray(reward(assigns))
        mark("oracle")
        rs = -ts
        mean, std = self._baseline()
        advs = rs - (mean if self._r_count else rs.mean())
        if self.normalize_adv:
            advs = advs / (max(std, float(rs.std())) + 1e-9)
        for r in rs:
            self._update_reward_stats(float(r))
        advs = np.asarray(advs, np.float32)
        loss, grads = _pg_loss_and_grad_batch(
            self.params, self.gd, out["actions"], advs, self.entropy_weight,
            sel_learned, plc_learned, self.encoder_backend)
        mark("replay_backward")
        self._apply_grads(grads, loss, actions=out["actions"], rewards=rs,
                          advantages=advs)
        mark("adamw")
        self.episode += batch_size
        best_k = int(ts.argmin())
        if ts[best_k] < self.best_time:
            self.best_time = float(ts[best_k])
            self.best_assignment = assigns[best_k]
        self.history.append(EpisodeRecord(self.episode, stage,
                                          float(ts.mean()), self.best_time))
        return ts

    def stage2_sim_batched(self, n_updates: int,
                           sim: WCSimulator | None = None,
                           batch_size: int = 8, log_every: int = 0,
                           sim_engine: str = "batched",
                           draws: Sequence | None = None, **ablation):
        """Population Stage II on the WC simulator: ``train_rl`` over a
        :class:`SimRewardEngine` (``sim_engine``: the compiled batch engine
        or the serial loop, bit-identical), whose ``episode*K + k`` seeds
        are the reference's."""
        sim = sim or WCSimulator(self.g, self.dev, choose="fifo",
                                 noise_sigma=0.05)
        return self.train_rl(SimRewardEngine(sim, sim_engine=sim_engine),
                             n_updates, batch_size, stage="sim_batch",
                             log_every=log_every, draws=draws, **ablation)

    # ---------------------------------------------------------- Stage III
    def stage3_system(self, n_episodes: int,
                      system_exec_time: Callable[[np.ndarray], float],
                      log_every: int = 0, draws: Sequence | None = None,
                      **ablation) -> list[float]:
        """Online refinement against the real WC executor: the reward is
        the observed wall-clock of one execution (the serial protocol: one
        episode, one measurement, one gradient).  ``system_exec_time`` is
        a callable ``assignment -> seconds`` (e.g. ``WCExecutor.execute``)
        or anything :func:`engine.as_engine` accepts."""
        return self.train_rl(system_exec_time, n_episodes, batch_size=1,
                             stage="sys", serial=True, log_every=log_every,
                             draws=draws, **ablation)

    def stage3_system_batched(self, n_updates: int, system,
                              batch_size: int = 8, repeats: int = 1,
                              log_every: int = 0,
                              draws: Sequence | None = None,
                              **ablation) -> list[float]:
        """Batched Stage III: each update samples ``batch_size``
        assignments in one batched rollout, measures them all through the
        system's batch path (a ``WCExecutor``: one ``execute_batch`` —
        plans cached, warm-up amortized, ``repeats`` interleaved) and
        takes ONE batch-averaged REINFORCE step.

        ``repeats`` applies to executor-backed systems: a ``WCExecutor``
        is wrapped in ``ExecutorRewardEngine(repeats)``, an
        ``ExecutorRewardEngine`` re-wrapped at ``repeats`` with its
        ``reduce``; ``repeats != 1`` with any other system raises."""
        if isinstance(system, WCExecutor):
            system = ExecutorRewardEngine(system, repeats=repeats)
        elif repeats != 1:
            if isinstance(system, ExecutorRewardEngine):
                system = ExecutorRewardEngine(system.executor,
                                              repeats=repeats,
                                              reduce=system.reduce)
            else:
                raise ValueError(
                    "repeats is only meaningful for executor-backed "
                    "systems; seeded/deterministic engines replay instead")
        return self.train_rl(system, n_updates, batch_size=batch_size,
                             stage="sys_batch", log_every=log_every,
                             draws=draws, **ablation)

    # ------------------------------------------------------ fused engines
    def _capture(self, capture: bool | None) -> bool:
        """None: capture on the card, run eagerly on the CPU."""
        if capture is None:
            return self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError("capture needs the trainer on a CUDA device")
        return capture

    def _fused_engine(self, key, build):
        eng = self._fused_cache.get(key)
        if eng is None:
            eng = self._fused_cache[key] = build()
        return eng

    def _add_seconds(self, phases: dict, total: float) -> None:
        """``phases`` (warm-up, capture) and the rest of ``total`` as
        "updates"."""
        for k, v in phases.items():
            self.seconds[k] = self.seconds.get(k, 0.0) + v
        self.seconds["updates"] = (self.seconds.get("updates", 0.0) + total
                                   - sum(phases.values()))

    def stage2_fused(self, n_updates: int, batch_size: int = 8,
                     updates_per_dispatch: int | None = None,
                     log_every: int = 0, n_devices: int | None = None,
                     chunk_size: int | None = None,
                     grad_chunk_size: int | None = None,
                     draws: Sequence | None = None,
                     capture: bool | None = None, sel_learned=None,
                     plc_learned=None) -> list[float]:
        """Device-resident Stage II (``train_fused.py``): sampling, the
        oracle (the noise-free 'fifo' makespans of ``makespan_fifo_batch``,
        called on device tensors), advantages, the gradient and AdamW in
        one update, ``updates_per_dispatch`` updates a dispatch and one
        wait for the device a dispatch (a remainder runs as a shorter
        dispatch).  With ``capture`` (None: on the card) each update is
        one CUDA graph replay, captured on the first dispatch of its
        configuration; ``capture=False`` runs the same function eagerly.
        ``chunk_size`` / ``grad_chunk_size`` as in
        :class:`~.train_fused.FusedStage2Config`.  ``draws`` holds one
        set of step-major tables per update (None: fresh draws from
        ``generator``, four calls an update).  Raises RuntimeError if the
        oracle flags any episode as not converged (those advantages were
        masked in-update; the dispatch is discarded)."""
        from .train_fused import (FusedStage2Config, RewardStats,
                                  build_fused_stage2)
        if draws is not None and len(draws) != n_updates:
            raise ValueError(f"{len(draws)} draw tables for {n_updates} "
                             f"updates")
        capture = self._capture(capture)
        sel_learned, plc_learned = self._learned(sel_learned, plc_learned)
        U = updates_per_dispatch or min(n_updates, 8)
        cfg = FusedStage2Config(
            batch_size=batch_size, updates=U, sel_mode=self.sel_mode,
            plc_mode=self.plc_mode, sel_learned=sel_learned,
            plc_learned=plc_learned, normalize_adv=self.normalize_adv,
            entropy_weight=self.entropy_weight,
            encoder_backend=self.encoder_backend,
            oracle_backend=self.oracle_backend, chunk_size=chunk_size,
            grad_chunk_size=grad_chunk_size)
        sg = self._fused_engine("sim_graph", lambda: SimGraph.build(
            self.g, self.dev, self.device))
        eng = self._fused_engine(
            ("stage2", cfg.graph_key(), n_devices or 1, capture),
            lambda: build_fused_stage2(cfg, self.gd, sg, self.lr_sched,
                                       self.eps_sched, n_devices or 1,
                                       capture))
        rstats = RewardStats.make(self._r_sum, self._r_sqsum, self._r_count,
                                  self.device)
        times: list[float] = []
        done = 0
        while done < n_updates:
            u = min(U, n_updates - done)
            t0 = time.perf_counter()
            out = eng(self.params, self.opt_state, rstats, self.episode,
                      self.generator if draws is None
                      else draws[done:done + u], updates=u)
            sync(self.device)                 # the dispatch's one wait
            ok, ms, best_as, losses, r_stats = (
                out[k].cpu().numpy() if k != "rstats" else
                [float(t) for t in out[k].tensors()]
                for k in ("oracle_ok", "makespans", "best_assignments",
                          "losses", "rstats"))
            self._add_seconds(out["seconds"], time.perf_counter() - t0)
            if not ok.all():
                raise RuntimeError(
                    f"WC oracle failed to converge on "
                    f"{int((~ok).sum())}/{ok.size} episodes (deadlock); "
                    f"their advantages were masked in-update and the "
                    f"dispatch result was discarded")
            self.params, self.opt_state = out["params"], out["opt_state"]
            rstats = out["rstats"]
            self._r_sum, self._r_sqsum = r_stats[:2]
            self._r_count = int(r_stats[2])
            for j in range(u):
                ts = ms[j]
                self.episode += batch_size
                if ts.min() < self.best_time:
                    self.best_time = float(ts.min())
                    self.best_assignment = best_as[j]
                self.history.append(EpisodeRecord(
                    self.episode, "sim_fused", float(ts.mean()),
                    self.best_time))
                times.extend(ts.tolist())
            self.losses.extend(losses.tolist())
            self.last_update = dict(
                actions=out["actions"], rewards=-ms[-1],
                advantages=out["advantages"].cpu().numpy(),
                loss=float(losses[-1]), grads=out["grads"])
            done += u
            if log_every:
                print(f"[stage2f] upd {done}/{n_updates} "
                      f"mean={ms[-1].mean()*1e3:.2f}ms "
                      f"best={self.best_time*1e3:.2f}ms")
        return times

    def stage1_imitation_fused(self, n_episodes: int, seed: int = 0,
                               batch_size: int = 1, log_every: int = 0,
                               capture: bool | None = None) -> list[float]:
        """Stage I with the teacher's episodes precomputed: the CP
        teacher's ``n_episodes`` action sequences (seeds ``seed + i``),
        their parameter-free dynamics replayed once, then one
        step-parallel NLL update per ``batch_size`` episodes with AdamW on
        the device, each update one CUDA graph replay with ``capture``
        (None: on the card), and one wait at the end.  At ``batch_size=1``
        the updates are ``stage1_imitation``'s to float tolerance."""
        from .train_fused import build_fused_stage1
        if n_episodes % batch_size:
            raise ValueError("n_episodes must be divisible by batch_size")
        capture = self._capture(capture)
        t0 = time.perf_counter()
        acts = np.stack([
            critical_path_assignment(self.g, self.dev, seed=seed + i,
                                     return_actions=True)[1]
            for i in range(n_episodes)])
        t1 = time.perf_counter()
        eng = self._fused_engine(
            ("stage1", batch_size, self.encoder_backend, capture),
            lambda: build_fused_stage1(self.gd, self.lr_sched, batch_size,
                                       self.encoder_backend, capture))
        actions = torch.as_tensor(acts, dtype=torch.long, device=self.device)
        masks, x_devs = eng.replay_dynamics(actions)
        sync(self.device)
        t2 = time.perf_counter()
        out = eng(self.params, self.opt_state, self.episode, masks, x_devs,
                  actions)
        losses = out["losses"].cpu().tolist()          # the one wait
        self.seconds["teacher"] = self.seconds.get("teacher", 0.0) + t1 - t0
        self.seconds["dynamics"] = (self.seconds.get("dynamics", 0.0)
                                    + t2 - t1)
        self._add_seconds(out["seconds"], time.perf_counter() - t2)
        self.params, self.opt_state = out["params"], out["opt_state"]
        self.episode += n_episodes
        self.losses.extend(losses)
        self.last_update = dict(actions=acts[n_episodes - batch_size:],
                                loss=losses[-1], grads=out["grads"])
        if log_every:
            print(f"[stage1f] {len(losses)} updates nll={losses[-1]:.4f}")
        return losses

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

    # -------------------------------------------------------- evaluation
    def evaluate(self, sim_or_fn=None, n_runs: int = 10,
                 assignment: np.ndarray | None = None):
        """Paper protocol: mean +/- std of ``n_runs`` executions of the
        best found (else the greedy) assignment, through the engine
        adapter's ``evaluate_repeats`` (default: the oracle on this
        trainer's device, which is noise-free, so the repeats dedup to one
        run and std is 0; an executor measures ``n_runs`` runs in one
        ``execute_batch``)."""
        a = assignment if assignment is not None else self.best_assignment
        if a is None:
            a = self.greedy_assignment()
        eng = self.default_engine() if sim_or_fn is None else sim_or_fn
        ts = as_engine(eng).evaluate_repeats(a, n_runs)
        return float(np.mean(ts)), float(np.std(ts)), a
