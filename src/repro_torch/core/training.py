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
``core/policy_io.py``.

Hierarchical mode (``hierarchy=``, ``core/hierarchy.py``): the flat graph
is coarsened level by level (``graphs/partition.coarsen_multilevel``) and
every stage above runs unchanged on the top segment graph; ``place()``
expands a pool of segment candidates, descends the V-cycle and refines
on the flat graph, every flat batch one oracle launch.  ``replace()``
re-places after a ``FleetEvent`` (device loss, straggler, link
degradation) under a wall-clock budget.

Around the trained policy: ``transfer`` (few-shot, Table 4),
``pretrain`` (one parameter set round-robined over many graph x fleet
tasks, for zero-shot serving by ``launch/place_server.py``) and
``FleetTrainer`` (App. I: one policy per repeated block, rewards the
mean over replicas).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..graphs.partition import coarsen_multilevel
from ..train.optim import AdamState, adamw_init, adamw_update, linear_schedule
from .assign import GraphData, build_graph_data, encode, rollout_batch
from .device import resolve_device, sync
from .devices import DeviceModel, FleetEvent
from .engine import (ExecutorRewardEngine, RewardEngine, SimRewardEngine,
                     as_engine)
from .executor import WCExecutor
from .features import COMM_FACTOR_DEFAULT
from .gnn import ENCODER_BACKENDS
from .graph import DataflowGraph
from .heuristics import critical_path_assignment
from .hierarchy import (HierarchicalPolicy, HierarchyConfig, RefineState,
                        project_assignment, refine_assignment)
from .nn import tree_map, value_and_grad
from .policies import init_policies
from .sim_torch import ORACLE_BACKENDS, SimGraph, TorchWCEngine
from .simulator import WCSimulator

Mark = Callable[[str], None]


# ------------------------------------------------------------------ losses
def _value_and_grad(loss_fn, params, mark: Mark | None = None):
    """(loss, grads shaped like ``params``); a leaf the loss does not
    reach gets a zero gradient, as in JAX.  ``mark`` (Stage I) ends the
    "replay" and "backward" phases."""
    def replay(p):
        loss = loss_fn(p)
        if mark:
            mark("replay")
        return loss
    loss, grads = value_and_grad(replay, params)
    if mark:
        mark("backward")
    return loss, grads


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
    """One answered placement request.  A hierarchical trainer answers
    with flat assignments: ``greedy`` is its expanded greedy episode,
    ``population`` the rest of the expanded pool (best so far, CP seeds),
    ``seconds`` split into pool / vcycle / refine, and ``refine_state`` the
    flat refinement's bookkeeping."""
    assignment: np.ndarray      # (n,) the best candidate
    makespan: float             # its oracle makespan (seconds)
    greedy: np.ndarray          # (n,) the greedy episode
    population: np.ndarray      # (K, n) the sampled episodes
    makespans: np.ndarray       # (1 + K,) greedy first, then the samples
    seconds: dict               # wall time of encode / rollout / oracle
    refine_state: RefineState | None = None


@dataclasses.dataclass
class ReplaceResult:
    """Outcome of one :meth:`DopplerTrainer.replace` call.

    ``makespan_before`` is the surviving-device projection of the OLD
    placement scored on the NEW fleet — what the system would run at if
    it kept the stale placement; ``makespan`` is the re-placed result.
    ``cp_makespan`` is the best CRITICAL-PATH candidate in the pool (on
    the new fleet), so ``makespan <= cp_makespan`` is structural whenever
    CP seeds made it into the pool."""
    assignment: np.ndarray          # flat-graph assignment on the new fleet
    makespan: float
    makespan_before: float
    cp_makespan: float
    source: str                     # 'projected' | 'policy' | 'cp' | 'refined'
    latency_s: float
    budget_s: float
    within_budget: bool
    fleet_fingerprint: str
    event: FleetEvent | None = None
    refine_rounds: int = 0
    refine_moves: int = 0
    n_candidates: int = 0


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
    ``SimGraph`` under "sim_graph".

    ``hierarchy`` (a segment count or a :class:`HierarchyConfig`) coarsens
    ``graph`` with ``coarsen_multilevel``: ``flat_graph`` keeps the flat
    graph, ``hier`` the :class:`HierarchicalPolicy`, and ``g`` becomes the
    top segment graph on which every stage runs unchanged."""

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
                 device: str | torch.device = "cuda", hierarchy=None):
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
        self.flat_graph = graph
        self.hier: HierarchicalPolicy | None = None
        self.hierarchy: HierarchyConfig | None = None
        if hierarchy is not None:
            if isinstance(hierarchy, int):
                hierarchy = HierarchyConfig(n_segments=hierarchy)
            part = coarsen_multilevel(graph, hierarchy.n_segments,
                                      cap_factor=hierarchy.cap_factor,
                                      max_ratio=hierarchy.max_ratio,
                                      max_levels=hierarchy.max_levels)
            self.hierarchy = hierarchy
            self.hier = HierarchicalPolicy(part, hierarchy, dev)
            graph = part.seg_graph
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
        # the flat oracle per fleet fingerprint, and CP seeds per
        # (fingerprint, seed), for place() and replace()
        self._twin_cache: dict = {}
        self._cp_cache: dict = {}

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

    def _greedy_on(self, gd: GraphData) -> np.ndarray:
        """Greedy rollout against another ``GraphData`` (the policy graph
        re-featurized for a derived fleet); greedy draws nothing, so the
        generator does not move and re-placement stays side-effect-free
        until commit."""
        return rollout_batch(self.params, gd, 1, greedy=True,
                             sel_mode=self.sel_mode, plc_mode=self.plc_mode,
                             encoder_backend=self.encoder_backend
                             )["assignment"][0].cpu().numpy()

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

    def flat_engine(self, dev: DeviceModel | None = None) -> TorchWCEngine:
        """The oracle of ``flat_graph`` on fleet ``dev`` (default: the
        trainer's) on this trainer's device, cached per fleet fingerprint
        (at most 4): what ``place()`` and ``replace()`` score flat
        assignments with by default."""
        dev = self.dev if dev is None else dev
        fp = dev.fingerprint()
        eng = self._twin_cache.get(fp)
        if eng is None:
            if len(self._twin_cache) >= 4:
                self._twin_cache.pop(next(iter(self._twin_cache)))
            eng = self._twin_cache[fp] = TorchWCEngine(
                self.flat_graph, dev, backend=self.oracle_backend,
                device=self.device)
        return eng

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
        masked in-update; the dispatch is discarded).  ``n_devices`` N
        shards each batch over the default ``torch.distributed`` group of
        N ranks, one trainer a rank on the same params, draws and
        generator seed (:func:`~.train_fused.build_fused_stage2`): every
        rank keeps the same state and records, and ``last_update`` holds
        the whole batch's actions and advantages and the all-reduced
        gradient."""
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
            ("stage2", cfg.graph_key(), n_devices, capture),
            lambda: build_fused_stage2(cfg, self.gd, sg, self.lr_sched,
                                       self.eps_sched, n_devices, capture))
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
              draws=None, refine: bool = True,
              include_flat_cp: bool = False) -> Placement:
        """Answer one placement request.

        Flat trainers: the greedy episode, ``n_samples`` sampled episodes
        (``draws`` injects the step-major tables of ``assign.rollout_batch``)
        and the best assignment so far, all scored in ONE ``engine`` batch
        (default: the oracle on this trainer's device).  The best wins
        (first on ties) and becomes ``best_assignment``.  With
        ``n_samples=0`` this is the reference's flat ``place()``: the
        best-so-far or greedy assignment, scored.

        Hierarchical trainers (the reference's branch): the greedy
        segment assignment, the best so far and three
        CRITICAL-PATH seeds on the segment graph, plus (``include_flat_cp``)
        three on the flat graph, are expanded and scored in ONE ``engine``
        batch (default: ``flat_engine()``, the oracle of the flat graph);
        with more than one level the V-cycle descends from the best
        segment candidate (``HierarchicalPolicy.refine_levels``) and its
        flat result competes; then (``refine``) the winner takes the
        bounded monotone flat refinement.  ``engine`` scores FLAT
        assignments and is passed the trainer's episode.
        ``best_assignment`` stays segment-level (Stage II's)."""
        if self.hier is not None:
            if n_samples or draws is not None:
                raise ValueError("a hierarchical place() pools greedy, the "
                                 "best so far and CP seeds; n_samples and "
                                 "draws are the flat request's population")
            return self._place_hier(engine, refine, include_flat_cp)
        eng = as_engine(engine if engine is not None
                        else self.default_engine())
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

    def _place_hier(self, engine, refine: bool,
                    include_flat_cp: bool) -> Placement:
        eng = as_engine(engine if engine is not None else self.flat_engine())
        ep = self.episode
        t0 = time.perf_counter()
        cands = [self.greedy_assignment()]
        if self.best_assignment is not None:
            cands.append(np.asarray(self.best_assignment))
        cands += [critical_path_assignment(self.g, self.dev, seed=s)
                  for s in range(3)]
        flat = [self.hier.expand(c) for c in cands]
        if include_flat_cp:
            flat += [critical_path_assignment(self.flat_graph, self.dev,
                                              seed=s) for s in range(3)]
        flat = np.stack(flat)
        ts = np.asarray(eng.exec_times(flat, ep), dtype=float)
        k = int(ts.argmin())
        a, t = flat[k], float(ts[k])
        t1 = time.perf_counter()
        if self.hier.n_levels > 1:
            kseg = int(ts[:len(cands)].argmin())
            vc = self.hier.refine_levels(cands[kseg], episode=ep)
            tv = float(eng.exec_times(vc[None, :], ep)[0])
            if tv < t:
                a, t = vc, tv
        t2 = time.perf_counter()
        if refine:
            a, t = self.hier.refine(a, eng, episode=ep)
        t3 = time.perf_counter()
        return Placement(assignment=np.asarray(a), makespan=float(t),
                         greedy=flat[0], population=flat[1:], makespans=ts,
                         seconds={"pool": t1 - t0, "vcycle": t2 - t1,
                                  "refine": t3 - t2},
                         refine_state=self.hier.refine_state if refine
                         else None)

    # -------------------------------------------- dynamic-fleet re-place
    def replace(self, event: FleetEvent | DeviceModel,
                budget_s: float = 5.0, engine=None, cp_seeds: int = 2,
                refine: bool = True, commit: bool = True) -> ReplaceResult:
        """Re-place the graph after a fleet event, warm-starting from the
        trained policy and the previous placement, under a hard
        ``budget_s`` wall-clock contract.

        ``event`` is a :class:`FleetEvent` (applied to the current fleet)
        or a same-size replacement :class:`DeviceModel` (e.g. measured
        post-degradation rates).  The candidate pool, at the policy
        graph's level (segments for a hierarchical trainer):

        1. the surviving-device PROJECTION of the previous placement
           (``hierarchy.project_assignment``: orphans of a lost device
           LPT-redistributed on the new fleet),
        2. the policy's greedy rollout against the graph RE-FEATURIZED
           for the new fleet (no gradient step),
        3. CRITICAL-PATH seeds on the new fleet (the first unconditional,
           so ``makespan <= cp_makespan`` is structural; the rest while
           within budget), cached per (fleet fingerprint, seed).

        All candidates are expanded and scored in ONE ``exec_times`` call
        (``engine`` scores FLAT assignments; default: ``flat_engine`` of
        the new fleet, cached per fingerprint), then the winner takes
        deadline-bounded monotone refinement (no round starts past
        ``t0 + budget_s``).  With ``commit=True`` the trainer swaps to the
        new fleet: graph data, the fused engines dropped (their captured
        graphs, static buffers and ``SimGraph`` were the old fleet's), the
        reward statistics reset (the old fleet's makespan scale),
        ``best_assignment`` the winning candidate at the policy graph's
        level; ``commit=False`` leaves the trainer untouched."""
        t0 = time.perf_counter()
        deadline = t0 + float(budget_s)
        if isinstance(event, FleetEvent):
            new_dev, smap = event.apply(self.dev)
            ev: FleetEvent | None = event
        elif isinstance(event, DeviceModel):
            if event.n != self.dev.n:
                raise ValueError(
                    "fleet size changed: pass a FleetEvent so the "
                    "survivor map can project the old placement")
            new_dev, smap, ev = event, np.arange(self.dev.n), None
        else:
            raise TypeError(f"event must be a FleetEvent or DeviceModel, "
                            f"got {type(event).__name__}")
        fp = new_dev.fingerprint()
        eng = as_engine(engine if engine is not None
                        else self.flat_engine(new_dev))
        ep = self.episode
        gd_new = build_graph_data(self.g, new_dev, self.comm_factor,
                                  self.device)
        a_prev = (np.asarray(self.best_assignment)
                  if self.best_assignment is not None
                  else self._greedy_on(self.gd))
        cands = [project_assignment(self.g, new_dev, a_prev, smap)]
        sources = ["projected"]
        cands.append(self._greedy_on(gd_new))
        sources.append("policy")
        cp_rows: list[int] = []
        for s in range(max(int(cp_seeds), 1)):
            if s > 0 and time.perf_counter() >= deadline:
                break
            a_cp = self._cp_cache.get((fp, s))
            if a_cp is None:
                if len(self._cp_cache) >= 16:
                    self._cp_cache.pop(next(iter(self._cp_cache)))
                a_cp = self._cp_cache[(fp, s)] = critical_path_assignment(
                    self.g, new_dev, seed=s)
            cp_rows.append(len(cands))
            cands.append(a_cp)
            sources.append("cp")
        seg = np.stack(cands)
        flat = self.hier.expand(seg) if self.hier is not None else seg
        ts = np.asarray(eng.exec_times(flat, ep), dtype=float)
        k = int(ts.argmin())
        a, t, source = flat[k].copy(), float(ts[k]), sources[k]
        makespan_before = float(ts[0])
        cp_makespan = float(ts[cp_rows].min()) if cp_rows else float("inf")
        rounds_done = moves = 0
        if refine and time.perf_counter() < deadline:
            gf = self.flat_graph
            cost = (new_dev.exec_overhead_vec[None, :]
                    + gf.flops_array()[:, None]
                    / new_dev.flops_per_sec[None, :])
            cost[gf.input_mask()] = 0.0
            cfg = self.hierarchy
            a2, t2, rounds_done, moves = refine_assignment(
                gf, cost, a, eng, int(new_dev.n), episode=ep + 1,
                rounds=cfg.refine_rounds if cfg is not None else 2,
                top_k=cfg.refine_top_k if cfg is not None else 16,
                deadline=deadline)
            if t2 < t:
                a, t, source = a2, float(t2), "refined"
        latency = time.perf_counter() - t0
        result = ReplaceResult(
            assignment=a, makespan=t, makespan_before=makespan_before,
            cp_makespan=cp_makespan, source=source, latency_s=latency,
            budget_s=float(budget_s),
            within_budget=latency <= float(budget_s),
            fleet_fingerprint=fp, event=ev,
            refine_rounds=rounds_done, refine_moves=moves,
            n_candidates=len(cands))
        if commit:
            self.dev = new_dev
            self.gd = gd_new
            self._fused_cache = {}
            self._r_sum = self._r_sqsum = 0.0
            self._r_count = 0
            if self.hier is not None:
                self.hier.rebind_devices(new_dev)
                self.hier.refine_state = RefineState(a.copy(), float(t),
                                                     rounds_done, moves)
                # Stage II resumes at the segment level: keep the best
                # SEGMENT candidate (the refined flat winner has no
                # segment-level preimage)
                self.best_assignment = seg[k]
                self.best_time = float(ts[k])
            else:
                self.best_assignment = a.copy()
                self.best_time = float(t)
        return result

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


# --------------------------------------------------------------- transfer
def transfer(trainer: DopplerTrainer, target_graph: DataflowGraph,
             dev: DeviceModel, **kwargs) -> DopplerTrainer:
    """Few-shot transfer (Table 4 / App. J): a new trainer on the target
    graph and fleet (``kwargs`` as :class:`DopplerTrainer`'s, ``device``
    among them) with the source's params and a fresh AdamW state; the
    caller then runs k-shot episodes."""
    new = DopplerTrainer(target_graph, dev, **kwargs)
    new.params = tree_map(lambda x: x.to(new.device), trainer.params)
    new.opt_state = adamw_init(new.params)
    return new


# ---------------------------------------------------------------- pretrain
@dataclasses.dataclass
class PretrainTask:
    """One (graph, fleet) cell of the cross-graph pretraining zoo."""
    name: str
    graph: DataflowGraph
    dev: DeviceModel
    noise_sigma: float = 0.0


def zoo_pretrain_tasks(archs: Sequence[str] | None = None,
                       fleets: Sequence[str] | None = None,
                       holdout: Sequence[str] = (),
                       seq: int = 32, n_synthetic: int = 2,
                       seed: int = 0) -> list[PretrainTask]:
    """The pretraining zoo: every (non-held-out) registry architecture's
    block graph paired round-robin with a heterogeneous fleet, plus
    synthetic augmentation (``synthetic_layered`` DAGs and the sharded
    ``ffnn`` at randomized grids, drawn from ``default_rng(seed)`` as the
    reference draws them).  ``archs`` empty or None means every
    architecture; ``holdout`` architectures are excluded end to end (the
    zero-shot evaluation set).  Each architecture's graph is its
    ``model:<arch>`` layer at ``seq`` (``graphs/model_zoo.py``, traced
    from the port's models); ``holdout=ARCH_IDS`` gives the synthetic
    half alone."""
    from ..configs.registry import ARCH_IDS
    from ..graphs.workloads import get_workload, synthetic_layered
    from .devices import HETERO_FLEETS, get_device_model
    fleets = tuple(fleets or HETERO_FLEETS)
    archs = [a for a in (archs or ARCH_IDS) if a not in set(holdout)]
    tasks = []
    for i, arch in enumerate(archs):
        fleet = fleets[i % len(fleets)]
        tasks.append(PretrainTask(
            f"{arch}|{fleet}", get_workload(f"model:{arch}", seq=seq),
            get_device_model(fleet)))
    rng = np.random.default_rng(seed)
    for j in range(n_synthetic):
        if j % 2 == 0:
            g = synthetic_layered(int(rng.integers(4, 9)),
                                  int(rng.integers(6, 13)),
                                  seed=seed + 17 * j)
        else:           # tiled: the sharded decomposer at a random grid
            g = get_workload("ffnn", batch_log2=int(rng.integers(8, 11)),
                             hidden_log2=int(rng.integers(8, 11)),
                             grid=int(rng.integers(2, 4)))
        fleet = fleets[(len(archs) + j) % len(fleets)]
        tasks.append(PretrainTask(f"synth{j}|{g.name}|{fleet}", g,
                                  get_device_model(fleet)))
    return tasks


def pretrain(tasks: Sequence[PretrainTask], seed: int = 0,
             rounds: int = 4, batch_size: int = 8,
             imitation_episodes: int = 2,
             d_hidden: int = 64, d_z: int = 32, d_y: int = 32,
             gnn_layers: int = 2,
             lr0: float = 3e-3, lr1: float = 1e-5,
             eps0: float = 0.2, eps1: float = 0.0,
             entropy_weight: float = 1e-2, normalize_adv: bool = True,
             sim_engine: str = "batched", log_every: int = 0,
             device: str | torch.device = "cuda",
             draws: Sequence | None = None) -> dict:
    """Train ONE dual-policy parameter set across many graph x fleet
    tasks (GDP/Placeto-style cross-graph generalization).

    The policy's shapes do not depend on the graph or the fleet, so one
    ``(params, opt_state)`` pair round-robins over one
    :class:`DopplerTrainer` per task (seed ``seed + i``, on ``device``):
    ``imitation_episodes`` CP-imitation passes, then per round one
    batched REINFORCE update per task against the numpy
    ``WCSimulator(noise_sigma=task.noise_sigma)`` (float64 rewards, as
    the reference).  Each task keeps its OWN reward statistics:
    makespans differ by orders of magnitude across graphs.  ``draws[i][r]``
    holds the injected tables of task i's update in round r (None: each
    trainer's generator).

    Returns ``{"params", "meta", "per_task"}``; feed ``params`` to
    :class:`~repro_torch.launch.place_server.PlacementServer` (or
    ``policy_io.save_pretrained``) for zero-shot serving."""
    if not tasks:
        raise ValueError("pretrain needs at least one task")
    total = imitation_episodes + rounds * batch_size
    trainers, engines = [], []
    for i, t in enumerate(tasks):
        trainers.append(DopplerTrainer(
            t.graph, t.dev, seed=seed + i, d_hidden=d_hidden,
            gnn_layers=gnn_layers, lr0=lr0, lr1=lr1, eps0=eps0, eps1=eps1,
            entropy_weight=entropy_weight, normalize_adv=normalize_adv,
            total_episodes=max(total, 1), device=device))
        engines.append(SimRewardEngine(
            WCSimulator(t.graph, t.dev, choose="fifo",
                        noise_sigma=t.noise_sigma),
            sim_engine=sim_engine))
    params = tree_map(lambda x: x.to(trainers[0].device), init_policies(
        torch.Generator().manual_seed(seed), d_hidden=d_hidden, d_z=d_z,
        d_y=d_y, gnn_layers=gnn_layers))
    opt_state = adamw_init(params)

    # Stage I warm start, round-robin so no task dominates the schedule
    for ep in range(imitation_episodes):
        for tr in trainers:
            tr.params, tr.opt_state = params, opt_state
            tr.stage1_imitation(1, seed=seed + ep)
            params, opt_state = tr.params, tr.opt_state
    # Stage II: one batched update per task per round on shared params
    for rnd in range(rounds):
        for i, (t, tr, eng) in enumerate(zip(tasks, trainers, engines)):
            tr.params, tr.opt_state = params, opt_state
            ts = tr._batched_rl_update(
                eng, batch_size, "pretrain",
                draws=None if draws is None else draws[i][rnd])
            params, opt_state = tr.params, tr.opt_state
            if log_every and (rnd + 1) % log_every == 0:
                print(f"[pretrain] round {rnd+1}/{rounds} {t.name}: "
                      f"mean={ts.mean()*1e3:.2f}ms "
                      f"best={tr.best_time*1e3:.2f}ms")
    meta = {"d_hidden": d_hidden, "d_z": d_z, "d_y": d_y,
            "gnn_layers": gnn_layers, "seed": seed, "rounds": rounds,
            "batch_size": batch_size,
            "imitation_episodes": imitation_episodes,
            "tasks": [t.name for t in tasks]}
    per_task = {t.name: {"best_time": float(tr.best_time)}
                for t, tr in zip(tasks, trainers)}
    return {"params": params, "meta": meta, "per_task": per_task}


# ------------------------------------------------------------------ fleet
class FleetTrainer:
    """Appendix I: at 1000+-node scale the dataflow graph of each
    *repeated* block is assigned once and replicated across every
    data-parallel replica of a uniform fleet.  Each unique block graph
    gets its own :class:`DopplerTrainer` (``trainer_kwargs``, ``device``
    among them); an episode's reward is the mean over the replicas,
    simulated here as independently seeded noisy WC runs."""

    def __init__(self, block_graphs: dict[str, DataflowGraph],
                 dev: DeviceModel, n_replicas: int = 8, seed: int = 0,
                 noise_sigma: float = 0.1, **trainer_kwargs):
        self.n_replicas = n_replicas
        self.trainers = {
            name: DopplerTrainer(g, dev, seed=seed + i, **trainer_kwargs)
            for i, (name, g) in enumerate(block_graphs.items())}
        self.sims = {name: WCSimulator(g, dev, choose="fifo",
                                       noise_sigma=noise_sigma)
                     for name, g in block_graphs.items()}

    def fleet_exec_time(self, name: str, assignment, episode: int,
                        sim_engine: str = "batched") -> float:
        """Mean exec time of the replicated assignment across the fleet:
        one batched K=1 x S=n_replicas sweep."""
        sim = self.sims[name]
        seeds = [episode * self.n_replicas + r for r in range(self.n_replicas)]
        ts = sim.run_batch(assignment, seeds=seeds, engine=sim_engine)[0]
        return float(np.mean(ts))

    def train(self, n_episodes: int, log_every: int = 0,
              batch_size: int = 8, draws: dict | None = None):
        """Train every block policy for ``n_episodes`` episodes, one
        batch-averaged REINFORCE update per ``batch_size`` episodes (the
        last update takes the remainder), each member scored as the mean
        of its replicas' runs.  ``draws[name][u]`` holds the injected
        tables of block ``name``'s update u (None: the generator)."""
        for name, tr in self.trainers.items():
            sim = self.sims[name]

            def fleet_rewards(assigns: np.ndarray) -> np.ndarray:
                # row k plays the episode counter the serial path would
                # have used, so replica seeds line up with fleet_exec_time
                return np.array([
                    sim.run_batch(
                        a, seeds=[(tr.episode + k) * self.n_replicas + r
                                  for r in range(self.n_replicas)])[0].mean()
                    for k, a in enumerate(assigns)])

            remaining, u = n_episodes, 0
            while remaining > 0:
                b = min(batch_size, remaining)
                tr._batched_rl_update(
                    fleet_rewards, b, "fleet",
                    draws=None if draws is None else draws[name][u])
                remaining, u = remaining - b, u + 1
            if log_every:
                print(f"[fleet] {name}: best={tr.best_time*1e3:.2f}ms")

    def assignments(self) -> dict[str, np.ndarray]:
        return {n: t.best_assignment for n, t in self.trainers.items()}
