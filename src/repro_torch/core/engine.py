"""Reward engines (adapted from ``src/repro/core/engine.py``; the port
imports nothing of ``repro``).

Unified reward-engine protocol — one interface over every reward source.

DOPPLER's three stages differ only in where ``ExecTime(A)`` comes from:
the WC digital twin (Stage II: the serial reference loop, the compiled
batch engine, or the oracle on the card, ``sim_torch.TorchWCEngine``,
which takes the place of the reference's ``JaxOracleEngine``) or the real
work-conserving executor (Stage III: the observed wall-clock of
``executor.WCExecutor``, one CUDA stream a logical device).  Every source
is a :class:`RewardEngine` — ``exec_times(assignments, episode) -> (K,)``
plus capability flags — and ``DopplerTrainer`` has one engine-driven
update core (``training.train_rl``).

Capability flags drive the trainer and evaluator:

* ``batched``       — the engine scores K assignments in one call
  (otherwise the adapter loops for it).
* ``deterministic`` — the reward is seed-independent (noise-free sim /
  oracle); repeated evaluations of one assignment dedup to a single call.
* ``measured``      — rewards are wall-clock observations of a real
  system (the executor), i.e. non-replayable: repeats reduce noise
  instead of being redundant.

Seed convention (as in the reference): a K-row reward query at trainer
episode ``e`` uses seeds ``e*K + k`` — at K=1 exactly the ``seed=episode``
of the serial ``stage2_sim`` loop.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


class RewardEngine:
    """Protocol base: a reward source scoring assignments in seconds.

    Subclasses set the capability flags and implement
    :meth:`exec_times`; :meth:`evaluate_repeats` has a generic
    implementation driven by the flags (deterministic engines dedup,
    batched engines evaluate in one shot).
    """

    name: str = "engine"
    batched: bool = False           # scores K assignments per call
    deterministic: bool = False     # seed-independent rewards
    measured: bool = False          # wall-clock of a real system

    def exec_times(self, assignments, episode: int = 0) -> np.ndarray:
        """(K, n) assignments -> (K,) ExecTime seconds.

        ``episode`` is the trainer's episode counter at call time; seeded
        engines derive their per-row seeds from it (``episode*K + k``).
        """
        raise NotImplementedError

    def exec_time(self, assignment, episode: int = 0) -> float:
        """Single-assignment convenience: at K=1 the seed convention
        reduces to ``seed=episode`` — the serial per-episode protocol's
        reward call (``WCSimulator.exec_time(a, seed=episode)`` shape)."""
        return float(self.exec_times(np.asarray(assignment)[None, :],
                                     episode)[0])

    # ---------------------------------------------------------- evaluate
    def evaluate_repeats(self, assignment, n_runs: int,
                         seed0: int = 1000) -> np.ndarray:
        """`n_runs` repeated evaluations of ONE assignment -> (n_runs,).

        The paper's evaluation protocol (mean +/- std over repeated
        executions).  Deterministic engines run once and broadcast;
        batched engines score all repeats in a single call; everything
        else loops."""
        a = np.asarray(assignment)
        if self.deterministic:
            t = float(self.exec_times(a[None, :], episode=seed0)[0])
            return np.full(n_runs, t)
        if self.batched:
            return np.asarray(self.exec_times(
                np.tile(a, (n_runs, 1)), episode=seed0), dtype=float)
        return np.array([float(self.exec_times(a[None, :],
                                               episode=seed0 + i)[0])
                         for i in range(n_runs)])


# ---------------------------------------------------------------------------
# Simulator adapters
# ---------------------------------------------------------------------------
class SimRewardEngine(RewardEngine):
    """`WCSimulator` as a reward engine — Stage II's digital twin.

    ``sim_engine`` selects the evaluation path: 'batched' (the compiled
    sim_batch.py engine, the default) or 'serial' (the reference event
    loop).  Both are bit-identical per the sim_batch equivalence
    contract, so either choice reproduces the pre-engine trainer
    trajectories for the same seeds."""

    batched = True

    def __init__(self, sim, sim_engine: str = "batched"):
        self.sim = sim
        self.sim_engine = sim_engine
        self.name = f"sim[{sim.choose},sigma={sim.noise_sigma:g}]"

    @property
    def deterministic(self) -> bool:
        return self.sim.noise_sigma <= 0 and self.sim.choose != "random"

    def exec_times(self, assignments, episode: int = 0) -> np.ndarray:
        A = np.asarray(assignments)
        if A.ndim == 1:
            A = A[None, :]
        K = A.shape[0]
        seeds = [episode * K + k for k in range(K)]
        return np.asarray(self.sim.run_paired(A, seeds,
                                              engine=self.sim_engine))

    def evaluate_repeats(self, assignment, n_runs: int,
                         seed0: int = 1000) -> np.ndarray:
        # the historical evaluate() protocol: seeds seed0..seed0+n-1
        return np.asarray(self.sim.run_batch(
            assignment, seeds=[seed0 + i for i in range(n_runs)],
            engine=self.sim_engine)[0])


# ---------------------------------------------------------------------------
# Real-system adapter
# ---------------------------------------------------------------------------
class ExecutorRewardEngine(RewardEngine):
    """The real WC executor as a Stage-III reward engine.

    ``exec_times`` runs each assignment ``repeats`` times through the
    executor's plan-compiled batch path (repeats interleaved across the
    batch — common-random-numbers denoising: every assignment's r-th
    measurement sees similar machine conditions) and reduces with
    ``reduce`` ('median' | 'mean' | 'min')."""

    batched = True
    measured = True
    name = "executor"

    _REDUCERS = {"median": np.median, "mean": np.mean, "min": np.min}

    def __init__(self, executor, repeats: int = 1, reduce: str = "median"):
        if reduce not in self._REDUCERS:
            raise ValueError(f"unknown reduce {reduce!r}; "
                             f"have {sorted(self._REDUCERS)}")
        self.executor = executor
        self.repeats = repeats
        self.reduce = reduce

    def exec_times(self, assignments, episode: int = 0) -> np.ndarray:
        A = np.asarray(assignments)
        if A.ndim == 1:
            A = A[None, :]
        ts = self.executor.execute_batch(A, repeats=self.repeats)
        return self._REDUCERS[self.reduce](ts, axis=1)

    def evaluate_repeats(self, assignment, n_runs: int,
                         seed0: int = 1000) -> np.ndarray:
        a = np.asarray(assignment)
        return np.asarray(self.executor.execute_batch(
            a[None, :], repeats=n_runs)[0])


# ---------------------------------------------------------------------------
# Callable adapter
# ---------------------------------------------------------------------------
class CallableEngine(RewardEngine):
    """Wrap a plain ``fn(assignment) -> seconds`` (or, with
    ``batched=True``, ``fn(assignments) -> (K,)``) as a reward engine so
    ad-hoc reward sources ride the same trainer/evaluator paths."""

    def __init__(self, fn: Callable, batched: bool = False,
                 deterministic: bool = False, name: str = "callable"):
        self.fn = fn
        self.batched = batched
        self.deterministic = deterministic
        self.name = name

    def exec_times(self, assignments, episode: int = 0) -> np.ndarray:
        A = np.asarray(assignments)
        if A.ndim == 1:
            A = A[None, :]
        if self.batched:
            return np.asarray(self.fn(A), dtype=float).reshape(A.shape[0])
        return np.array([float(self.fn(a)) for a in A])


# ---------------------------------------------------------------------------
# Coercion
# ---------------------------------------------------------------------------
def as_engine(obj, **kwargs) -> RewardEngine:
    """Coerce any reward source to a :class:`RewardEngine`.

    Accepts an engine (returned as-is; ``sim_torch.TorchWCEngine`` is
    one), a ``WCSimulator``, a ``WCExecutor``, or a plain callable;
    ``kwargs`` pass through to the adapter constructor."""
    if isinstance(obj, RewardEngine):
        return obj
    # late import: keep engine.py import-light and cycle-free
    from .simulator import WCSimulator
    if isinstance(obj, WCSimulator):
        return SimRewardEngine(obj, **kwargs)
    from .executor import WCExecutor
    if isinstance(obj, WCExecutor):
        return ExecutorRewardEngine(obj, **kwargs)
    if callable(obj):
        return CallableEngine(obj, **kwargs)
    raise TypeError(f"cannot adapt {type(obj).__name__} to a RewardEngine")
