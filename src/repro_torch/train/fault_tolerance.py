"""Copy of ``src/repro/train/fault_tolerance.py`` (the port imports nothing of ``repro``);
``supervise_stage2`` has the port's trainer hooks.

Fault tolerance: supervised training loop with checkpoint/restart,
elastic mesh re-formation, straggler handling, and dynamic-fleet
re-placement.

At 1000+-node scale the failure model is: a worker (or a whole pod)
disappears mid-step, or degrades without disappearing.  The supervisor's
contract:

  1. every step runs under a watchdog; a raised DeviceFailure (or any
     exception from the step function) triggers recovery, not job death;
  2. recovery = re-form the mesh from the surviving device list, re-shard
     the last durable checkpoint onto it (checkpoint.py restores
     logically, so any mesh shape works), fast-forward the data stream,
     and resume;
  3. stragglers: a worker whose step time exceeds `straggler_factor` x the
     fleet median gets its data cursor skipped ahead (data.skip_ahead) —
     the op-level analogue inside a step is the WC engine itself, which is
     the paper's whole premise;
  4. fleet events: schedule entries may be :class:`~repro_torch.core.
     devices.FleetEvent`s.  A ``device_loss`` raises a DeviceFailure carrying the
     event, so recovery re-forms the fleet AND re-places the graph through
     the injected ``replacer`` (``DopplerTrainer.replace`` under its
     ``budget_s`` contract); non-fatal events (straggler onset/recovery,
     link degradation) re-place inline without a rollback.  Every
     re-placement logs makespan-before/after and latency and is recorded
     in ``self.replacements``.

On a single host, failures are *injected* (tests pass a failure
schedule); the recovery machinery is the real code path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core.nn import tree_map
from .optim import AdamState


class DeviceFailure(RuntimeError):
    """Raised (or injected) when a device/worker drops out of the fleet.

    ``event`` optionally carries the :class:`FleetEvent` that caused the
    failure, so the recovery path can re-place on the degraded fleet."""

    def __init__(self, msg: str, event=None):
        super().__init__(msg)
        self.event = event


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_every: int = 50
    keep: int = 3
    max_recoveries: int = 10
    straggler_factor: float = 3.0
    replace_budget_s: float = 5.0


class TrainSupervisor:
    """Drives step_fn with checkpoint/restart + elastic recovery.

    Collaborators (dependency-injected so tests can fake them):
      make_state(mesh)            -> fresh (params, opt_state)
      step_fn(state, batch, step) -> (state, metrics)   [jitted outside]
      make_mesh(n_failures)       -> mesh for the current surviving fleet
      save(step, state) / restore(step, mesh) -> state
      data: SyntheticTokenStream-compatible (next_batch/state/restore/
            skip_ahead)
      replacer(event, step)       -> ReplaceResult-like, optional: invoked
            for every FleetEvent in the schedule (after recovery for a
            device loss, inline otherwise)

    The failure schedule maps step -> ``"device"`` | ``"straggle"`` |
    :class:`FleetEvent`.  String kinds keep the legacy injection
    semantics; FleetEvents additionally flow through ``replacer``.
    """

    def __init__(self, cfg: SupervisorConfig, make_state, step_fn,
                 make_mesh, save, restore, data,
                 failure_schedule: dict[int, object] | None = None,
                 replacer: Callable | None = None):
        self.cfg = cfg
        self.make_state = make_state
        self.step_fn = step_fn
        self.make_mesh = make_mesh
        self.save = save
        self.restore = restore
        self.data = data
        self.failure_schedule = failure_schedule or {}
        self.replacer = replacer
        self.recoveries = 0
        self.n_failures = 0
        self.step_times: list[float] = []
        # parallel to step_times: True for steps whose duration must not
        # enter the median baseline (injected delays, detected stragglers)
        self.tainted: list[bool] = []
        self.replacements: list = []
        self.log: list[str] = []

    # ------------------------------------------------------- injection
    def _maybe_inject(self, step: int) -> bool:
        """Fire this step's scheduled event, if any.  Returns True when an
        artificial straggler delay was injected — the caller must keep
        that step's wall clock out of the median baseline."""
        kind = self.failure_schedule.pop(step, None)   # one-shot events
        if kind is None:
            return False
        if kind == "device":
            raise DeviceFailure(f"injected device failure at step {step}")
        if kind == "straggle":
            time.sleep(self.cfg.straggler_factor
                       * (self._median_step() or 0.01) * 1.5)
            return True
        # FleetEvent: fatal kinds go through the recovery path carrying
        # the event; non-fatal degradations re-place inline and continue
        ev_kind = getattr(kind, "kind", None)
        if ev_kind == "device_loss":
            raise DeviceFailure(
                f"injected device_loss(device={kind.device}) at step "
                f"{step}", event=kind)
        if ev_kind is not None:
            self._replace(kind, step)
            return False
        raise ValueError(f"unknown failure-schedule entry at step {step}: "
                         f"{kind!r}")

    # ----------------------------------------------------- re-placement
    def _replace(self, event, step: int):
        if self.replacer is None:
            self.log.append(f"event@{step}: {event.kind} ignored "
                            f"(no replacer wired)")
            return None
        res = self.replacer(event, step)
        self.replacements.append(res)
        self.log.append(
            f"replace@{step}: kind={event.kind} "
            f"before={res.makespan_before:.4g} after={res.makespan:.4g} "
            f"latency={res.latency_s * 1e3:.1f}ms "
            f"within_budget={res.within_budget}")
        return res

    # ------------------------------------------------ straggler baseline
    def _median_step(self) -> float | None:
        """Median step time over CLEAN steps only.  Injected delays and
        already-flagged stragglers are excluded — one slow step must not
        inflate the baseline and mask the next genuine straggler."""
        clean = [dt for dt, bad in zip(self.step_times, self.tainted)
                 if not bad]
        return float(np.median(clean)) if clean else None

    def run(self, n_steps: int) -> dict:
        mesh = self.make_mesh(self.n_failures)
        state = self.make_state(mesh)
        last_ckpt = -1
        step = 0
        metrics_hist = []
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                injected = self._maybe_inject(step)
                batch = self.data.next_batch()
                state, metrics = self.step_fn(state, batch, step)
                dt = time.perf_counter() - t0
                # straggler detection: skip-ahead if we fell behind
                base = self._median_step()
                straggled = (base is not None
                             and dt > self.cfg.straggler_factor * base)
                if straggled:
                    skipped = self.data.skip_ahead(step + 1)
                    self.log.append(f"straggler@{step}: skipped {skipped}")
                self.step_times.append(dt)
                self.tainted.append(injected or straggled)
                metrics_hist.append(metrics)
                if step % self.cfg.ckpt_every == 0:
                    self.save(step, state,
                              extra={"data": self.data.state()})
                    last_ckpt = step
                step += 1
            except DeviceFailure as e:
                self.recoveries += 1
                self.n_failures += 1
                self.log.append(f"recover@{step}: {e}")
                if self.recoveries > self.cfg.max_recoveries:
                    raise
                mesh = self.make_mesh(self.n_failures)
                if last_ckpt < 0:
                    # no durable state yet: restart from scratch — and
                    # drop the stale history, or replayed steps would be
                    # double-counted
                    state = self.make_state(mesh)
                    del metrics_hist[:]
                    del self.step_times[:]
                    del self.tainted[:]
                    step = 0
                else:
                    # elastic recovery: new (possibly smaller) mesh +
                    # re-shard; history rolls back with the step counter
                    # (steps 0..last_ckpt ran exactly once)
                    state, extra = self.restore(last_ckpt, mesh)
                    self.data.restore(extra["data"])
                    keep = last_ckpt + 1
                    del metrics_hist[keep:]
                    del self.step_times[keep:]
                    del self.tainted[keep:]
                    step = last_ckpt + 1
                if e.event is not None:
                    self._replace(e.event, step)
        return {"steps": step, "recoveries": self.recoveries,
                "metrics": metrics_hist, "log": self.log,
                "replacements": list(self.replacements)}


# ------------------------------------------------- Stage II under events
class _CursorStream:
    """Minimal data collaborator for supervised RL training: Stage II has
    no token stream (the reward engine IS the data source), so batches
    are just a replayable step cursor."""

    def __init__(self):
        self.cursor = 0

    def next_batch(self):
        c = self.cursor
        self.cursor += 1
        return c

    def state(self):
        return {"cursor": self.cursor}

    def restore(self, st):
        self.cursor = int(st["cursor"])

    def skip_ahead(self, step: int) -> int:
        skipped = max(0, step - self.cursor)
        self.cursor = max(self.cursor, step)
        return skipped


def _snapshot(trainer) -> tuple:
    """The trainer state a rollback restores: copies of params and the
    AdamW state (a fused engine updates its buffers in place), the
    generator's state (the port's counterpart of the reference's PRNG
    key: without it a rollback replays other draws), the episode counter,
    reward statistics and the best so far."""
    opt = trainer.opt_state
    step = opt.step.clone() if torch.is_tensor(opt.step) else opt.step
    best = trainer.best_assignment
    return (tree_map(torch.clone, trainer.params),
            AdamState(step, tree_map(torch.clone, opt.mu),
                      tree_map(torch.clone, opt.nu)), trainer.generator.get_state(), trainer.episode,
            trainer._r_sum, trainer._r_sqsum, trainer._r_count,
            None if best is None else np.array(best), trainer.best_time)


def _restore(trainer, snap: tuple) -> None:
    (trainer.params, trainer.opt_state, gen_state, trainer.episode,
     trainer._r_sum, trainer._r_sqsum, trainer._r_count,
     trainer.best_assignment, trainer.best_time) = snap
    trainer.generator.set_state(gen_state)
    # the fused engines' static buffers held the abandoned steps' state
    trainer._fused_cache = {}


def supervise_stage2(trainer, n_steps: int,
                     events: dict[int, object] | None = None,
                     cfg: SupervisorConfig | None = None,
                     batch_size: int = 8) -> dict:
    """Run Stage-II training under the supervisor with a FleetEvent
    schedule: one supervised "step" = one batched REINFORCE update
    against the WC twin (the numpy ``WCSimulator``, noise 0.05) of the
    trainer's CURRENT fleet.  Device losses roll back to the last
    in-memory snapshot, re-form the fleet, and re-place within
    ``cfg.replace_budget_s``; non-fatal events re-place inline.  Returns
    the supervisor's run dict plus the supervisor itself under
    ``"supervisor"``.

    Snapshots are in-memory (``_snapshot``): the fleet is deliberately
    NOT restored, since recovery resumes the restored policy on the
    SURVIVING fleet.
    """
    from ..core.engine import as_engine
    from ..core.simulator import WCSimulator

    cfg = cfg or SupervisorConfig(ckpt_every=5, replace_budget_s=5.0)
    ckpts: dict[int, tuple] = {}
    eng_cache: dict[int, object] = {}

    def make_state(mesh):
        return (trainer.params, trainer.opt_state)

    def step_fn(state, batch, step):
        # the WC twin is fleet-specific: rebuild when replace() swaps it
        eng = eng_cache.get(id(trainer.dev))
        if eng is None:
            eng_cache.clear()
            eng = eng_cache[id(trainer.dev)] = as_engine(
                WCSimulator(trainer.g, trainer.dev, choose="fifo",
                            noise_sigma=0.05))
        ts = trainer._batched_rl_update(eng, batch_size, "sim_dyn")
        return (trainer.params, trainer.opt_state), float(ts.mean())

    def make_mesh(n_failures):
        return trainer.dev

    def save(step, state, extra=None):
        ckpts[step] = (_snapshot(trainer), extra)
        for old in sorted(ckpts)[:-cfg.keep]:
            del ckpts[old]

    def restore(step, mesh):
        snap, extra = ckpts[step]
        _restore(trainer, snap)
        return (trainer.params, trainer.opt_state), extra

    def replacer(event, step):
        return trainer.replace(event, budget_s=cfg.replace_budget_s)

    sup = TrainSupervisor(cfg, make_state, step_fn, make_mesh, save,
                          restore, _CursorStream(),
                          failure_schedule=dict(events or {}),
                          replacer=replacer)
    out = sup.run(n_steps)
    out["supervisor"] = sup
    return out
