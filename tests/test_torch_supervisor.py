"""The fault-tolerance supervisor in the port (``train/fault_tolerance.py``):
the reference's supervisor tests (``tests/test_dynamic.py``, the faked
collaborators of ``_mini_supervisor``; ``tests/test_substrate.py``'s
checkpoint-file recovery) run against the port, and ``supervise_stage2``
with one injected device loss held against the reference's run of the
same scenario: the same rewards, history, re-placement, fleet and best
assignment, which needs the generator's state in the snapshot.
"""
import time

import jax
import numpy as np
import pytest
import torch

from conftest import random_dag
from repro.core import training as jax_training
from repro.core.devices import FleetEvent as JaxFleetEvent
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.zero_shot import to_numpy_params
from repro.train.fault_tolerance import SupervisorConfig as JaxSupervisorConfig
from repro.train.fault_tolerance import supervise_stage2 as jax_supervise
from repro_torch.core import training
from repro_torch.core.devices import FleetEvent, uniform_box
from repro_torch.core.engine import SimRewardEngine
from repro_torch.core.nn import tree_leaves
from repro_torch.core.simulator import WCSimulator
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.fault_tolerance import (DeviceFailure,
                                               SupervisorConfig,
                                               TrainSupervisor,
                                               _CursorStream,
                                               supervise_stage2)
from test_torch_stage2 import reference_draws
from test_torch_pretrain import one_thread_a_process  # noqa: F401
from test_torch_train import assert_params_close, port_graph


# ----------------------------------------------- supervisor (faked deps)
def _mini_supervisor(schedule, cfg=None, slow_steps=(),
                     replacer=None, n_devices=4):
    """TrainSupervisor over trivial faked collaborators; ``slow_steps``
    lists step indices whose step_fn sleeps (genuine stragglers)."""
    ckpts = {}

    class Stream:
        def __init__(self):
            self.cursor = 0
            self.skips = []

        def next_batch(self):
            self.cursor += 1
            return self.cursor - 1

        def state(self):
            return {"cursor": self.cursor}

        def restore(self, st):
            self.cursor = st["cursor"]

        def skip_ahead(self, step):
            self.skips.append(step)
            d = max(0, step - self.cursor)
            self.cursor = max(self.cursor, step)
            return d

    stream = Stream()
    sup = TrainSupervisor(
        cfg or SupervisorConfig(ckpt_every=2, max_recoveries=5),
        make_state=lambda mesh: 0,
        step_fn=lambda s, b, step: (
            time.sleep(0.04 if step in slow_steps else 0.004)
            or (s + 1, step)),
        make_mesh=lambda nf: f"mesh-{nf}",
        save=lambda step, state, extra=None: ckpts.__setitem__(
            step, (state, extra)),
        restore=lambda step, mesh: ckpts[step],
        data=stream, failure_schedule=schedule, replacer=replacer)
    return sup, stream


def test_injected_straggles_do_not_poison_median():
    sup, _ = _mini_supervisor(
        {3: "straggle", 4: "straggle", 5: "straggle", 6: "straggle"},
        slow_steps=(7,))
    out = sup.run(10)
    assert out["steps"] == 10
    stragglers = [l for l in out["log"] if l.startswith("straggler@7")]
    assert stragglers, f"genuine straggler at step 7 undetected: {out['log']}"
    assert all(sup.tainted[3:8])
    clean = [dt for dt, bad in zip(sup.step_times, sup.tainted) if not bad]
    assert np.median(clean) < 0.02


def test_history_truncated_after_mid_run_failure():
    sup, _ = _mini_supervisor({7: "device", 13: "device"})
    out = sup.run(20)
    assert out["steps"] == 20
    assert out["recoveries"] == 2
    assert len(out["metrics"]) == 20
    assert len(sup.step_times) == 20
    assert len(sup.tainted) == 20
    assert out["metrics"] == list(range(20))


def test_history_cleared_on_restart_from_scratch():
    sup, _ = _mini_supervisor(
        {0: "device"}, cfg=SupervisorConfig(ckpt_every=100,
                                            max_recoveries=5))
    out = sup.run(6)
    assert out["steps"] == 6
    assert len(out["metrics"]) == 6
    assert out["metrics"] == list(range(6))


def test_supervisor_event_schedule_recovers_and_replaces():
    calls = []

    class FakeResult:
        makespan_before, makespan = 2.0, 1.0
        latency_s, within_budget = 0.01, True

    def replacer(event, step):
        calls.append((event.kind, step))
        return FakeResult()

    sup, _ = _mini_supervisor(
        {5: FleetEvent.device_loss(3),
         9: FleetEvent.straggler_onset(1, 0.5)}, replacer=replacer)
    out = sup.run(14)
    assert out["steps"] == 14
    assert out["recoveries"] == 1             # only the loss is fatal
    assert len(out["replacements"]) == 2
    assert ("device_loss", 5) in calls
    assert any(l.startswith("replace@") and "device_loss" in l
               for l in out["log"])
    assert any("straggler_onset" in l for l in out["log"])
    assert len(out["metrics"]) == 14          # continuity after rollback


def test_supervise_stage2_end_to_end():
    g = port_graph(random_dag(np.random.default_rng(6), 24))
    tr = training.DopplerTrainer(g, uniform_box(4), seed=0, device="cpu")
    out = supervise_stage2(
        tr, 8, events={3: FleetEvent.device_loss(3)},
        cfg=SupervisorConfig(ckpt_every=2, replace_budget_s=10.0),
        batch_size=4)
    assert out["steps"] == 8
    assert out["recoveries"] == 1
    assert len(out["metrics"]) == 8
    assert len(out["replacements"]) == 1
    res = out["replacements"][0]
    assert res.makespan <= res.cp_makespan + 1e-9
    assert res.within_budget
    assert tr.dev.n == 3                      # training resumed on 3 devs
    assert tr.best_assignment.max() < 3
    assert any(l.startswith("replace@") for l in out["log"])


def test_supervisor_legacy_schedule_unchanged():
    sup, _ = _mini_supervisor({2: "device"})
    out = sup.run(6)
    assert out["recoveries"] == 1 and out["steps"] == 6
    assert out["replacements"] == []


def test_supervisor_event_without_replacer_is_logged():
    sup, _ = _mini_supervisor({2: FleetEvent.straggler_onset(0, 0.5)})
    out = sup.run(5)
    assert out["steps"] == 5
    assert any("no replacer wired" in l for l in out["log"])


def test_supervisor_recovers_from_injected_failures(tmp_path):
    """``tests/test_substrate.py``'s recovery through checkpoint files,
    with the port's ``train/checkpoint.py`` and a cursor stream (the
    token stream is not ported)."""
    def step_fn(state, batch, step):
        return ({"step_sum": state["step_sum"] + 1}, {"loss": float(step)})

    def save(step, state, extra=None):
        save_checkpoint(tmp_path, step, state, extra=extra)

    def restore(step, mesh):
        return restore_checkpoint(tmp_path, step,
                                  {"step_sum": torch.zeros(())})

    sup = TrainSupervisor(SupervisorConfig(ckpt_every=5, max_recoveries=5),
                          lambda mesh: {"step_sum": torch.zeros(())},
                          step_fn, lambda n: f"mesh_minus_{n}", save,
                          restore, _CursorStream(),
                          failure_schedule={7: "device", 13: "device"})
    out = sup.run(20)
    assert out["steps"] == 20
    assert out["recoveries"] == 2
    assert any("recover@7" in line for line in out["log"])
    assert [m["loss"] for m in out["metrics"]] == [float(s)
                                                   for s in range(20)]
    with pytest.raises(DeviceFailure):
        TrainSupervisor(SupervisorConfig(max_recoveries=0),
                        lambda mesh: 0, lambda s, b, i: (s, i),
                        lambda n: None, lambda *a, **k: None,
                        lambda s, m: (0, {"data": {"cursor": 0}}),
                        _CursorStream(),
                        failure_schedule={1: "device"}).run(3)


# ------------------------------- supervise_stage2 against the reference
def test_supervise_stage2_with_a_device_loss_matches_reference(monkeypatch):
    """One injected device loss at step 4 of 8 (snapshots every 2): the
    reference rolls back to step 2 with its PRNG key, re-places on 3
    devices and replays steps 3.. on its key chain (step 3 twice).  The port's updates
    draw the reference's tables of the chain position its generator is
    at (one token an update, from the generator), so a snapshot that
    lost the generator's state would replay other draws and end
    elsewhere.  Both re-place with the float64 numpy twin (the
    reference's default engine for ``replace``)."""
    gj = random_dag(np.random.default_rng(6), 24)
    kw = dict(seed=0, d_hidden=16, eps0=0.2, eps1=0.0, total_episodes=200)
    jt = jax_training.DopplerTrainer(gj, jax_uniform_box(4), **kw)
    pt = training.DopplerTrainer(port_graph(gj), uniform_box(4),
                                 device="cpu", **kw)
    pt.params = params_from_numpy(to_numpy_params(jt.params))
    monkeypatch.setattr(pt, "flat_engine", lambda dev=None: SimRewardEngine(
        WCSimulator(pt.flat_graph, dev or pt.dev, noise_sigma=0.0)))

    K, n_steps = 4, 8
    key, chain = jt.key, []
    for _ in range(n_steps + 2):
        key, sub = jax.random.split(key)
        chain.append(sub)
    tables = {}
    tokens = torch.Generator().manual_seed(0)
    tokens.set_state(pt.generator.get_state())
    position = {int(torch.randint(2 ** 62, (1,), generator=tokens)): j
                for j in range(n_steps + 2)}
    orig, position_calls = pt._batched_rl_update, []

    def update(reward, batch_size, stage, **k):
        j = position[int(torch.randint(2 ** 62, (1,),
                                       generator=pt.generator))]
        position_calls.append(j)
        if (j, pt.dev.n) not in tables:      # the fleet shrinks at 4
            tables[j, pt.dev.n] = reference_draws(
                jax.random.split(chain[j], K), pt.g.n, pt.dev.n)
        return orig(reward, batch_size, stage, draws=tables[j, pt.dev.n],
                    **k)

    monkeypatch.setattr(pt, "_batched_rl_update", update)

    want = jax_supervise(jt, n_steps, events={4: JaxFleetEvent.device_loss(
        3)}, cfg=JaxSupervisorConfig(ckpt_every=2, replace_budget_s=1e9),
        batch_size=K)
    got = supervise_stage2(pt, n_steps, events={4: FleetEvent.device_loss(
        3)}, cfg=SupervisorConfig(ckpt_every=2, replace_budget_s=1e9),
        batch_size=K)
    assert (got["steps"], got["recoveries"]) == (want["steps"],
                                                 want["recoveries"]) == (
        n_steps, 1)
    assert got["metrics"] == want["metrics"]          # bit-identical means
    assert position_calls == [0, 1, 2, 3, 3, 4, 5, 6, 7]   # 3 replayed
    (rg,), (rw,) = got["replacements"], want["replacements"]
    for f in ("makespan", "makespan_before", "cp_makespan", "source",
              "n_candidates", "fleet_fingerprint"):
        assert getattr(rg, f) == getattr(rw, f), f
    assert np.array_equal(rg.assignment, rw.assignment)
    assert pt.dev.n == jt.dev.n == 3
    assert pt.history == [training.EpisodeRecord(**vars(h))
                          for h in jt.history]
    assert pt.best_time == jt.best_time
    assert np.array_equal(pt.best_assignment, jt.best_assignment)
    assert (pt.episode, pt._r_count) == (jt.episode, jt._r_count)
    assert_params_close(pt, jt)
