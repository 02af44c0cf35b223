"""Stage III of the port (``stage3_system_batched``, ``stage3_system``)
against the JAX reference trainer, on the reference's draws (at eps 0, and
the serial protocol also at eps 0.2).

Wall-clock cannot be replayed, so the executor is stood in for by a
deterministic one on both sides: the noise-free ``WCSimulator`` (the
reference's and the port's numpy copy), its makespan repeated for every
measurement, behind each package's ``ExecutorRewardEngine``.  Each update
(``tests/test_torch_stage2.py``'s ``step_pair``): rewards bit-identical,
the reference's actions and advantages, and the step held against the
reference's loss, gradient and AdamW step (the A5b bars); at the end the
bookkeeping equal and params within 5e-3 of the reference trainer's.
Also: ``repeats`` re-wraps an executor engine (keeping its ``reduce``),
a ``WCExecutor`` is wrapped, any other system with ``repeats != 1``
raises on both sides, and ``evaluate`` measures an executor's repeats
in one batch.
"""
import numpy as np
import pytest

from repro.core import engine as jax_engine
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro_torch.core import executor
from repro_torch.core.engine import ExecutorRewardEngine
from repro_torch.core.simulator import WCSimulator
from test_torch_stage2 import EPS0, EPS02, _same_bookkeeping, step_pair
from test_torch_train import assert_params_close, trainer_pair


class SimExecutor:
    """A deterministic executor: every measurement of a row is the
    noise-free simulator's makespan (records each call's shape and
    repeats)."""

    def __init__(self, sim):
        self.sim = sim
        self.calls = []

    def execute_batch(self, assignments, repeats=1):
        A = np.asarray(assignments)
        self.calls.append((A.shape, repeats))
        return np.repeat(self.sim.run_batch(A)[:, :1], repeats, axis=1)


def stand_ins(jt, pt):
    """(reference engine, port engine) over each side's simulator."""
    jex = SimExecutor(JaxWCSimulator(jt.g, jt.dev, noise_sigma=0.0))
    pex = SimExecutor(WCSimulator(pt.g, pt.dev, noise_sigma=0.0))
    return (jax_engine.ExecutorRewardEngine(jex, reduce="min"),
            ExecutorRewardEngine(pex, reduce="min"))


@pytest.mark.parametrize("gname,fleet", [("diamond", "mixed_gen4"),
                                         ("ffnn", "p100x4")])
def test_stage3_system_batched_matches_reference(gname, fleet):
    """3 updates at K 4, ``repeats`` 3: each side re-wraps its engine at
    3 repeats with its ``reduce``."""
    jt, pt = trainer_pair(gname, fleet, **EPS0)
    jeng, peng = stand_ins(jt, pt)
    for _ in range(3):
        step_pair(jt, pt,
                  lambda: jt.stage3_system_batched(1, jeng, batch_size=4,
                                                   repeats=3),
                  lambda d: pt.stage3_system_batched(1, peng, batch_size=4,
                                                     repeats=3, draws=d),
                  K=4, reward=jeng)
    _same_bookkeeping(pt, jt)
    assert_params_close(pt, jt)
    assert [h.stage for h in pt.history] == ["sys_batch"] * 3
    assert peng.executor.calls == [((4, pt.g.n), 3)] * 3
    assert set(pt.seconds) == {"sample", "oracle", "replay_backward",
                               "adamw"}


@pytest.mark.parametrize("sched", [EPS0, EPS02], ids=["eps0", "eps0.2"])
def test_stage3_system_serial_matches_reference(sched):
    """The serial protocol: one episode, one measurement, one gradient;
    the reference gets its engine's ``exec_time``, the port the engine
    (at eps 0.2 the explore branch replays the reference's key too)."""
    jt, pt = trainer_pair("diamond", "mixed_gen4", **sched)
    jeng, peng = stand_ins(jt, pt)
    for _ in range(3):
        step_pair(jt, pt, lambda: jt.stage3_system(1, jeng.exec_time),
                  lambda d: pt.stage3_system(1, peng, draws=d), K=1)
    _same_bookkeeping(pt, jt)
    assert_params_close(pt, jt)
    assert [h.stage for h in pt.history] == ["sys"] * 3
    assert peng.executor.calls == [((1, pt.g.n), 1)] * 3


def test_repeats_only_for_executor_systems():
    jt, pt = trainer_pair("diamond", "p100x4", **EPS0)
    with pytest.raises(ValueError, match="repeats"):
        jt.stage3_system_batched(
            1, JaxWCSimulator(jt.g, jt.dev, noise_sigma=0.0), repeats=2)
    with pytest.raises(ValueError, match="repeats"):
        pt.stage3_system_batched(
            1, WCSimulator(pt.g, pt.dev, noise_sigma=0.0), repeats=2)
    assert pt.episode == 0 and pt.history == []


def test_a_wc_executor_is_wrapped_at_the_asked_repeats(monkeypatch):
    _, pt = trainer_pair("diamond", "p100x4", **EPS0)
    ex = executor.WCExecutor(pt.g, devices=["cpu"], n_virtual=pt.dev.n,
                             flops_scale=1e-6, bytes_scale=1e-4)
    calls = []
    run = ex.execute_batch

    def execute_batch(A, repeats=1):
        calls.append((np.asarray(A).shape, repeats))
        return run(A, repeats=repeats)
    monkeypatch.setattr(ex, "execute_batch", execute_batch)
    ts = pt.stage3_system_batched(2, ex, batch_size=3, repeats=2)
    assert len(ts) == 6 and all(t > 0 for t in ts)
    assert calls == [((3, pt.g.n), 2)] * 2
    assert [h.stage for h in pt.history] == ["sys_batch"] * 2
    assert len(pt.losses) == 2 and pt.episode == 6
    t = pt.stage3_system(1, ex.execute)
    assert len(t) == 1 and t[0] > 0 and pt.history[-1].stage == "sys"


def test_evaluate_measures_an_executors_repeats_in_one_batch():
    _, pt = trainer_pair("diamond", "p100x4", **EPS0)
    pex = SimExecutor(WCSimulator(pt.g, pt.dev, noise_sigma=0.0))
    a = np.arange(pt.g.n) % pt.dev.n
    mean, std, got = pt.evaluate(ExecutorRewardEngine(pex), n_runs=5,
                                 assignment=a)
    assert pex.calls == [((1, pt.g.n), 5)]
    assert std == 0.0 and mean == pex.sim.run_batch(a[None])[0, 0]
    assert np.array_equal(got, a)
