"""The port's reward engines against the JAX package.

* the copied numpy simulators (``core/simulator.py``, ``core/sim_batch.py``)
  keep their contract — the compiled batch engine equals the serial
  ``WCSimulator.run`` bit for bit, noise-free and noisy, for every choose
  strategy — and give the reference's makespans on the same inputs;
* the engine protocol (``core/engine.py``): ``evaluate``'s repeats as in
  ``tests/test_engine.py``, and ``TorchWCEngine`` as the deterministic
  batched engine in ``JaxOracleEngine``'s place.

The Stage II trajectories over these engines are in
``tests/test_torch_stage2.py``.
"""
import numpy as np
import pytest

from conftest import make_chain, make_diamond, random_dag
from repro.core import devices as jax_devices
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro_torch.core import devices, training
from repro_torch.core.engine import (CallableEngine, RewardEngine,
                                     SimRewardEngine, as_engine)
from repro_torch.core.sim_batch import (CompiledGraph, compile_assignment,
                                        run_plan)
from repro_torch.core.sim_torch import TorchWCEngine
from repro_torch.core.simulator import WCSimulator, synchronous_exec_time
from test_torch_train import port_graph

FLEETS = [("uniform_box", (1,)), ("uniform_box", (4,)), ("p100_box", ()),
          ("v100_two_groups", ()), ("tpu_v5e_slice", (2, 2))]


def fleet_pair(i):
    name, args = FLEETS[i]
    return getattr(devices, name)(*args), getattr(jax_devices, name)(*args)


# ------------------------------------------------------ the numpy copies
@pytest.mark.parametrize("seed", range(6))
def test_copied_simulators_batched_equals_serial_and_reference(seed):
    """Random DAG x fleet x strategy x noise: the copy's batch engine ==
    its serial loop, bit for bit, and both == the reference's."""
    rng = np.random.default_rng(seed)
    gj = random_dag(rng, int(rng.integers(6, 40)))
    g = port_graph(gj)
    dev, devj = fleet_pair(seed % len(FLEETS))
    A = rng.integers(0, dev.n, (4, g.n))
    seeds = [seed, seed + 7]
    for choose in ("fifo", "dfs", "random"):
        for sigma in (0.0, 0.05, 0.2):
            sim = WCSimulator(g, dev, choose=choose, noise_sigma=sigma)
            got = sim.run_batch(A, seeds=seeds)
            np.testing.assert_array_equal(
                got, sim.run_batch(A, seeds=seeds, engine="serial"))
            np.testing.assert_array_equal(got, np.array(
                [[sim.run(a, seed=s).makespan for s in seeds] for a in A]))
            ref = JaxWCSimulator(gj, devj, choose=choose, noise_sigma=sigma)
            np.testing.assert_array_equal(got, ref.run_batch(A, seeds=seeds))
            np.testing.assert_array_equal(sim.run_paired(A, [3, 4, 5, 6]),
                                          ref.run_paired(A, [3, 4, 5, 6]))


def test_copied_simulator_invariants():
    """Structured graphs: makespans between the critical-path lower bound
    and the bulk-synchronous time; a corrupted plan raises, not hangs."""
    dev = devices.uniform_box(4)
    rng = np.random.default_rng(1)
    for gj in (make_diamond(), make_diamond(16), make_chain(12)):
        g = port_graph(gj)
        for a in rng.integers(0, 4, (3, g.n)):
            ms = WCSimulator(g, dev).run_batch(a)[0, 0]
            lower = g.critical_path_lower_bound(float(dev.flops_per_sec[0]))
            assert lower * (1 - 1e-9) <= ms
            assert ms <= synchronous_exec_time(g, dev, a) * (1 + 1e-9)
    g = port_graph(make_chain(4))
    cg = CompiledGraph.build(g, devices.uniform_box(2))
    plan = compile_assignment(cg, np.zeros(g.n, dtype=int))
    plan.need0[1] = 99
    with pytest.raises(RuntimeError, match="deadlock"):
        run_plan(cg, plan)


# ---------------------------------------------------- the engine protocol
def test_engines_and_coercion():
    g = port_graph(make_diamond())
    dev = devices.uniform_box(4)
    eng = TorchWCEngine(g, dev, backend="torch", device="cpu")
    assert isinstance(eng, RewardEngine) and as_engine(eng) is eng
    assert eng.batched and eng.deterministic
    assert eng.name == "torch_oracle[torch]"
    A = np.random.default_rng(0).integers(0, 4, (5, g.n))
    np.testing.assert_array_equal(eng.exec_times(A, episode=3),
                                  eng.run_batch(A))
    assert eng.exec_time(A[1]) == eng.run_batch(A[1:2])[0]
    sim = WCSimulator(g, dev, noise_sigma=0.05)
    se = as_engine(sim)
    assert isinstance(se, SimRewardEngine) and not se.deterministic
    # the seed convention: row k of a K-row query at episode e, seed e*K+k
    np.testing.assert_array_equal(
        se.exec_times(A, episode=2),
        [sim.run(A[k], seed=2 * 5 + k).makespan for k in range(5)])
    assert isinstance(as_engine(lambda a: 1.0), CallableEngine)
    with pytest.raises(TypeError):
        as_engine(3)


def _trainer():
    return training.DopplerTrainer(port_graph(make_diamond()),
                                   devices.uniform_box(4), d_hidden=16,
                                   device="cpu")


def test_evaluate_sim_path_unchanged():
    tr = _trainer()
    sim = WCSimulator(tr.g, tr.dev, noise_sigma=0.1)
    a = np.arange(tr.g.n) % 4
    mean, std, out_a = tr.evaluate(sim, n_runs=6, assignment=a)
    ts = sim.run_batch(a, seeds=[1000 + i for i in range(6)])[0]
    assert mean == float(np.mean(ts)) and std == float(np.std(ts))
    assert (out_a == a).all()


def test_evaluate_batched_engine_single_call():
    calls = []

    def batch_fn(A):
        calls.append(np.asarray(A).shape)
        return np.full(np.asarray(A).shape[0], 2.5)

    tr = _trainer()
    a = np.zeros(tr.g.n, int)
    mean, std, _ = tr.evaluate(CallableEngine(batch_fn, batched=True),
                               n_runs=7, assignment=a)
    assert calls == [(7, tr.g.n)]             # one shot, not 7 calls
    assert mean == 2.5 and std == 0.0


def test_evaluate_deterministic_engines_dedup():
    calls = []

    def det_fn(a):
        calls.append(1)
        return 3.0

    tr = _trainer()
    a = np.zeros(tr.g.n, int)
    mean, std, _ = tr.evaluate(CallableEngine(det_fn, deterministic=True),
                               n_runs=9, assignment=a)
    assert len(calls) == 1 and mean == 3.0 and std == 0.0
    # the default engine is the oracle on the trainer's device: one run
    mean, std, g = tr.evaluate()
    assert np.array_equal(g, tr.greedy_assignment())
    assert (mean, std) == (tr.default_engine().exec_time(g), 0.0)


def test_evaluate_plain_callable_still_loops():
    calls = []

    def fn(a):
        calls.append(1)
        return float(len(calls))

    tr = _trainer()
    mean, _, _ = tr.evaluate(fn, n_runs=4, assignment=np.zeros(tr.g.n, int))
    assert len(calls) == 4 and mean == 2.5
