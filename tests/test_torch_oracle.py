"""Port WC oracle (``repro_torch.core.sim_torch``) vs the JAX oracle and
the serial engine.

* ``makespan_fifo_batch(backend="torch")`` makes the same decisions in
  the same float32 arithmetic as ``repro.core.sim_jax.makespan_fifo_batch``
  (backend="xla"): makespans and ok flags are equal.
* Against ``WCSimulator.run(choose="fifo", noise_sigma=0)`` (float64)
  the makespans are within rtol 1e-4 over the synthetic suite x fleets.
* A corrupted indegree surfaces as ok=False (engine raises), and graphs
  whose queue keys would leave f32's exact range refuse to build.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sim_jax
from repro.core.devices import get_device_model as jax_fleet
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.simulator import WCSimulator
from repro.graphs import workloads as jax_workloads
from repro_torch.core.devices import get_device_model, uniform_box
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.heuristics import (critical_path_assignment,
                                         round_robin_assignment)
from repro_torch.core.sim_torch import (SimGraph, TorchWCEngine,
                                        makespan_fifo_batch)
from repro_torch.graphs import workloads

SUITE = [("synthetic_layered", (3, 4)), ("synthetic_layered", (16, 8)),
         ("chainmm", ()), ("ffnn", ()), ("llama_layer", ())]
FLEETS = ["p100x4", "mixed_gen4", "two_pod_2x2"]
# (fleet, graph) pairs where the float32 JAX oracle itself leaves the
# float64 serial engine by more than 1e-4 on the assignments below
F32_GAP = {("mixed_gen4", "ffnn"), ("mixed_gen4", "llama_layer")}


def _graphs(gname, args):
    return (getattr(workloads, gname)(*args),
            getattr(jax_workloads, gname)(*args))


@pytest.mark.parametrize("gname,args,fleet", [
    ("synthetic_layered", (3, 4), "p100x4"),
    ("chainmm", (), "mixed_gen4"),
    ("ffnn", (), "two_pod_2x2"),
    ("synthetic_layered", (16, 8), "v100x8"),
])
def test_makespans_equal_jax_oracle(gname, args, fleet):
    g, gj = _graphs(gname, args)
    rng = np.random.default_rng(1)
    A = rng.integers(0, get_device_model(fleet).n, (5, g.n))
    ms_j, ok_j = sim_jax.makespan_fifo_batch(
        sim_jax.SimGraph.build(gj, jax_fleet(fleet)), jnp.asarray(A))
    sg = SimGraph.build(g, get_device_model(fleet))
    for backend in ("torch", "cuda"):          # "cuda" on CPU tensors: plain
        ms, ok = makespan_fifo_batch(sg, torch.as_tensor(A), backend=backend)
        assert ms.dtype == torch.float32
        assert np.array_equal(ms.numpy(), np.asarray(ms_j))
        assert np.array_equal(ok.numpy(), np.asarray(ok_j)) and ok.all()


def _serial_cases(fleet):
    """(port graph, reference graph, serial makespans, assignments) over
    the suite: three CRITICAL-PATH runs and a round-robin per graph."""
    for gname, args in SUITE:
        g, gj = _graphs(gname, args)
        dev, devj = get_device_model(fleet), jax_fleet(fleet)
        A = np.stack([critical_path_assignment(g, dev, seed=s)
                      for s in range(3)] + [round_robin_assignment(g, dev.n)])
        sim = WCSimulator(gj, devj, choose="fifo", noise_sigma=0.0)
        yield gname, g, gj, A, np.array([sim.run(a).makespan for a in A])


@pytest.mark.parametrize("fleet", FLEETS)
def test_suite_matches_serial_engine(fleet):
    """rtol 1e-4 against the float64 serial engine wherever the JAX oracle
    meets it.  On mixed_gen4, ffnn and llama_layer the float32 oracle's
    schedule leaves the serial engine's (up to 6.5% on these
    assignments): the port reproduces the JAX oracle there bit for bit,
    so the gap is the reference's (ROADMAP queue C)."""
    for gname, g, gj, A, ref in _serial_cases(fleet):
        eng = TorchWCEngine(g, get_device_model(fleet), backend="torch",
                            device="cpu")
        got = eng.run_batch(A)
        if (fleet, gname) in F32_GAP:
            ms_j, _ = sim_jax.makespan_fifo_batch(
                sim_jax.SimGraph.build(gj, jax_fleet(fleet)), jnp.asarray(A))
            assert np.array_equal(got, np.asarray(ms_j))
            assert (np.abs(got - ref) / ref).max() > 1e-4
            continue
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        assert eng.exec_time(A[0]) == pytest.approx(ref[0], rel=1e-4)
        assert np.array_equal(eng.exec_times(A, episode=3), got)


def test_single_device_fleet_and_batch_consistency():
    """One device: no channels (R = 2); batch == one-by-one."""
    g = workloads.synthetic_layered(3, 4)
    gj = jax_workloads.synthetic_layered(3, 4)
    sim = WCSimulator(gj, jax_uniform_box(1), choose="fifo", noise_sigma=0.0)
    eng = TorchWCEngine(g, uniform_box(1), device="cpu")
    a = np.zeros(g.n, np.int64)
    assert eng.exec_time(a) == pytest.approx(sim.run(a).makespan, rel=1e-4)
    A = np.random.default_rng(0).integers(0, 4, (4, g.n))
    eng4 = TorchWCEngine(g, uniform_box(4), device="cpu")
    assert np.array_equal(eng4.run_batch(A),
                          [eng4.exec_time(a) for a in A])


def test_deadlock_flag():
    """A corrupted indegree surfaces as ok=False (and the engine raises)
    instead of hanging: the trip loop is bounded."""
    g = workloads.synthetic_layered(2, 2)
    eng = TorchWCEngine(g, uniform_box(2), device="cpu")
    need0 = eng.sim_graph.need0.clone()
    v = int(torch.nonzero(need0 > 0)[0])
    need0[v] = 99                              # v waits forever
    bad = dataclasses.replace(eng.sim_graph, need0=need0)
    ms, ok = makespan_fifo_batch(bad, torch.zeros(2, g.n, dtype=torch.long),
                                 backend="torch")
    assert not ok.any()
    eng.sim_graph = bad
    with pytest.raises(RuntimeError, match="deadlock"):
        eng.run_batch(np.zeros((1, g.n), np.int64))


def test_key_capacity_guard():
    """A producer with 3000 consumers needs 2*koff >= 2^24: both oracles
    refuse to build rather than lose f32 key exactness."""
    from repro.core.graph import DataflowGraph as JaxGraph
    for cls, fleet in ((DataflowGraph, uniform_box(2)),
                       (JaxGraph, jax_uniform_box(2))):
        g = cls("fanout")
        x = g.add_vertex("input", out_bytes=1e3)
        hub = g.add_vertex("matmul", flops=1e6, out_bytes=1e3)
        g.add_edge(x, hub)
        for _ in range(3000):
            g.add_edge(hub, g.add_vertex("matmul", flops=1e6, out_bytes=1e3))
        g.freeze()
        build = (SimGraph.build if cls is DataflowGraph
                 else sim_jax.SimGraph.build)
        with pytest.raises(ValueError, match="2\\^24"):
            build(g, fleet)
    small = SimGraph.build(workloads.chainmm(), uniform_box(2))
    assert 2 * small.koff < 2 ** 24


def test_unknown_backend_and_cuda_without_gpu(monkeypatch):
    g = workloads.chainmm()
    with pytest.raises(ValueError):
        TorchWCEngine(g, uniform_box(2), backend="xla", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchWCEngine(g, uniform_box(2), backend="cuda", device="cuda")
