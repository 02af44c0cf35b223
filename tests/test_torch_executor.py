"""The port's work-conserving executor (``repro_torch.core.executor``) and
its reward engine against the JAX reference, on the CPU.

* Plans: over {diamond, ffnn, llama_block, llama_layer} x {p100x4,
  v100x8, mixed_gen4} at the reference tests' scales, ``compile_plan``
  equals ``repro.core.executor.WCExecutor.compile_plan`` on ``A``, every
  step's ``(v, d, xfers, pred_keys)`` and ``(s, out_len)``,
  ``n_transfers`` and ``exit_keys``; the cache returns the same plan and
  all on one device needs no transfer.
* Values: every result of one run of the port equals the reference's
  payload replayed through the reference plan's own ``fn(seed, base)``
  within 1e-6 relative, and every step's seed is the reference's.
* Batches: ``execute_batch``'s (K, repeats) shape, shared plans measured
  apart, and the order of ``_run_plan`` calls (one warm-up on the first
  batch and none after, interleaved or not) as the reference's.
* The dispatch loop reads nothing back to the host.
* ``ExecutorRewardEngine``: flags, reducers, ``evaluate_repeats`` and
  ``as_engine``'s routing (the analogues of ``tests/test_engine.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_diamond
from repro.core import executor as jax_executor
from repro.core.devices import get_device_model as jax_fleet
from repro.core.heuristics import critical_path_assignment
from repro.graphs import workloads as jax_workloads
from repro_torch.core import executor
from repro_torch.core.devices import get_device_model
from repro_torch.core.engine import (CallableEngine, ExecutorRewardEngine,
                                     RewardEngine, SimRewardEngine,
                                     as_engine)
from repro_torch.core.sim_batch import CompiledGraph, compile_assignment
from repro_torch.core.simulator import WCSimulator
from test_torch_fused_steps import _HostReads
from test_torch_train import port_graph

SCALES = dict(flops_scale=1e-6, bytes_scale=1e-4)
GRAPHS = ["diamond", "ffnn", "llama_block", "llama_layer"]
FLEETS = ["p100x4", "v100x8", "mixed_gen4"]


def reference_graph(gname):
    return make_diamond() if gname == "diamond" else \
        jax_workloads.get_workload(gname)


def executor_pair(gname, nd):
    """(reference executor, port executor on the CPU) over one graph, both
    with ``nd`` logical devices."""
    gj = reference_graph(gname)
    ref = jax_executor.WCExecutor(gj, n_virtual=nd, **SCALES)
    port = executor.WCExecutor(port_graph(gj), devices=["cpu"],
                               n_virtual=nd, **SCALES)
    return ref, port


def assignments(gj, fleet_name, nd):
    """CRITICAL PATH, round robin over the topological order, all on the
    last device, and two random draws."""
    rng = np.random.default_rng(len(gj.vertices) + nd)
    rr = np.zeros(gj.n, np.int64)
    rr[np.asarray(gj.topo_order)] = np.arange(gj.n) % nd
    return [critical_path_assignment(gj, jax_fleet(fleet_name), seed=0), rr,
            np.full(gj.n, nd - 1), *rng.integers(0, nd, size=(2, gj.n))]


@pytest.mark.parametrize("fleet", FLEETS)
@pytest.mark.parametrize("gname", GRAPHS)
def test_plans_match_reference(gname, fleet):
    nd = get_device_model(fleet).n
    ref, port = executor_pair(gname, nd)
    for a in assignments(ref.g, fleet, nd):
        pr, pp = ref.compile_plan(a), port.compile_plan(a)
        assert np.array_equal(pp.A, pr.A)
        assert [s[:4] for s in pp.steps] == [s[:4] for s in pr.steps]
        assert [(s[5].shape[0], s[4]) for s in pp.steps] == \
            [(s[5].shape[0], ref._vertex_dims(s[0])[1]) for s in pr.steps]
        assert pp.n_transfers == pr.n_transfers
        assert pp.exit_keys == pr.exit_keys
        assert port.compile_plan(np.array(a)) is pp           # cached
    assert port.compile_plan(np.zeros(ref.g.n, int)).n_transfers == 0


def test_transfer_set_is_the_compiled_simulators():
    """The port's transfer set, as the reference's test holds it: the
    count of ``sim_batch.compile_assignment``'s transfers."""
    g = port_graph(make_diamond())
    ex = executor.WCExecutor(g, devices=["cpu"], n_virtual=4, **SCALES)
    a = np.arange(g.n) % 4
    plan = ex.compile_plan(a)
    cg = CompiledGraph.build(g, get_device_model("p100x4"))
    assert plan.n_transfers == len(compile_assignment(cg, a).xfer_src)
    assert plan.n_transfers == sum(len(s[2]) for s in plan.steps)


def test_plan_cache_is_bounded():
    g = port_graph(make_diamond())
    ex = executor.WCExecutor(g, devices=["cpu"], n_virtual=4, **SCALES)
    rng = np.random.default_rng(0)
    for a in rng.integers(0, 4, size=(executor.PLAN_CACHE_SIZE + 1, g.n)):
        ex.compile_plan(a)
    assert 1 <= len(ex._plan_cache) <= executor.PLAN_CACHE_SIZE


@pytest.mark.parametrize("gname,fleet", [("diamond", "p100x4"),
                                         ("llama_block", "mixed_gen4"),
                                         ("llama_layer", "v100x8")])
def test_values_match_the_reference_payload(monkeypatch, gname, fleet):
    """One CPU run of the port; the reference's payload replayed on the
    reference plan: same keys, every value within 1e-6 relative, and each
    step's seed (the sum over its predecessors, which the payload's
    float32 rounding then hides) bit-equal to the reference's."""
    nd = get_device_model(fleet).n
    ref, port = executor_pair(gname, nd)
    a = assignments(ref.g, fleet, nd)[0]
    port.compile_plan(a)                    # its warm-up calls, unrecorded
    seeds = []
    payload = executor._payload

    def recorded(seed, base, out_len):
        seeds.append(float(seed))
        return payload(seed, base, out_len)
    monkeypatch.setattr(executor, "_payload", recorded)
    got = port.trace_run(a)["results"]
    plan = ref.compile_plan(a)
    want = {k: np.asarray(x) for k, x in ref._inputs().items()}
    want_seeds = []
    for v, d, xfers, pred_keys, fn, base in plan.steps:
        for p, src in xfers:
            want[(p, d)] = want[(p, src)]
        seed = jnp.float32(0.0)
        for pk in pred_keys:
            seed = seed + want[pk][0]
        want_seeds.append(float(seed))
        want[(v, d)] = np.asarray(fn(seed, base))
    assert seeds == want_seeds and any(seeds)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    assert len({float(w[0]) for w in want.values()}) > 1


def _record_runs(monkeypatch, module, ex):
    """Patch ``module.WCExecutor._run_plan`` to log which row's plan runs
    (by its assignment) and return a constant."""
    log = []
    orig = module.WCExecutor._run_plan

    def run(self, plan, *args):
        log.append(plan.A.tobytes())
        return orig(self, plan, *args)
    monkeypatch.setattr(module.WCExecutor, "_run_plan", run)
    return log


@pytest.mark.parametrize("interleave", [True, False])
def test_run_order_matches_reference(monkeypatch, interleave):
    ref, port = executor_pair("diamond", 4)
    n = ref.g.n
    A = np.stack([np.zeros(n, int), np.arange(n) % 4, np.zeros(n, int),
                  np.full(n, 3)])
    orders = []
    for module, ex in ((jax_executor, ref), (executor, port)):
        log = _record_runs(monkeypatch, module, ex)
        first = ex.execute_batch(A, repeats=2, interleave=interleave)
        n_first = len(log)
        second = ex.execute_batch(A[1:], repeats=3, interleave=interleave)
        rows = {a.tobytes(): i for i, a in enumerate(A[:2])}
        rows[A[3].tobytes()] = 3
        orders.append(([rows[x] for x in log], n_first))
        assert first.shape == (4, 2) and second.shape == (3, 3)
        assert (first > 0).all() and (second > 0).all()
    assert orders[0] == orders[1]
    (order, n_first) = orders[1]
    assert n_first == 1 + 4 * 2                 # one warm-up, then 8 runs
    assert order[0] == 0                        # the warm-up: row 0's plan
    want = [0, 1, 0, 3] * 2 if interleave else [0, 0, 1, 1, 0, 0, 3, 3]
    assert order[1:n_first] == want


def test_execute_batch_shape_and_dedup():
    g = port_graph(make_diamond())
    ex = executor.WCExecutor(g, devices=["cpu"], n_virtual=4, **SCALES)
    A = np.stack([np.zeros(g.n, int), np.arange(g.n) % 4,
                  np.zeros(g.n, int)])
    out = ex.execute_batch(A, repeats=2)
    assert out.shape == (3, 2) and (out > 0).all()
    assert len(ex._plan_cache) == 2                   # rows 0/2 share a plan
    assert (out[0] != out[2]).any()   # ...but are measured independently
    assert ex.exec_time(A[1], n_warmup=0, n_runs=2) > 0
    assert ex.execute(A[1]) > 0 and ex.last_dispatch_s > 0
    assert ex.execute(A[1], measure=False) == 0.0
    assert ex.execute_batch(A[1]).shape == (1, 1)


def test_the_dispatch_loop_reads_nothing_back_to_the_host():
    g = port_graph(jax_workloads.get_workload("llama_block"))
    ex = executor.WCExecutor(g, devices=["cpu"], n_virtual=4, **SCALES)
    a = np.arange(g.n) % 4
    plan = ex.compile_plan(a)
    ex._run_plan(plan)
    with _HostReads() as mode:
        ex._run_plan(plan)
    assert mode.found == {}, mode.found
    assert plan.n_transfers > 0


def test_devices_and_streams():
    g = port_graph(make_diamond())
    ex = executor.WCExecutor(g, devices=["cpu"], n_virtual=3)
    assert ex.nd == 3 and ex.streams is None and not ex.cuda
    assert ex.devices == [ex.devices[0]] * 3
    with pytest.raises(ValueError):
        ex.compile_plan(np.full(g.n, 3))
    if not executor.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            executor.WCExecutor(g)                  # the default is the card


# ------------------------------------------------------- reward engine
class _FixedExecutor:
    """An executor stand-in whose runs take fixed seconds per row."""

    def __init__(self, times):
        self.times = np.asarray(times, float)
        self.calls = []

    def execute_batch(self, A, repeats=1):
        self.calls.append((np.asarray(A).shape, repeats))
        return self.times[:len(A), :repeats]


def test_executor_reward_engine():
    g = port_graph(make_diamond())
    ex = executor.WCExecutor(g, devices=["cpu"], n_virtual=4, **SCALES)
    eng = ExecutorRewardEngine(ex, repeats=2)
    A = np.stack([np.zeros(g.n, int), np.arange(g.n) % 4])
    ts = eng.exec_times(A)
    assert ts.shape == (2,) and (ts > 0).all()
    reps = eng.evaluate_repeats(A[0], 3)
    assert reps.shape == (3,) and (reps > 0).all()
    assert eng.batched and eng.measured and not eng.deterministic
    assert eng.name == "executor"
    with pytest.raises(ValueError):
        ExecutorRewardEngine(ex, reduce="max")


@pytest.mark.parametrize("reduce,want", [("median", [2.0, 5.0]),
                                         ("mean", [8.0 / 3, 5.0]),
                                         ("min", [1.0, 4.0])])
def test_executor_reward_engine_reducers(reduce, want):
    fake = _FixedExecutor([[1.0, 2.0, 5.0], [6.0, 4.0, 5.0]])
    eng = ExecutorRewardEngine(fake, repeats=3, reduce=reduce)
    np.testing.assert_allclose(eng.exec_times(np.zeros((2, 5), int)), want)
    assert eng.exec_time(np.zeros(5, int)) == pytest.approx(want[0])
    assert fake.calls == [((2, 5), 3), ((1, 5), 3)]
    np.testing.assert_array_equal(eng.evaluate_repeats(np.zeros(5, int), 2),
                                  [1.0, 2.0])
    assert fake.calls[-1] == ((1, 5), 2)


def test_measured_flag_and_as_engine_routing():
    g = port_graph(make_diamond())
    ex = executor.WCExecutor(g, devices=["cpu"], n_virtual=4, **SCALES)
    eng = as_engine(ex, repeats=3, reduce="min")
    assert isinstance(eng, ExecutorRewardEngine)
    assert (eng.executor, eng.repeats, eng.reduce) == (ex, 3, "min")
    assert as_engine(eng) is eng
    sim = WCSimulator(g, get_device_model("p100x4"))
    assert isinstance(as_engine(sim), SimRewardEngine)
    assert isinstance(as_engine(lambda a: 1.0), CallableEngine)
    assert not RewardEngine.measured
    assert not any(e.measured for e in (as_engine(sim),
                                        as_engine(lambda a: 1.0)))
    with pytest.raises(TypeError):
        as_engine(3)
