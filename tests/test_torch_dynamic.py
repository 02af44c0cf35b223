"""Dynamic re-placement in the port (``DopplerTrainer.replace``, the fleet
events of ``core/devices.py``, ``hierarchy.project_assignment``) against
the JAX reference:

* ``replace()`` on flat and hierarchical trainers with the reference's
  parameters, for device loss, straggler onset and link degradation, at
  ``budget_s=1e9`` (no deadline cuts a round), ``commit`` False and True,
  the copied numpy ``WCSimulator`` of the flat graph on both sides: the
  same assignment, makespans (re-placed, before, CP), source, refinement
  rounds and moves and candidate count;
* after a commit, the next Stage II update equals the reference's on its
  draws (``tests/test_torch_stage2.py``'s bars); with ``commit=False``
  the trainer, its generator and its fused engines are untouched;
* the reference's own behaviour tests (``tests/test_dynamic.py`` up to
  the supervisor, which is not ported yet) on the port, with the port's
  default engine: the flat graph's oracle, cached per fleet.
"""
import numpy as np
import pytest
import torch

from conftest import random_dag
from repro.core import training as jax_training
from repro.core.devices import FleetEvent as JaxFleetEvent
from repro.core.devices import get_device_model as jax_fleet
from repro.core.engine import SimRewardEngine as JaxSimRewardEngine
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro.core.zero_shot import to_numpy_params
from repro_torch.core import training
from repro_torch.core.devices import (FleetEvent, get_device_model,
                                      parse_event, straggler_box, uniform_box)
from repro_torch.core.hierarchy import HierarchyConfig, project_assignment
from repro_torch.core.nn import tree_leaves
from repro_torch.core.sim_torch import TorchWCEngine
from repro_torch.core.simulator import WCSimulator
from repro_torch.models.convert import params_from_numpy
from test_torch_hierarchy import HCFG, jax_config
from test_torch_stage2 import EPS02, step_pair
from test_torch_train import assert_params_close, port_graph

EVENTS = {"loss": ("device_loss", dict(device=1)),
          "straggler": ("straggler_onset", dict(device=2, factor=0.4)),
          "link": ("link_degradation", dict(device=0, factor=0.25))}
FIELDS = ("makespan", "makespan_before", "cp_makespan", "source",
          "refine_rounds", "refine_moves", "n_candidates",
          "fleet_fingerprint", "budget_s")


def replace_pair(kind: str, fleet: str = "mixed_gen4"):
    """(reference trainer, port trainer on the CPU) with the same params,
    flat on a random DAG or hierarchical (HCFG) on another one."""
    rng = np.random.default_rng(2)
    gj = random_dag(rng, 32) if kind == "flat" else \
        random_dag(rng, 90, p_edge=0.08)
    hier = None if kind == "flat" else HCFG
    kw = dict(d_hidden=16, **EPS02)
    jt = jax_training.DopplerTrainer(
        gj, jax_fleet(fleet), seed=0,
        hierarchy=None if hier is None else jax_config(hier), **kw)
    pt = training.DopplerTrainer(port_graph(gj), get_device_model(fleet),
                                 seed=0, device="cpu", hierarchy=hier, **kw)
    pt.params = params_from_numpy(to_numpy_params(jt.params))
    return jt, pt


def same_result(got, want):
    for key in FIELDS:
        assert getattr(got, key) == getattr(want, key), key
    assert np.array_equal(got.assignment, want.assignment)
    assert got.within_budget and want.within_budget


def trainer_state(pt):
    return ([x.clone() for x in tree_leaves(pt.params)], pt.dev, pt.gd,
            None if pt.best_assignment is None else pt.best_assignment.copy(),
            pt.best_time, pt.episode, (pt._r_sum, pt._r_sqsum, pt._r_count),
            pt.generator.get_state(), pt._fused_cache,
            None if pt.hier is None else (pt.hier.devices,
                                          pt.hier.refine_state))


def assert_untouched(pt, before):
    now = trainer_state(pt)
    assert all(torch.equal(a, b) for a, b in zip(now[0], before[0]))
    assert now[1] is before[1] and now[2] is before[2]
    assert (now[3] is None) == (before[3] is None)
    if now[3] is not None:
        assert np.array_equal(now[3], before[3])
    assert now[4:7] == before[4:7]
    assert torch.equal(now[7], before[7])
    assert now[8] is before[8]
    if now[9] is not None:
        assert now[9][0] is before[9][0] and now[9][1] is before[9][1]


@pytest.mark.parametrize("kind", ["flat", "hier"])
@pytest.mark.parametrize("event", sorted(EVENTS))
def test_replace_matches_reference(kind, event):
    """Without and with a best-so-far, ``commit=False`` twice (the second
    through the CP cache), then ``commit=True`` and the next Stage II
    update on the new fleet."""
    jt, pt = replace_pair(kind)
    ev_kind, kw = EVENTS[event]
    ev, jev = FleetEvent(ev_kind, **kw), JaxFleetEvent(ev_kind, **kw)
    new_p, _ = ev.apply(pt.dev)
    new_j, _ = jev.apply(jt.dev)
    eng = WCSimulator(pt.flat_graph, new_p, noise_sigma=0.0)
    jeng = JaxWCSimulator(jt.flat_graph, new_j, noise_sigma=0.0)
    for with_best in (False, True):
        if with_best:
            best = np.random.default_rng(5).integers(0, 4, size=pt.g.n)
            pt.best_assignment, jt.best_assignment = best, best.copy()
            pt.best_time = jt.best_time = 1.0
        before = trainer_state(pt)
        got = pt.replace(ev, budget_s=1e9, engine=eng, commit=False)
        want = jt.replace(jev, budget_s=1e9, engine=jeng, commit=False)
        same_result(got, want)
        assert got.event is ev and got.assignment.shape == (pt.flat_graph.n,)
        assert_untouched(pt, before)
    assert len(pt._cp_cache) == 2          # seeds 0 and 1, then reused
    got = pt.replace(ev, budget_s=1e9, engine=eng, commit=True)
    want = jt.replace(jev, budget_s=1e9, engine=jeng, commit=True)
    same_result(got, want)
    assert pt.dev.fingerprint() == jt.dev.fingerprint() == \
        got.fleet_fingerprint
    assert np.array_equal(pt.best_assignment, jt.best_assignment)
    assert pt.best_time == jt.best_time
    assert (pt._r_sum, pt._r_sqsum, pt._r_count) == (0.0, 0.0, 0)
    assert pt._fused_cache == {}
    assert pt.gd.nd == new_p.n
    if kind == "hier":
        assert len(pt.best_assignment) == pt.g.n
        assert pt.hier.n_devices == new_p.n
        rs, jrs = pt.hier.refine_state, jt.hier.refine_state
        assert np.array_equal(rs.assignment, jrs.assignment)
        assert (rs.exec_time, rs.rounds_done, rs.moves_applied) == (
            jrs.exec_time, jrs.rounds_done, jrs.moves_applied)
    jsim = JaxWCSimulator(jt.g, jt.dev, noise_sigma=0.05)
    sim = WCSimulator(pt.g, pt.dev, noise_sigma=0.05)
    step_pair(jt, pt, lambda: jt.stage2_sim_batched(1, sim=jsim, batch_size=4),
              lambda d: pt.stage2_sim_batched(1, sim=sim, batch_size=4,
                                              draws=d),
              K=4, reward=JaxSimRewardEngine(jsim))
    assert_params_close(pt, jt)


def test_commit_drops_the_fused_engines_and_resumes_them():
    """A device loss commits a fleet of another size (nd 4 -> 3): the
    fused engines of the old fleet go, and the next fused Stage II update
    equals a fresh trainer's built on the new fleet from the same state."""
    _, pt = replace_pair("hier")
    pt.stage2_fused(2, batch_size=4)
    assert pt._fused_cache
    res = pt.replace(FleetEvent.device_loss(3), budget_s=1e9)
    assert pt._fused_cache == {} and pt.gd.nd == 3
    fresh = training.DopplerTrainer(pt.flat_graph, pt.dev, seed=9,
                                    d_hidden=16, device="cpu",
                                    hierarchy=HCFG, **EPS02)
    fresh.params, fresh.opt_state = pt.params, pt.opt_state
    fresh.episode = pt.episode
    fresh.best_assignment, fresh.best_time = (pt.best_assignment,
                                              pt.best_time)
    fresh.generator.set_state(pt.generator.get_state())
    want = fresh.stage2_fused(2, batch_size=4)
    assert pt.stage2_fused(2, batch_size=4) == want
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((pt.params, pt.opt_state.mu, pt.opt_state.nu)),
        tree_leaves((fresh.params, fresh.opt_state.mu, fresh.opt_state.nu))))
    assert res.assignment.max() < 3


# ------------------------------------------------------------ FleetEvent
def test_device_loss_survivor_map_and_fingerprint():
    dev = straggler_box(4)
    new, smap = FleetEvent.device_loss(2).apply(dev)
    assert new.n == 3
    np.testing.assert_array_equal(smap, [0, 1, -1, 2])
    np.testing.assert_allclose(new.flops_per_sec,
                               dev.flops_per_sec[[0, 1, 3]])
    assert new.link_bw.shape == (3, 3)
    assert new.fingerprint() != dev.fingerprint()


def test_straggler_onset_recovery_roundtrip():
    dev = uniform_box(4)
    d1, smap = FleetEvent.straggler_onset(1, 0.5).apply(dev)
    np.testing.assert_array_equal(smap, np.arange(4))
    assert d1.flops_per_sec[1] == pytest.approx(dev.flops_per_sec[1] * 0.5)
    assert d1.fingerprint() != dev.fingerprint()
    d2, _ = FleetEvent.straggler_recovery(1, 0.5).apply(d1)
    np.testing.assert_allclose(d2.flops_per_sec, dev.flops_per_sec)
    assert d2.fingerprint() == dev.fingerprint()


def test_link_degradation_all_and_single():
    dev = uniform_box(4)
    d_all, _ = FleetEvent.link_degradation(0, factor=0.25).apply(dev)
    off = np.arange(4) != 0
    np.testing.assert_allclose(d_all.link_bw[0, off],
                               dev.link_bw[0, off] * 0.25)
    np.testing.assert_allclose(d_all.link_bw[off, 0],
                               dev.link_bw[off, 0] * 0.25)
    assert np.isinf(d_all.link_bw[0, 0])
    d_one, _ = FleetEvent.link_degradation(1, dst=2, factor=0.5).apply(dev)
    assert d_one.link_bw[1, 2] == pytest.approx(dev.link_bw[1, 2] * 0.5)
    assert d_one.link_bw[2, 1] == pytest.approx(dev.link_bw[2, 1])


def test_event_validation_and_parse():
    with pytest.raises(ValueError):
        FleetEvent("meteor_strike")
    with pytest.raises(ValueError):
        FleetEvent.device_loss(7).apply(uniform_box(4))
    ev = parse_event("loss:2")
    assert ev.kind == "device_loss" and ev.device == 2
    ev = parse_event("straggler:1:0.4")
    assert ev.kind == "straggler_onset" and ev.factor == 0.4
    ev = parse_event("link:0:0.25:3")
    assert ev.kind == "link_degradation" and ev.dst == 3
    with pytest.raises(ValueError):
        parse_event("loss")


def test_straggler_box_capacity_through_constructor():
    dev = straggler_box(4, mem_bytes=16e9)
    np.testing.assert_allclose(dev.mem_bytes, np.full(4, 16e9))
    assert (straggler_box(4, mem_bytes=8e9).fingerprint()
            != dev.fingerprint())
    assert straggler_box(4).fingerprint() == dev.fingerprint()


# ------------------------------------------------------------- projection
def test_projection_no_vertex_on_dead_device():
    rng = np.random.default_rng(3)
    g = port_graph(random_dag(rng, 40))
    a = rng.integers(0, 4, g.n)
    new, smap = FleetEvent.device_loss(1).apply(uniform_box(4))
    out = project_assignment(g, new, a, smap)
    assert out.min() >= 0 and out.max() < 3
    kept = a != 1
    np.testing.assert_array_equal(out[kept], smap[a[kept]])


def test_projection_identity_without_loss():
    rng = np.random.default_rng(4)
    g = port_graph(random_dag(rng, 20))
    a = rng.integers(0, 4, g.n)
    np.testing.assert_array_equal(
        project_assignment(g, uniform_box(4), a, np.arange(4)), a)


def test_projection_rejects_out_of_range_assignment():
    g = port_graph(random_dag(np.random.default_rng(5), 10))
    with pytest.raises(ValueError):
        project_assignment(g, uniform_box(3), np.full(g.n, 5), np.arange(3))


# ------------------------------------------------------------- replace()
@pytest.fixture(scope="module")
def trained_flat():
    g = port_graph(random_dag(np.random.default_rng(0), 32))
    tr = training.DopplerTrainer(g, uniform_box(4), seed=0, device="cpu")
    tr.stage2_sim_batched(3, batch_size=4)
    return tr


def test_replace_beats_cp_and_respects_loss(trained_flat):
    tr = trained_flat
    res = tr.replace(FleetEvent.device_loss(3), budget_s=10.0, commit=False)
    assert res.assignment.max() < 3
    assert res.makespan <= res.cp_makespan + 1e-9
    assert res.makespan <= res.makespan_before + 1e-9
    assert res.within_budget and res.n_candidates >= 3
    assert tr.dev.n == 4
    # the default engine: the flat oracle of the new fleet, cached
    new, _ = FleetEvent.device_loss(3).apply(tr.dev)
    eng = tr._twin_cache[new.fingerprint()]
    assert isinstance(eng, TorchWCEngine) and eng.devices is not tr.dev
    assert res.makespan == float(eng.exec_times(res.assignment[None])[0])


def test_replace_budget_contract(trained_flat):
    # a tiny budget still returns a valid placement (the structural CP
    # seed and one batched score always run; refinement rounds are what
    # the deadline cuts) and still meets the <= CP gate
    res = trained_flat.replace(FleetEvent.device_loss(0), budget_s=1e-6,
                               commit=False)
    assert res.makespan <= res.cp_makespan + 1e-9
    assert len(res.assignment) == trained_flat.flat_graph.n
    assert res.refine_rounds == 0
    assert not res.within_budget


def test_replace_commit_swaps_fleet_and_training_resumes():
    g = port_graph(random_dag(np.random.default_rng(1), 28))
    tr = training.DopplerTrainer(g, uniform_box(4), seed=0, device="cpu")
    tr.stage2_sim_batched(2, batch_size=4)
    res = tr.replace(FleetEvent.straggler_onset(2, 0.4), budget_s=10.0)
    assert tr.dev.fingerprint() == res.fleet_fingerprint
    assert tr._r_count == 0
    np.testing.assert_array_equal(tr.best_assignment, res.assignment)
    tr.stage2_sim_batched(2, batch_size=4)
    assert tr.episode == 2 * 4 + 2 * 4


def test_replace_hierarchical_expands_and_commits():
    g = port_graph(random_dag(np.random.default_rng(2), 90, p_edge=0.08))
    tr = training.DopplerTrainer(g, uniform_box(4), seed=0, device="cpu",
                                 hierarchy=HierarchyConfig(n_segments=12))
    tr.stage2_sim_batched(2, batch_size=4)
    res = tr.replace(FleetEvent.device_loss(1), budget_s=10.0)
    assert len(res.assignment) == g.n and res.assignment.max() < 3
    assert res.makespan <= res.cp_makespan + 1e-9
    assert len(tr.best_assignment) == tr.g.n
    assert tr.hier.n_devices == 3
    tr.stage2_sim_batched(1, batch_size=4)
    pl = tr.place()
    assert pl.assignment.max() < 3 and np.isfinite(pl.makespan)


def test_replace_rejects_resized_plain_model(trained_flat):
    with pytest.raises(ValueError):
        trained_flat.replace(uniform_box(3), commit=False)
    with pytest.raises(TypeError):
        trained_flat.replace("loss:1", commit=False)


def test_replace_same_size_model_and_greedy_keeps_generator(trained_flat):
    """A same-size :class:`DeviceModel` replaces the fleet with the
    identity survivor map; ``_greedy_on`` draws nothing."""
    tr = trained_flat
    state = tr.generator.get_state()
    slow = tr.dev.replace(flops_per_sec=tr.dev.flops_per_sec * 0.5)
    res = tr.replace(slow, budget_s=10.0, commit=False)
    assert res.event is None and res.makespan <= res.cp_makespan + 1e-9
    assert np.array_equal(tr._greedy_on(tr.gd), tr.greedy_assignment())
    assert torch.equal(tr.generator.get_state(), state)
