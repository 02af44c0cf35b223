"""Hierarchical placement in the port (``graphs/partition.py``,
``core/hierarchy.py``) against the JAX reference on the same inputs
(the trainer's ``hierarchy=`` mode and its checkpoints:
``tests/test_torch_hier_trainer.py``):

* partitions (``coarsen``, ``coarsen_multilevel``, ``tile_graph``) equal
  entry by entry: every level's vertex -> segment map and the segment
  graph's flops, bytes, edges, kinds and labels;
* the refinement pieces equal: ``boundary_scores``, ``propose_moves``
  (candidates and moves), ``project_assignment`` for every event kind,
  ``refine_assignment`` and ``refine_levels`` (assignment, time, rounds,
  moves, V-cycle stats but seconds) with the copied numpy
  ``WCSimulator`` on both sides, ``ExpandingEngine``;
* the reference's own behaviour tests (``tests/test_hierarchy.py``, but
  the full-model import, which needs the port's graph importer).
"""
import dataclasses

import numpy as np
import pytest

from conftest import make_chain, make_diamond, random_dag
from repro.core import hierarchy as jax_hierarchy
from repro.core.devices import FleetEvent as JaxFleetEvent
from repro.core.devices import get_device_model as jax_fleet
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.graph import DataflowGraph as JaxDataflowGraph
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro.graphs import partition as jax_partition
from repro.graphs.workloads import synthetic_layered as jax_layered
from repro_torch.core import training
from repro_torch.core.devices import FleetEvent, get_device_model, uniform_box
from repro_torch.core.engine import SimRewardEngine
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.heuristics import critical_path_assignment
from repro_torch.core.hierarchy import (ExpandingEngine, HierarchicalPolicy,
                                        HierarchyConfig, boundary_scores,
                                        project_assignment, propose_moves,
                                        refine_assignment)
from repro_torch.core.simulator import WCSimulator
from repro_torch.graphs.partition import (MultilevelPartition, Partition,
                                          coarsen, coarsen_multilevel,
                                          tile_graph)
from repro_torch.graphs.workloads import synthetic_layered
from test_torch_train import port_graph

HCFG = HierarchyConfig(n_segments=12, refine_rounds=2, refine_top_k=6)
# small max_ratio forces a genuinely multi-level stack on medium graphs
MHCFG = HierarchyConfig(n_segments=12, refine_rounds=2, refine_top_k=6,
                        max_ratio=4.0)
EVENTS = [("device_loss", dict(device=1)),
          ("straggler_onset", dict(device=2, factor=0.4)),
          ("straggler_recovery", dict(device=0, factor=0.5)),
          ("link_degradation", dict(device=3, factor=0.25)),
          ("link_degradation", dict(device=0, dst=2, factor=0.5))]


def jax_config(cfg: HierarchyConfig):
    return jax_hierarchy.HierarchyConfig(**dataclasses.asdict(cfg))


def reference_graphs():
    """(name, reference graph, coarsening target, max_ratio): a chain, a
    diamond, a random DAG, a small layered graph (one level each) and a
    layered graph that max_ratio 4 makes multi-level."""
    return [("chain40", make_chain(40), 5, 16.0),
            ("diamond", make_diamond(8), 4, 16.0),
            ("random60", random_dag(np.random.default_rng(3), 60), 10, 16.0),
            ("layered24x6", jax_layered(24, 6), 12, 16.0),
            ("layered48x8", jax_layered(48, 8), 8, 4.0)]


GRAPHS = {name: (gj, t, r) for name, gj, t, r in reference_graphs()}


def same_graph(gp, gj):
    assert gp.n == gj.n and gp.name == gj.name
    assert np.array_equal(gp.edge_array(), gj.edge_array())
    assert np.array_equal(gp.flops_array(), gj.flops_array())
    assert np.array_equal(gp.out_bytes_array(), gj.out_bytes_array())
    assert [(v.kind, v.role, v.label, v.meta_op, v.out_shape)
            for v in gp.vertices] == [(v.kind, v.role, v.label, v.meta_op,
                                       v.out_shape) for v in gj.vertices]
    assert gp.topo_order == gj.topo_order
    assert gp.outputs == gj.outputs


def same_partition(pp, pj):
    assert np.array_equal(pp.vertex_segment, pj.vertex_segment)
    for key in ("seg_flops", "seg_bytes", "boundary_bytes", "cross_bytes"):
        assert np.array_equal(getattr(pp, key), getattr(pj, key)), key
    same_graph(pp.seg_graph, pj.seg_graph)


def same_multilevel(mp, mj):
    assert mp.n_levels == mj.n_levels
    for pp, pj in zip(mp.levels, mj.levels):
        same_partition(pp, pj)
    assert np.array_equal(mp.vertex_segment, mj.vertex_segment)
    strip = [[{k: v for k, v in st.items() if k != "seconds"}
              for st in stats] for stats in (mp.level_stats, mj.level_stats)]
    assert strip[0] == strip[1]


# ------------------------------------------------------- partition parity
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_coarsen_matches_reference(name):
    gj, target, _ = GRAPHS[name]
    gp = port_graph(gj)
    same_partition(coarsen(gp, target), jax_partition.coarsen(gj, target))
    same_partition(coarsen(gp, target, cap_factor=1.2),
                   jax_partition.coarsen(gj, target, cap_factor=1.2))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_coarsen_multilevel_matches_reference(name):
    gj, target, ratio = GRAPHS[name]
    mp = coarsen_multilevel(port_graph(gj), target, max_ratio=ratio)
    mj = jax_partition.coarsen_multilevel(gj, target, max_ratio=ratio)
    same_multilevel(mp, mj)
    if name == "layered48x8":
        assert mp.n_levels >= 2
    rng = np.random.default_rng(1)
    seg_a = rng.integers(0, 4, size=(3, mp.n_segments))
    for lvl in range(mp.n_levels):
        assert np.array_equal(mp.expand(seg_a, to_level=lvl),
                              mj.expand(seg_a, to_level=lvl))


def _unit(cls, n: int = 4, backward: bool = False):
    """A labeled chain unit in either package: x -> n matmuls (and, with
    ``backward``, a cotangent chain dy -> n matmuls reading the forward
    activations), with its outputs recorded."""
    g = cls("unit")
    prev = g.add_vertex("input", out_bytes=1e6, label="x")
    pos = g.add_vertex("input", out_bytes=1e3, label="positions")
    fwd = []
    for i in range(n):
        v = g.add_vertex("matmul", flops=1e9 * (1 + i % 3), out_bytes=1e6,
                         meta_op=i, label=f"mm{i}", out_shape=(8, 8))
        g.add_edge(prev, v)
        g.add_edge(pos, v)
        prev = v
        fwd.append(v)
    outputs = [prev]
    if backward:
        b = g.add_vertex("input", out_bytes=1e6, label="dy")
        for i in range(n):
            v = g.add_vertex("matmul", flops=2e9, out_bytes=1e6,
                             meta_op=n + i, label=f"bw{i}")
            g.add_edge(b, v)
            g.add_edge(fwd[n - 1 - i], v)
            b = v
        outputs.append(b)
    g.outputs = outputs
    return g.freeze()


@pytest.mark.parametrize("case", ["forward", "fwd_bwd", "nested"])
def test_tile_graph_matches_reference(case):
    back = case != "forward"
    chains = (("x", 0, 1), ("dy", 1, -1)) if back else (("x", 0, 1),)
    up, uj = _unit(DataflowGraph, backward=back), _unit(JaxDataflowGraph,
                                                        backward=back)
    tp = tile_graph(up, 3, chains=chains)
    tj = jax_partition.tile_graph(uj, 3, chains=chains)
    if case == "nested":
        tp = tile_graph(tp, 2, chains=(), shared_labels=())
        tj = jax_partition.tile_graph(tj, 2, chains=(), shared_labels=())
    same_graph(tp, tj)
    rp, rj = tp.replication, tj.replication
    assert rp.n_rep == rj.n_rep
    assert np.array_equal(rp.unit_vid, rj.unit_vid)
    assert np.array_equal(rp.rep_of, rj.rep_of)
    assert (rp.phase is None) == (rj.phase is None)
    if rp.phase is not None:
        assert np.array_equal(rp.phase, rj.phase)
    # the structural fast path of coarsen: labels tiled across reps
    same_partition(coarsen(tp, 6), jax_partition.coarsen(tj, 6))


# ---------------------------------------------------- refinement parity
@pytest.mark.parametrize("seed", range(4))
def test_boundary_scores_and_propose_moves_match_reference(seed):
    rng = np.random.default_rng(seed)
    gj = random_dag(rng, 50)
    gp = port_graph(gj)
    nd = 4
    a = rng.integers(0, nd, size=gj.n)
    assert np.array_equal(boundary_scores(gp, a),
                          jax_hierarchy.boundary_scores(gj, a))
    pol = HierarchicalPolicy(coarsen(gp, 10), HCFG, uniform_box(nd))
    jpol = jax_hierarchy.HierarchicalPolicy(
        jax_partition.coarsen(gj, 10), jax_config(HCFG), jax_uniform_box(nd))
    assert np.array_equal(pol.exec_cost, jpol.exec_cost)
    for cost in (pol.exec_cost, None):
        for top_k in (3, 8):
            cp, mp = propose_moves(gp, a, top_k, cost, nd)
            cj, mj = jax_hierarchy.propose_moves(gj, a, top_k, cost, nd)
            assert mp == mj
            assert np.array_equal(cp, cj)


@pytest.mark.parametrize("kind,kw", EVENTS,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(EVENTS)])
def test_project_assignment_matches_reference(kind, kw):
    rng = np.random.default_rng(7)
    gj = random_dag(rng, 40)
    gp = port_graph(gj)
    new_p, smap_p = FleetEvent(kind, **kw).apply(get_device_model("p100x4"))
    new_j, smap_j = JaxFleetEvent(kind, **kw).apply(jax_fleet("p100x4"))
    assert np.array_equal(smap_p, smap_j)
    assert new_p.fingerprint() == new_j.fingerprint()
    for trial in range(3):
        a = rng.integers(0, 4, size=gj.n)
        for dev_p, dev_j in ((new_p, new_j), (new_p.n, new_j.n)):
            assert np.array_equal(
                project_assignment(gp, dev_p, a, smap_p),
                jax_hierarchy.project_assignment(gj, dev_j, a, smap_j))


def _sim_pair(gj, fleet, sigma=0.0):
    gp = port_graph(gj)
    return (gp, WCSimulator(gp, get_device_model(fleet), noise_sigma=sigma),
            JaxWCSimulator(gj, jax_fleet(fleet), noise_sigma=sigma))


@pytest.mark.parametrize("fleet", ["p100x4", "mixed_gen4"])
def test_refine_assignment_matches_reference(fleet):
    """The numpy ``WCSimulator`` on both sides: the same refined
    assignment, time, rounds and moves, with the exec-cost table (balance
    moves) and without, from a CP and from a round-robin start."""
    gj = random_dag(np.random.default_rng(3), 60)
    gp, sim, jsim = _sim_pair(gj, fleet)
    pol = HierarchicalPolicy(coarsen(gp, 10), HCFG, get_device_model(fleet))
    nd = pol.n_devices
    for a0 in (critical_path_assignment(gp, get_device_model(fleet)),
               pol.expand(np.arange(pol.partition.n_segments) % nd)):
        for cost in (pol.exec_cost, None):
            got = refine_assignment(gp, cost, a0, sim, nd, episode=3,
                                    rounds=3, top_k=8)
            want = jax_hierarchy.refine_assignment(gj, cost, a0, jsim, nd,
                                                   episode=3, rounds=3,
                                                   top_k=8)
            assert np.array_equal(got[0], want[0])
            assert got[1:] == want[1:]


def test_refine_levels_matches_reference():
    gj, target, ratio = GRAPHS["layered48x8"]
    gp = port_graph(gj)
    cfg = dataclasses.replace(MHCFG, n_segments=target, max_ratio=ratio)
    pol = HierarchicalPolicy(coarsen_multilevel(gp, target, max_ratio=ratio),
                             cfg, get_device_model("mixed_gen4"))
    jpol = jax_hierarchy.HierarchicalPolicy(
        jax_partition.coarsen_multilevel(gj, target, max_ratio=ratio),
        jax_config(cfg), jax_fleet("mixed_gen4"))
    assert pol.n_levels >= 2
    rng = np.random.default_rng(2)
    for trial in range(2):
        top = rng.integers(0, 4, size=pol.partition.n_segments)
        got = pol.refine_levels(top, episode=5)
        want = jpol.refine_levels(top, episode=5)
        assert np.array_equal(got, want)
        strip = [[{k: v for k, v in st.items() if k != "seconds"}
                  for st in p.vcycle_stats] for p in (pol, jpol)]
        assert strip[0] == strip[1] and len(strip[0]) == pol.n_levels - 1


def test_expanding_engine_matches_reference():
    gj = make_diamond(8)
    gp, sim, jsim = _sim_pair(gj, "p100x4", sigma=0.05)
    pol = HierarchicalPolicy(coarsen(gp, 4), HCFG, uniform_box(4))
    jpol = jax_hierarchy.HierarchicalPolicy(jax_partition.coarsen(gj, 4),
                                            jax_config(HCFG),
                                            jax_uniform_box(4))
    eng = ExpandingEngine(pol, sim)
    jeng = jax_hierarchy.ExpandingEngine(jpol, jsim)
    assert (eng.batched, eng.deterministic, eng.measured) == (
        jeng.batched, jeng.deterministic, jeng.measured)
    seg = np.stack([np.arange(pol.partition.n_segments) % 4,
                    np.zeros(pol.partition.n_segments, int)])
    assert np.array_equal(eng.exec_times(seg, episode=5),
                          jeng.exec_times(seg, episode=5))
    assert np.array_equal(eng.evaluate_repeats(seg[0], 3),
                          jeng.evaluate_repeats(seg[0], 3))


# ------------------------------------ the reference's behaviour tests
def small_trainer(g, dev, hierarchy=HCFG, **kw):
    kw.setdefault("d_hidden", 16)
    kw.setdefault("total_episodes", 200)
    return training.DopplerTrainer(g, dev, seed=0, hierarchy=hierarchy,
                                   device="cpu", **kw)


def flat_sim(g, dev):
    return WCSimulator(g, dev, choose="fifo", noise_sigma=0.0)


def test_coarsen_chain_contracts_toward_target():
    part = coarsen(port_graph(make_chain(40)), 5)
    n_compute = sum(1 for v in part.seg_graph.vertices if v.kind != "input")
    assert n_compute == 5
    assert part.seg_graph.n <= 7
    assert (part.boundary_bytes[part.seg_graph.n - 1] == 0
            or len(part.seg_graph.exit_nodes) >= 1)


def test_coarsen_identity_when_target_large():
    diamond = port_graph(make_diamond())
    part = coarsen(diamond, diamond.n * 2)
    n_compute = sum(1 for v in diamond.vertices if v.kind != "input")
    assert sum(1 for v in part.seg_graph.vertices
               if v.kind != "input") == n_compute


def test_segment_graph_is_valid_workload():
    dev4 = uniform_box(4)
    part = coarsen(port_graph(make_diamond()), 4)
    sim = flat_sim(part.seg_graph, dev4)
    assert sim.exec_time(np.arange(part.seg_graph.n) % 4) > 0
    cp = critical_path_assignment(part.seg_graph, dev4, seed=0)
    assert cp.shape == (part.seg_graph.n,)


def test_tile_graph_forward_chain():
    unit = _unit(DataflowGraph)
    g = tile_graph(unit, 3, chains=(("x", 0, 1),), shared_labels=())
    # rep0 keeps its input; reps 1, 2 splice onto the previous output
    assert g.n == 3 * unit.n - 2
    assert g.replication.n_rep == 3 and g.replication.unit is unit
    np.testing.assert_allclose(g.total_flops(), 3 * unit.total_flops(),
                               rtol=1e-12)


def test_tile_graph_fwd_bwd_phases_acyclic():
    """A double chain (activations forward, cotangents backward) tiles
    into a DAG, and coarsening its replication never merges phases (the
    reference tests this on an imported model; the port's unit is
    written out)."""
    g = tile_graph(_unit(DataflowGraph, n=5, backward=True), 4,
                   chains=(("x", 0, 1), ("dy", 1, -1)))
    rep = g.replication
    assert rep.phase is not None
    for (u, v) in rep.unit.edges:
        assert not (rep.phase[u] == 1 and rep.phase[v] == 0)
    part = coarsen(g, 8)
    seg_phase = {}
    for v in range(g.n):
        s = int(part.vertex_segment[v])
        p = int(rep.phase[rep.unit_vid[v]])
        assert seg_phase.setdefault(s, p) == p, "segment spans chain phases"


def test_coarsen_multilevel_single_level_identity():
    g = synthetic_layered(12, 6)
    ml = coarsen_multilevel(g, 12, max_ratio=16.0)
    assert ml.n_levels == 1
    np.testing.assert_array_equal(ml.vertex_segment,
                                  coarsen(g, 12).vertex_segment)
    assert ml.seg_graph.n == ml.levels[0].seg_graph.n


def test_coarsen_multilevel_bounded_ratio_stack():
    g = synthetic_layered(48, 8)
    ml = coarsen_multilevel(g, 8, max_ratio=4.0)
    assert ml.n_levels >= 2
    sizes = [g.n] + [p.seg_graph.n for p in ml.levels]
    assert sizes == sorted(sizes, reverse=True)
    composed = np.arange(g.n)
    for part in ml.levels:
        composed = part.vertex_segment[composed]
    np.testing.assert_array_equal(ml.vertex_segment, composed)
    assert len(ml.level_stats) == ml.n_levels
    np.testing.assert_allclose(ml.seg_graph.total_flops(), g.total_flops(),
                               rtol=1e-9)
    seg_a = np.random.default_rng(0).integers(0, 4, size=ml.n_segments)
    a = seg_a
    for part in reversed(ml.levels):
        a = part.expand(a)
    np.testing.assert_array_equal(ml.expand(seg_a), a)
    one = MultilevelPartition([coarsen(g, 8)])
    assert isinstance(one.levels[0], Partition) and one.n_levels == 1


def test_vcycle_refine_levels_monotone():
    dev4 = uniform_box(4)
    g = synthetic_layered(48, 8)
    ml = coarsen_multilevel(g, 8, max_ratio=4.0)
    pol = HierarchicalPolicy(ml, MHCFG, dev4)
    top_a = np.random.default_rng(1).integers(0, 4, size=ml.seg_graph.n)
    flat = pol.refine_levels(top_a, episode=3)
    assert flat.shape == (g.n,)
    assert (flat >= 0).all() and (flat < 4).all()
    assert len(pol.vcycle_stats) == ml.n_levels - 1
    for st in pol.vcycle_stats:
        assert st["t_out"] <= st["t_in"] + 1e-12


def test_multilevel_place_beats_segment_cp():
    dev4 = uniform_box(4)
    g = synthetic_layered(48, 8)
    tr = small_trainer(g, dev4, hierarchy=MHCFG)
    assert tr.hier.n_levels >= 2
    tr.stage2_sim_batched(2, batch_size=4)
    res = tr.place(engine=flat_sim(g, dev4))
    assert res.assignment.shape == (g.n,)
    cp_seg = tr.hier.expand(critical_path_assignment(tr.g, dev4, seed=0))
    assert res.makespan <= flat_sim(g, dev4).batch_engine.exec_time(
        cp_seg) + 1e-12


def test_refine_monotone_and_valid():
    dev4 = uniform_box(4)
    g = port_graph(random_dag(np.random.default_rng(3), 60))
    part = coarsen(g, 10)
    pol = HierarchicalPolicy(part, HierarchyConfig(
        n_segments=10, refine_rounds=3, refine_top_k=8), dev4)
    sim = flat_sim(g, dev4)
    a0 = part.expand(np.arange(part.n_segments) % 4)
    t0 = sim.exec_time(a0)
    a1, t1 = pol.refine(a0, SimRewardEngine(sim))
    assert t1 <= t0 + 1e-12
    assert a1.shape == (g.n,) and (a1 >= 0).all() and (a1 < 4).all()
    assert t1 == pytest.approx(sim.exec_time(a1), rel=1e-12)
    assert pol.refine_state.assignment is not None
    assert pol.refine_state.exec_time == pytest.approx(t1)


def test_boundary_scores_ignore_inputs_and_local_edges():
    diamond = port_graph(make_diamond())
    assert (boundary_scores(diamond, np.zeros(diamond.n, int)) == 0).all()
    s = boundary_scores(diamond, np.arange(diamond.n) % 2)
    assert s[diamond.input_mask()].sum() == 0 and s.sum() > 0


def test_hierarchical_trainer_runs_all_stages():
    """Every stage on the segment graph, then a flat place() on the
    trainer's default engine (the flat oracle, cached per fleet) that
    never loses to the expanded segment-CP candidate."""
    dev4 = uniform_box(4)
    g = synthetic_layered(24, 6)
    tr = small_trainer(g, dev4)
    assert tr.g.n < g.n and tr.flat_graph is g
    tr.stage1_imitation(3)
    tr.stage1_imitation_fused(2)
    tr.stage2_sim_batched(2, batch_size=4)
    tr.train_rl(flat_sim(tr.g, dev4), 1, batch_size=4)
    tr.stage2_fused(1, batch_size=4)
    res = tr.place()
    assert tr._twin_cache[dev4.fingerprint()] is tr.flat_engine()
    assert res.assignment.shape == (g.n,)
    assert res.makespan == float(tr.flat_engine().exec_times(
        res.assignment[None])[0])
    cp_seg = tr.hier.expand(critical_path_assignment(tr.g, dev4, seed=0))
    assert res.makespan <= float(tr.flat_engine().exec_times(
        cp_seg[None])[0])


def test_flat_place_unchanged():
    dev4 = uniform_box(4)
    diamond = port_graph(make_diamond())
    tr = training.DopplerTrainer(diamond, dev4, seed=0, d_hidden=16,
                                 total_episodes=50, device="cpu")
    assert tr.hier is None and tr.flat_graph is tr.g
    tr.stage2_sim_batched(1, batch_size=4, sim=flat_sim(diamond, dev4))
    res = tr.place(engine=flat_sim(diamond, dev4))
    assert res.assignment.shape == (diamond.n,)
    assert res.makespan == pytest.approx(
        flat_sim(diamond, dev4).exec_time(res.assignment), rel=1e-12)
    assert set(res.seconds) == {"encode", "rollout", "oracle"}
