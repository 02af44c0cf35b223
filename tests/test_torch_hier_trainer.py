"""The port's hierarchical trainer (``DopplerTrainer(..., hierarchy=)``,
its ``place()`` and its checkpoints) against the JAX reference with the
same parameters:

* the same segment graph and greedy assignment, the same ``place()``
  (with and without flat CP seeds, from a fresh trainer and with a best
  so far, refined or not) under the copied numpy ``WCSimulator`` on both
  sides and under ``TorchWCEngine(backend="torch")`` against the
  reference's ``JaxWCEngine``;
* Stage I / Stage II steps on the segment graph and one update over flat
  rewards through ``ExpandingEngine``, on the reference's draws, within
  ``tests/test_torch_stage2.py``'s bars;
* checkpoints move between ``repro`` and the port both ways with
  ``extra["hierarchy"]`` equal, a resume mid-Stage-II is exact, and the
  mismatches raise with the trainer untouched.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy as jax_hierarchy
from repro.core import policy_io as jax_policy_io
from repro.core import training as jax_training
from repro.core.devices import get_device_model as jax_fleet
from repro.core.engine import SimRewardEngine as JaxSimRewardEngine
from repro.core.sim_jax import JaxWCEngine
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro.core.zero_shot import to_numpy_params
from repro.graphs.workloads import synthetic_layered as jax_layered
from repro_torch.core import policy_io, training
from repro_torch.core.devices import get_device_model
from repro_torch.core.hierarchy import ExpandingEngine
from repro_torch.core.nn import tree_leaves
from repro_torch.core.sim_torch import TorchWCEngine
from repro_torch.core.simulator import WCSimulator
from repro_torch.models.convert import params_from_numpy
from test_torch_hierarchy import (HCFG, MHCFG, jax_config, same_graph,
                                  same_multilevel)
from test_torch_stage2 import EPS02, step_pair
from test_torch_train import (assert_params_close,
                              assert_step_matches_reference, before_step,
                              port_graph)


def hier_pair(gj, fleet, cfg=HCFG, **kw):
    """(reference trainer, port trainer on the CPU), hierarchical with
    ``cfg``, on the same params."""
    kw = {"d_hidden": 16, "total_episodes": 200, **kw}
    jt = jax_training.DopplerTrainer(gj, jax_fleet(fleet), seed=0,
                                     hierarchy=jax_config(cfg), **kw)
    pt = training.DopplerTrainer(port_graph(gj), get_device_model(fleet),
                                 seed=0, device="cpu", hierarchy=cfg, **kw)
    pt.params = params_from_numpy(to_numpy_params(jt.params))
    return jt, pt


@pytest.mark.parametrize("engine", ["numpy", "oracle"])
def test_hierarchical_place_matches_reference(engine):
    """``place()`` with and without flat CP seeds, from a fresh trainer
    and with a best-so-far, the engine named on both sides: the numpy
    ``WCSimulator``, or the port's oracle (plain trip loop) against the
    reference's ``JaxWCEngine``.  A multi-level stack, so the V-cycle
    runs."""
    gj = jax_layered(16, 6) if engine == "oracle" else jax_layered(48, 8)
    jt, pt = hier_pair(gj, "mixed_gen4", cfg=MHCFG)
    same_multilevel(pt.hier.partition, jt.hier.partition)
    same_graph(pt.g, jt.g)
    assert pt.flat_graph.n == gj.n and pt.g.n < gj.n
    assert np.array_equal(pt.greedy_assignment(), jt.greedy_assignment())
    if engine == "numpy":
        eng = WCSimulator(pt.flat_graph, pt.dev, noise_sigma=0.0)
        jeng = JaxWCSimulator(gj, jt.dev, noise_sigma=0.0)
    else:
        eng = TorchWCEngine(pt.flat_graph, pt.dev, backend="torch",
                            device="cpu")
        jeng = JaxWCEngine(gj, jt.dev)
    best = np.random.default_rng(4).integers(0, 4, size=pt.g.n)
    # the oracle's batches are slow on the CPU: two of the four cases
    cases = ([(False, False), (True, True)] if engine == "oracle" else
             [(b, f) for b in (False, True) for f in (False, True)])
    for with_best, flat_cp in cases:
        if with_best:
            pt.best_assignment, jt.best_assignment = best.copy(), best.copy()
        got = pt.place(engine=eng, include_flat_cp=flat_cp)
        a, t = jt.place(engine=jeng, include_flat_cp=flat_cp)
        assert np.array_equal(got.assignment, a)
        assert got.makespan == t
        rs, jrs = pt.hier.refine_state, jt.hier.refine_state
        assert got.refine_state is rs
        assert np.array_equal(rs.assignment, jrs.assignment)
        assert (rs.exec_time, rs.rounds_done, rs.moves_applied) == (
            jrs.exec_time, jrs.rounds_done, jrs.moves_applied)
        assert set(got.seconds) == {"pool", "vcycle", "refine"}
    # place() never writes the segment-level best assignment
    assert np.array_equal(pt.best_assignment, best)
    unrefined = pt.place(engine=eng, refine=False)
    a, t = jt.place(engine=jeng, refine=False)
    assert np.array_equal(unrefined.assignment, a) and unrefined.makespan == t
    assert unrefined.refine_state is None
    with pytest.raises(ValueError):
        pt.place(n_samples=4)


def test_hierarchical_stage1_and_stage2_match_reference():
    """Stage I episodes and Stage II updates (batched, eps 0.2, on the
    reference's draws) on the segment graph, each step held at
    ``tests/test_torch_stage2.py``'s bars; then one Stage II update over
    flat rewards through ``ExpandingEngine``."""
    jt, pt = hier_pair(jax_layered(24, 6), "mixed_gen4", **EPS02)
    for i in range(2):
        before = before_step(pt)
        jt.stage1_imitation(1, seed=i)
        pt.stage1_imitation(1, seed=i)
        acts = jnp.asarray(pt.last_update["actions"])
        assert_step_matches_reference(
            pt, jt, before, lambda p: jax_training._imitation_loss_and_grad(
                p, jt.gd, jax.random.PRNGKey(0), acts))
    jsim = JaxWCSimulator(jt.g, jt.dev, noise_sigma=0.05)
    sim = WCSimulator(pt.g, pt.dev, noise_sigma=0.05)
    for _ in range(2):
        step_pair(jt, pt,
                  lambda: jt.stage2_sim_batched(1, sim=jsim, batch_size=4),
                  lambda d: pt.stage2_sim_batched(1, sim=sim, batch_size=4,
                                                  draws=d),
                  K=4, reward=JaxSimRewardEngine(jsim))
    fsim = JaxWCSimulator(jt.flat_graph, jt.dev, noise_sigma=0.0)
    jflat = jax_hierarchy.ExpandingEngine(jt.hier, fsim)
    flat = ExpandingEngine(pt.hier, WCSimulator(pt.flat_graph, pt.dev,
                                                noise_sigma=0.0))
    step_pair(jt, pt, lambda: jt.train_rl(jflat, 1, batch_size=4),
              lambda d: pt.train_rl(flat, 1, batch_size=4, draws=d),
              K=4, reward=jflat)
    assert pt.best_time == jt.best_time
    assert np.array_equal(pt.best_assignment, jt.best_assignment)
    assert_params_close(pt, jt)


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_hierarchical_checkpoint_crosses_packages(tmp_path, writer):
    """A hierarchical checkpoint written by either package loads in the
    other: ``extra["hierarchy"]`` equal (level maps, refinement state),
    params bit-equal, counters and best equal."""
    jt, pt = hier_pair(jax_layered(48, 8), "p100x4", cfg=MHCFG)
    src = pt if writer == "port" else jt
    src.best_assignment = np.arange(src.g.n) % 4
    src.best_time = 0.5
    src.place(engine=WCSimulator(pt.flat_graph, pt.dev, noise_sigma=0.0)
              if writer == "port" else None)
    save = policy_io.save_policy if writer == "port" else \
        jax_policy_io.save_policy
    path = save(tmp_path, src)
    dst = (jax_training.DopplerTrainer(jt.flat_graph, jt.dev, seed=3,
                                       d_hidden=16,
                                       hierarchy=jax_config(MHCFG))
           if writer == "port" else
           training.DopplerTrainer(pt.flat_graph, pt.dev, seed=3,
                                   d_hidden=16, device="cpu",
                                   hierarchy=MHCFG))
    (jax_policy_io if writer == "port" else policy_io).load_policy(tmp_path,
                                                                   dst)
    extra = json.loads((path / "manifest.json").read_text())["extra"]
    assert extra["hierarchy"] == src.hier.state_dict()
    assert dst.hier.state_dict() == src.hier.state_dict()
    assert extra["hierarchy"]["n_levels"] == src.hier.n_levels >= 2
    got = [np.asarray(x) for x in (tree_leaves(dst.params) if writer ==
                                   "port" else
                                   jax.tree_util.tree_leaves(dst.params))]
    want = [np.asarray(x) for x in (tree_leaves(src.params) if writer ==
                                    "port" else
                                    jax.tree_util.tree_leaves(src.params))]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert dst.best_time == 0.5
    assert np.array_equal(dst.best_assignment, src.best_assignment)


def test_hierarchical_resume_is_exact(tmp_path):
    """Port -> port, mid-Stage-II on a multi-level trainer: the resumed
    run's rewards, params, greedy assignment and refinement state equal
    the uninterrupted run's."""
    torch.set_num_threads(1)
    g = port_graph(jax_layered(48, 8))

    def fresh():
        return training.DopplerTrainer(g, get_device_model("p100x4"), seed=0,
                                       d_hidden=16, total_episodes=200,
                                       device="cpu", hierarchy=MHCFG)

    tr = fresh()
    sim = WCSimulator(tr.g, tr.dev, noise_sigma=0.05)
    tr.stage1_imitation(2)
    tr.stage2_sim_batched(2, sim, batch_size=4)
    tr.place(engine=WCSimulator(g, tr.dev, noise_sigma=0.0))
    policy_io.save_policy(tmp_path, tr)
    want = tr.stage2_sim_batched(2, sim, batch_size=4)
    tr2 = fresh()
    policy_io.load_policy(tmp_path, tr2)
    np.testing.assert_array_equal(tr2.hier.refine_state.assignment,
                                  tr.hier.refine_state.assignment)
    assert tr2.hier.refine_state.exec_time == tr.hier.refine_state.exec_time
    assert tr2.stage2_sim_batched(2, sim, batch_size=4) == want
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.params),
                                                 tree_leaves(tr2.params)))
    assert np.array_equal(tr.greedy_assignment(), tr2.greedy_assignment())
    assert torch.equal(tr.generator.get_state(), tr2.generator.get_state())


@pytest.mark.parametrize("fault", ["hier_into_flat", "flat_into_hier",
                                   "segments", "levels", "legacy_multi"])
def test_checkpoint_mismatch_raises_and_leaves_trainer(tmp_path, fault):
    g = port_graph(jax_layered(48, 8))
    fleet = get_device_model("p100x4")

    def make(hierarchy):
        return training.DopplerTrainer(g, fleet, seed=2, d_hidden=16,
                                       device="cpu", hierarchy=hierarchy)
    src = make(None if fault == "flat_into_hier" else MHCFG)
    policy_io.save_policy(tmp_path, src)
    if fault == "legacy_multi":            # a checkpoint without the stack
        m = next(tmp_path.glob("step_*")) / "manifest.json"
        manifest = json.loads(m.read_text())
        for key in ("level_maps", "n_levels"):
            manifest["extra"]["hierarchy"].pop(key)
        m.write_text(json.dumps(manifest))
    dst = make({"hier_into_flat": None, "flat_into_hier": MHCFG,
                "segments": dataclasses.replace(MHCFG, n_segments=6),
                "levels": dataclasses.replace(MHCFG, max_ratio=1e9),
                "legacy_multi": MHCFG}[fault])
    dst.stage1_imitation(1)
    before = ([x.clone() for x in tree_leaves(dst.params)], dst.episode,
              dst.generator.get_state(), dst.opt_state.step,
              None if dst.hier is None else dst.hier.refine_state)
    match = {"hier_into_flat": "hierarchical", "flat_into_hier": "flat"}
    with pytest.raises(ValueError, match=match.get(fault, "partition")):
        policy_io.load_policy(tmp_path, dst)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(dst.params), before[0]))
    assert (dst.episode, dst.opt_state.step) == (before[1], before[3])
    assert torch.equal(dst.generator.get_state(), before[2])
    if dst.hier is not None:
        assert dst.hier.refine_state is before[4]
