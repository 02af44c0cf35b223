"""The port's fused entry points step by step, Stage I, and what a CUDA
graph needs of the update, against the reference trainer.

Eager on the CPU, draws from the reference trainer's key chain (see
``tests/test_torch_fused_stage.py``).  Bars:

* Stage II at one update a dispatch: makespans bit-identical, the sampled
  actions the reference's, the advantages within 1e-6 of the reference's
  arithmetic on its reward statistics, and each step held against the
  reference's fused loss, gradient and AdamW step on the port's pre-step
  state (``assert_step_matches_reference``: loss 1e-5 relative, gradient
  5e-6 of max(1, max|g|), params lr / 100); a non-converging oracle
  raises and the dispatch is discarded; a port analogue of the
  reference's ``test_stage2_fused_learns``;
* Stage I against the reference's ``stage1_imitation_fused`` and the
  port's loop: losses at rtol 1e-3 / atol 1e-5, params 5e-3 (the
  reference's loop-vs-fused bars);
* nothing the update runs reads a value back to the host (what a CUDA
  graph cannot capture): no ``item``, ``bool``, ``nonzero`` and no
  tensor made from host data, outside the plain trip loop that stands in
  for ``wc_trips`` on the CPU.
"""
import dataclasses
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import make_diamond
from repro.core import sim_jax
from repro.core import train_fused as jax_fused
from repro_torch.core import training
from repro_torch.core.devices import get_device_model, uniform_box
from repro_torch.core.sim_torch import SimGraph
from repro_torch.graphs.workloads import get_workload
from test_torch_fused_stage import (EPS0, key_chain_draws, same_bookkeeping,
                                    same_params)
from test_torch_train import (assert_params_close,
                              assert_step_matches_reference, before_step,
                              port_graph, trainer_pair)


# -------------------------------------------------------------- Stage II
def _reference_advantages(jt, sg, rec):
    """The reference update's masked advantages on ``rec``, from its
    reward statistics before the update."""
    stats = jax_fused.RewardStats.make(jt._r_sum, jt._r_sqsum, jt._r_count)
    ms, ok = sim_jax._makespan_fifo_batch_xla(sg, rec["assignment"])
    rs = jnp.where(ok, -ms, 0.0)
    mean, std = stats.baseline()
    advs = rs - jnp.where(stats.r_count > 0, mean, rs.mean())
    advs = advs / (jnp.maximum(std, rs.std()) + 1e-9)
    return jnp.where(ok, advs, 0.0)


def test_stage2_fused_steps_match_reference():
    """One update a dispatch, each held against the reference's fused
    loss, gradient and AdamW step on the port's pre-step state."""
    jt, pt = trainer_pair("ffnn", "mixed_gen4", **EPS0)
    sg = sim_jax.SimGraph.build(jt.g, jt.dev)
    ew = jnp.float32(jt.entropy_weight)
    loss_and_grad = jax.jit(jax.value_and_grad(jax_fused.fused_pg_loss))
    for _ in range(3):
        draws = key_chain_draws(jt, 1, 4)
        _, sub = jax.random.split(jt.key)
        keys = jax.random.split(sub, 4)
        eps = jnp.float32(jt.eps_sched(jnp.int32(jt.episode)))
        rec = jax_fused.sample_episodes(jt.params, jt.gd, keys, eps)
        advs = _reference_advantages(jt, sg, rec)
        before = before_step(pt)
        want = jt.stage2_fused(1, batch_size=4, updates_per_dispatch=1)
        got = pt.stage2_fused(1, batch_size=4, updates_per_dispatch=1,
                              draws=draws)
        assert got == want
        assert np.array_equal(pt.last_update["rewards"],
                              -np.asarray(want, np.float32))
        assert np.array_equal(pt.last_update["actions"].numpy(),
                              np.asarray(rec["actions"]))
        np.testing.assert_allclose(pt.last_update["advantages"],
                                   np.asarray(advs), rtol=1e-6, atol=1e-7)

        def ref_loss_and_grad(p):
            r = jax_fused.sample_episodes(p, jt.gd, keys, eps)
            return loss_and_grad(p, jt.gd, r, advs, ew)
        assert_step_matches_reference(pt, jt, before, ref_loss_and_grad)
    same_bookkeeping(pt, jt)
    assert_params_close(pt, jt)


def test_stage2_fused_raises_on_nonconverged_oracle():
    """A SimGraph doctored to starve the trip loop: every episode is
    flagged, the dispatch raises and its result is discarded."""
    _, pt = trainer_pair("diamond", "p100x4")
    sg = SimGraph.build(pt.g, pt.dev)
    pt._fused_cache = {"sim_graph": dataclasses.replace(sg, n_trips=1)}
    params = pt.params
    with pytest.raises(RuntimeError, match="converge"):
        pt.stage2_fused(2, batch_size=4, updates_per_dispatch=2)
    assert pt.params is params and pt.opt_state.step == 0
    assert (pt.episode, pt.history, pt._r_count) == (0, [], 0)


def test_stage2_fused_learns():
    """The port analogue of the reference's test: 40 updates of 8 on the
    diamond, fresh draws from the trainer's generator."""
    tr = training.DopplerTrainer(port_graph(make_diamond()), uniform_box(4),
                                 seed=0, d_hidden=32, total_episodes=400,
                                 lr0=3e-3, lr1=1e-4, device="cpu")
    times = tr.stage2_fused(40, batch_size=8, updates_per_dispatch=10)
    assert len(times) == 320
    assert np.mean(times[-40:]) < np.mean(times[:40])
    assert tr.best_time <= min(times) + 1e-12


def test_stage2_fused_arguments():
    _, pt = trainer_pair("diamond", "p100x4")
    with pytest.raises(NotImplementedError, match="A12"):
        pt.stage2_fused(1, batch_size=4, n_devices=2)
    with pytest.raises(ValueError, match="CUDA"):
        pt.stage2_fused(1, batch_size=4, capture=True)
    with pytest.raises(ValueError, match="draw tables"):
        pt.stage2_fused(2, batch_size=4, draws=[None])


# --------------------------------------------------------------- Stage I
@pytest.mark.parametrize("gname,fleet", [("diamond", "p100x4"),
                                         ("ffnn", "mixed_gen4")])
def test_stage1_imitation_fused_matches_reference_and_loop(gname, fleet):
    jt, pt = trainer_pair(gname, fleet, total_episodes=200)
    _, loop = trainer_pair(gname, fleet, total_episodes=200)
    want = jt.stage1_imitation_fused(6, seed=3)
    got = pt.stage1_imitation_fused(6, seed=3)
    looped = loop.stage1_imitation(6, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got, looped, rtol=1e-3, atol=1e-5)
    assert pt.episode == jt.episode == 6
    assert pt.opt_state.step == 6
    assert_params_close(pt, jt)
    same_params(pt, loop)
    assert set(pt.seconds) == {"teacher", "dynamics", "updates"}
    assert pt.losses == got


def test_stage1_imitation_fused_batched():
    jt, pt = trainer_pair("diamond", "p100x4", total_episodes=200)
    want = jt.stage1_imitation_fused(8, seed=0, batch_size=4)
    got = pt.stage1_imitation_fused(8, seed=0, batch_size=4)
    assert len(got) == 2 and pt.episode == 8 and pt.opt_state.step == 2
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert_params_close(pt, jt)
    assert pt.last_update["actions"].shape == (4, pt.g.n, 2)
    with pytest.raises(ValueError, match="divisible"):
        pt.stage1_imitation_fused(6, batch_size=4)


# ------------------------------------------------------- capturability
class _HostReads(TorchDispatchMode):
    """Counts the ops that read a value back to the host or make a tensor
    from host data, outside the plain trip loop (ref.py), by source
    line."""
    FLAGGED = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
               "lift_fresh", "equal", "is_nonzero")

    def __init__(self):
        super().__init__()
        self.found = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name.startswith(self.FLAGGED):
            frames = [f for f in traceback.extract_stack()
                      if "repro_torch" in f.filename]
            if not any(f.filename.endswith("wc_oracle/ref.py")
                       for f in frames):
                where = f"{name} {frames[-1].filename}:{frames[-1].lineno}"
                self.found[where] = self.found.get(where, 0) + 1
        return func(*args, **(kwargs or {}))


def test_fused_updates_read_nothing_back_to_the_host():
    """The update function of each engine (monolithic and chunked Stage
    II, Stage I), run once more under a dispatch mode after a dispatch
    set its buffers: no host read, no tensor from host data."""
    tr = training.DopplerTrainer(get_workload("ffnn"),
                                 get_device_model("p100x4"), seed=0,
                                 d_hidden=16, device="cpu")
    tr.stage2_fused(1, batch_size=4)
    tr.stage2_fused(1, batch_size=8, chunk_size=4, grad_chunk_size=2)
    tr.stage1_imitation_fused(2, batch_size=2)
    engines = [e for k, e in tr._fused_cache.items() if k != "sim_graph"]
    assert len(engines) == 3
    for eng in engines:
        with _HostReads() as mode:
            eng._update()
        assert mode.found == {}, mode.found
