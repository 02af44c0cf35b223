"""The port's fused engine (``repro_torch.core.train_fused``) piece by
piece against ``repro.core.train_fused`` and ``repro.train.optim``.

Parameters come across with ``to_numpy_params`` -> ``params_from_numpy``,
draws are the reference's materialised tables (``_episode_rng_tables``),
and the reference runs its "xla" backends; the port its plain versions on
the CPU.  Bars:

* the device schedules: lr and eps bit-equal to the reference's traced
  ``linear_schedule`` on an int32 counter over a sweep;
* the in-place device AdamW within 1e-7 of ``adamw_update``;
* ``sample_episodes``: actions and assignment bit-identical (at eps 0 and
  0.2: both samplers reuse the policy draw's gumbel row), recordings
  within 1e-6 (of max(1, |x|)), the reduced recording's ``x_dyn``
  bit-equal to the dynamic columns of ``x_dev``;
* the oracle's set-up (``trip_inputs``), built without a host copy so a
  CUDA graph can capture it, bit-equal to the reference's.

The losses are in ``tests/test_torch_fused_loss.py``, the trainer's
entry points in ``tests/test_torch_fused_stage.py`` and
``tests/test_torch_fused_steps.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sim_jax
from repro.core import train_fused as jax_fused
from repro.train import optim as jax_optim
from repro_torch.core import train_fused
from repro_torch.core.assign import encode
from repro_torch.core.nn import tree_leaves, tree_map
from repro_torch.core.sim_torch import F_BIG, SimGraph, trip_inputs
from repro_torch.train import optim
from test_torch_train import assert_grads_close, trainer_pair

REC_TOL = 1e-6


def reference_draws(keys, n, nd):
    """The reference's step-major draw tables for ``keys``, as numpy."""
    return [np.array(x) for x in jax_fused._episode_rng_tables(keys, n, nd)]


def as_port(rec) -> dict:
    """A reference recording as port tensors (actions as int64)."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in rec.items()}
    out["actions"] = out["actions"].long()
    out["assignment"] = out["assignment"].long()
    return out


def _close(got: torch.Tensor, want, tol=REC_TOL) -> None:
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err


# ------------------------------------------------ schedules and AdamW
@pytest.mark.parametrize("lr0,lr1,n", [(1e-4, 1e-7, 4000), (0.2, 0.0, 4000),
                                       (0.2, 0.0, 200), (3e-3, 1e-4, 400),
                                       (0.2, 0.05, 7), (0.2, 0.0, 0)])
def test_device_schedule_bit_equal_to_traced_reference(lr0, lr1, n):
    e = np.arange(0, 6000, dtype=np.int32)
    traced = jax.jit(jax.vmap(jax_optim.linear_schedule(lr0, lr1, n)))
    want = np.asarray(traced(jnp.asarray(e)))
    got = optim.linear_schedule(lr0, lr1, n)(torch.from_numpy(e))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # one counter at a time, as the fused update calls it
    one = jax.jit(jax_optim.linear_schedule(lr0, lr1, n))
    for i in (0, 1, 7, n - 1, n, n + 1, 5999):
        x = optim.linear_schedule(lr0, lr1, n)(torch.tensor(i, dtype=torch.int32))
        assert x.numpy().tobytes() == np.float32(one(jnp.int32(i))).tobytes()


def _tree(rng, scale=1.0):
    def leaf(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"a": {"w": leaf(5, 3), "b": leaf(3)},
            "layers": [{"w": leaf(4, 4), "b": leaf(4)}, {"w": leaf(2, 7)}]}


@pytest.mark.parametrize("max_grad_norm,weight_decay,gscale", [
    (1.0, 0.0, 1.0), (1.0, 0.0, 1e-3), (None, 0.01, 1.0)])
def test_device_adamw_matches_reference(max_grad_norm, weight_decay, gscale):
    """Six in-place steps, the lr from the device schedule at an int32
    counter: params and moments within 1e-7 of the reference's
    ``adamw_update`` (and of the port's host one), the step counted on
    the device."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    p_t = tree_map(lambda x: torch.from_numpy(x.copy()), params)
    p_h = tree_map(lambda x: torch.from_numpy(x.copy()), params)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    zeros = tree_map(torch.zeros_like, p_t)
    s_t = optim.AdamState(torch.zeros((), dtype=torch.int32), zeros,
                          tree_map(torch.clone, zeros))
    s_h, s_j = optim.adamw_init(p_h), jax_optim.adamw_init(p_j)
    sched = optim.linear_schedule(3e-3, 1e-5, 10)
    sched_j = jax.jit(jax_optim.linear_schedule(3e-3, 1e-5, 10))
    episode = torch.zeros((), dtype=torch.int32)
    for step in range(6):
        grads = _tree(rng, gscale)
        optim.adamw_update_(tree_map(torch.from_numpy, grads), s_t, p_t,
                            sched(episode), weight_decay=weight_decay,
                            max_grad_norm=max_grad_norm)
        episode += 1
        p_h, s_h = optim.adamw_update(tree_map(torch.from_numpy, grads), s_h,
                                      p_h, sched(step),
                                      weight_decay=weight_decay,
                                      max_grad_norm=max_grad_norm)
        p_j, s_j = jax_optim.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads), s_j, p_j,
            sched_j(jnp.int32(step)), weight_decay=weight_decay,
            max_grad_norm=max_grad_norm)
    assert s_t.step.dtype == torch.int32 and int(s_t.step) == 6
    for got, want in ((p_t, p_j), (s_t.mu, s_j.mu), (s_t.nu, s_j.nu)):
        assert_grads_close(got, want, 1e-7)
    for a, b in zip(tree_leaves(p_t), tree_leaves(p_h)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7)


def test_reward_stats_match_reference():
    """``baseline`` with the exact (0, 1) empty case, then in-place
    ``update``s, against the reference's ``RewardStats``."""
    rs = [np.array([-0.5, -0.25, -0.75], np.float32),
          np.array([-0.125, -1.5, -0.25], np.float32)]
    got, want = train_fused.RewardStats.make(), jax_fused.RewardStats.make()
    for r in rs + [None]:
        m, s = got.baseline()
        mj, sj = want.baseline()
        assert (float(m), float(s)) == (float(mj), float(sj))
        if r is not None:
            got.update(torch.from_numpy(r))
            want = want.update(jnp.asarray(r))
    assert got.r_count.dtype == torch.int32 and int(got.r_count) == 6
    assert float(got.r_sum) == float(want.r_sum)


# ----------------------------------------------------------- the sampler
@pytest.mark.parametrize("gname,fleet,eps", [("diamond", "p100x4", 0.0),
                                             ("ffnn", "mixed_gen4", 0.0),
                                             ("ffnn", "p100x4", 0.2)])
def test_sample_episodes_matches_reference(gname, fleet, eps):
    jt, pt = trainer_pair(gname, fleet)
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    want = jax_fused.sample_episodes(jt.params, jt.gd, keys,
                                     jnp.float32(eps))
    draws = [torch.from_numpy(x) for x in
             reference_draws(keys, jt.g.n, jt.dev.n)]
    eps_t = torch.tensor(eps, dtype=torch.float32)
    got = train_fused.sample_episodes(pt.params, pt.gd, draws, eps_t)
    assert np.array_equal(got["actions"].numpy(), np.asarray(want["actions"]))
    assert np.array_equal(got["assignment"].numpy(),
                          np.asarray(want["assignment"]))
    for key in ("x_dev", "sel_p", "sel_lse", "sel_ex"):
        _close(got[key], want[key])

    # the reduced recordings: the same episodes, x_dyn the dynamic columns
    enc = encode(pt.params, pt.gd)
    red = train_fused._sample_scan(pt.params, pt.gd, draws, eps_t,
                                   "learned", "learned", enc, "reduced")
    jenc = jax_fused.episode_encodings(jt.params, jt.gd.x, jt.gd.edges,
                                       jt.gd.edge_feat, jt.gd.b_path,
                                       jt.gd.t_path)
    red_j = jax_fused._sample_scan(jt.params, jt.gd, keys, jnp.float32(eps),
                                   "learned", "learned", jenc, "reduced")
    assert torch.equal(red["actions"], got["actions"])
    n_dyn = got["x_dev"].shape[-1] - pt.gd.dev_x.shape[1]
    assert torch.equal(red["x_dyn"], got["x_dev"][..., :n_dyn])
    for key in ("x_dyn", "sel_P", "sel_Q", "sel_lse_sum", "sel_ex_sum"):
        _close(red[key], red_j[key])


@pytest.mark.parametrize("sel_mode,plc_mode", [("cp", "learned"),
                                               ("learned", "etf")])
def test_sample_episodes_ablations_match_reference(sel_mode, plc_mode):
    jt, pt = trainer_pair("ffnn", "mixed_gen4")
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    want = jax_fused.sample_episodes(jt.params, jt.gd, keys,
                                     jnp.float32(0.1), sel_mode, plc_mode)
    got = train_fused.sample_episodes(
        pt.params, pt.gd, [torch.from_numpy(x) for x in
                           reference_draws(keys, jt.g.n, jt.dev.n)],
        torch.tensor(0.1), sel_mode, plc_mode)
    assert np.array_equal(got["actions"].numpy(), np.asarray(want["actions"]))


# -------------------------------------------------------------- the oracle
@pytest.mark.parametrize("gname,fleet", [("ffnn", "mixed_gen4"),
                                         ("diamond", "p100x4")])
def test_trip_inputs_equal_reference_set_up(gname, fleet):
    """The oracle's set-up, its constant tail now built on the device:
    tkn's transfer and trash rows bit-equal to the host-made constant
    [F_BIG, 0, -1], and tkn, hdtl and run bit-equal to the reference's
    ``_init_episode`` on random assignments."""
    jt, pt = trainer_pair(gname, fleet)
    sg = SimGraph.build(pt.g, pt.dev)
    jsg = sim_jax.SimGraph.build(jt.g, jt.dev)
    A = np.random.default_rng(3).integers(0, pt.dev.n, (5, pt.g.n))
    _, _, _, _, tkn, hdtl, run, need, cand = trip_inputs(
        sg, torch.from_numpy(A))
    n, mm = sg.n, sg.esrc.shape[0]
    assert tkn.dtype == torch.float32 and tkn.shape == (5, n + mm + 1, 3)
    assert torch.equal(tkn[:, n:], torch.tensor([F_BIG, 0.0, -1.0]).expand(
        5, mm + 1, 3))
    for b in range(5):
        t_j, h_j, r_j = sim_jax._init_episode(jsg, jnp.asarray(A[b]))[:3]
        assert np.array_equal(tkn[b, :-1].numpy(), np.asarray(t_j))
        assert np.array_equal(hdtl[b, :-1].numpy(), np.asarray(h_j))
        assert np.array_equal(run[b].numpy(), np.asarray(r_j))
