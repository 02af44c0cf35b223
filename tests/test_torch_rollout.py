"""Port rollout vs the JAX reference on the same parameters and draws.

* greedy episodes decision-exact against ``repro.core.assign.rollout``
  (greedy=True) and the numpy twin ``zero_shot.greedy_place``;
* sampled episodes on the reference's own draw tables
  (``train_fused._episode_rng_tables``): at eps=0 decision-exact against
  ``rollout_batch`` on the same keys, at eps=0.2 against
  ``train_fused.sample_episodes``;
* per-step log-probs and entropies within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assign as jax_assign
from repro.core import policies as jax_policies
from repro.core.devices import get_device_model as jax_fleet
from repro.core.train_fused import _episode_rng_tables, sample_episodes
from repro.core.zero_shot import greedy_place, to_numpy_params
from repro.graphs import workloads as jax_workloads
from repro_torch.core import assign
from repro_torch.core.devices import get_device_model
from repro_torch.graphs import workloads
from repro_torch.models.convert import params_from_numpy

ATOL = 1e-5
K = 6


def _setup(gname, args, fleet, d_hidden, seed=0):
    gj = getattr(jax_workloads, gname)(*args)
    g = getattr(workloads, gname)(*args)
    devj = jax_fleet(fleet)
    jparams = jax_policies.init_policies(jax.random.PRNGKey(seed),
                                         d_hidden=d_hidden)
    params = params_from_numpy(to_numpy_params(jparams))
    return (gj, devj, jparams, jax_assign.build_graph_data(gj, devj),
            params, assign.build_graph_data(g, get_device_model(fleet),
                                            device="cpu"))


def _draws(gj, devj, seed=7):
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    return keys, [np.array(x) for x in _episode_rng_tables(keys, gj.n,
                                                           devj.n)]


@pytest.mark.parametrize("gname,args,fleet,d_hidden", [
    ("synthetic_layered", (3, 4), "p100x4", 16),
    ("synthetic_layered", (3, 4), "mixed_gen4", 32),
    ("chainmm", (), "mixed_gen4", 32),
    ("ffnn", (), "p100x4", 64),
    ("chainmm", (), "two_pod_2x2", 16),
    ("synthetic_layered", (3, 4), "straggler8", 16),
])
def test_greedy_decision_exact(gname, args, fleet, d_hidden):
    gj, devj, jparams, gdj, params, gd = _setup(gname, args, fleet, d_hidden)
    ref = jax_assign.rollout(jparams, gdj, jax.random.PRNGKey(0),
                             jnp.float32(0.0),
                             jnp.zeros((gj.n, 2), jnp.int32),
                             jnp.array(False), greedy=True)
    out = assign.rollout(params, gd, greedy=True)
    assert np.array_equal(out["actions"].numpy(), np.asarray(ref["actions"]))
    assert np.array_equal(out["assignment"].numpy(),
                          np.asarray(ref["assignment"]))
    assert np.array_equal(out["assignment"].numpy(),
                          greedy_place(to_numpy_params(jparams), gj, devj))
    for key in ("sel_logp", "plc_logp", "sel_ent", "plc_ent"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL)


@pytest.mark.parametrize("gname,args,fleet,d_hidden", [
    ("synthetic_layered", (3, 4), "p100x4", 16),
    ("chainmm", (), "mixed_gen4", 32),
])
def test_sampled_eps0_matches_rollout_batch(gname, args, fleet, d_hidden):
    gj, devj, jparams, gdj, params, gd = _setup(gname, args, fleet, d_hidden)
    keys, tables = _draws(gj, devj)
    ref = jax_assign.rollout_batch(jparams, gdj, keys, jnp.float32(0.0))
    out = assign.rollout_batch(params, gd, K, 0.0, draws=tables)
    assert np.array_equal(out["actions"].numpy(), np.asarray(ref["actions"]))
    assert np.array_equal(out["assignment"].numpy(),
                          np.asarray(ref["assignment"]))
    for key in ("sel_logp", "plc_logp", "sel_ent", "plc_ent"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL)
    np.testing.assert_allclose(out["est_makespan"].numpy(),
                               np.asarray(ref["est_makespan"]), rtol=1e-6)


@pytest.mark.parametrize("gname,args,fleet,d_hidden", [
    ("synthetic_layered", (3, 4), "mixed_gen4", 16),
    ("chainmm", (), "p100x4", 32),
])
def test_sampled_eps_matches_sample_episodes(gname, args, fleet, d_hidden):
    gj, devj, jparams, gdj, params, gd = _setup(gname, args, fleet, d_hidden)
    keys, tables = _draws(gj, devj, seed=3)
    ref = sample_episodes(jparams, gdj, keys, jnp.float32(0.2))
    out = assign.rollout_batch(params, gd, K, 0.2, draws=tables)
    assert np.array_equal(out["actions"].numpy(), np.asarray(ref["actions"]))
    assert np.array_equal(out["assignment"].numpy(),
                          np.asarray(ref["assignment"]))
    # exploration actually fired: some steps left the policy's own pick
    u_sel = tables[2]
    assert (u_sel < 0.2).any()


def test_forced_replay_and_ablation_modes():
    """Forced replay reproduces a sampled episode's actions and log-probs;
    the CP / ETF ablation modes match the reference's rollout."""
    gj, devj, jparams, gdj, params, gd = _setup("synthetic_layered", (3, 4),
                                                "p100x4", 16)
    keys, tables = _draws(gj, devj)
    out = assign.rollout_batch(params, gd, K, 0.0, draws=tables)
    rep = assign.rollout_batch(params, gd, K, forced_actions=out["actions"])
    assert torch.equal(rep["actions"], out["actions"])
    assert torch.equal(rep["sel_logp"], out["sel_logp"])
    assert torch.equal(rep["plc_logp"], out["plc_logp"])
    for sel_mode, plc_mode in (("cp", "learned"), ("learned", "etf")):
        ref = jax_assign.rollout(jparams, gdj, jax.random.PRNGKey(0),
                                 jnp.float32(0.0),
                                 jnp.zeros((gj.n, 2), jnp.int32),
                                 jnp.array(False), greedy=True,
                                 sel_mode=sel_mode, plc_mode=plc_mode)
        got = assign.rollout(params, gd, greedy=True, sel_mode=sel_mode,
                             plc_mode=plc_mode)
        assert np.array_equal(got["actions"].numpy(),
                              np.asarray(ref["actions"]))


def test_generator_sampling_is_valid_and_reproducible():
    _, _, _, _, params, gd = _setup("chainmm", (), "p100x4", 16)
    runs = [assign.rollout_batch(params, gd, 4, 0.2,
                                 generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0]["actions"], runs[1]["actions"])
    for k in range(4):
        order = sorted(runs[0]["order"][k].tolist())
        assert order == list(range(gd.n))
    a = runs[0]["assignment"]
    assert ((a >= 0) & (a < gd.nd)).all()
    with pytest.raises(ValueError):
        assign.rollout_batch(params, gd, 2, 0.2)      # no draws, no generator


def test_device_features_sum_preds_in_order():
    # the reduction vertex of synthetic_layered(2, 16) has 16 preds, so
    # several share a device: their flops must add in pred order, as the
    # reference's segment_sum adds them, for the features to be bit-equal
    gj, devj, _, gdj, _, gd = _setup("synthetic_layered", (2, 16),
                                     "v100x8", 16)
    rng = np.random.default_rng(0)
    n, nd, k = gj.n, devj.n, 5
    v = np.full(k, n - 1)
    placed = rng.random((k, n)) < 0.9
    assigned = rng.integers(0, nd, (k, n))
    est_end = rng.random((k, n)).astype(np.float32)
    avail = rng.random((k, nd)).astype(np.float32)
    comp = rng.random((k, nd)).astype(np.float32) * 1e9
    got, _ = assign._device_features(
        gd, torch.from_numpy(v), torch.from_numpy(placed),
        torch.from_numpy(assigned), torch.from_numpy(est_end),
        torch.from_numpy(avail), torch.from_numpy(comp))
    for i in range(k):
        want, _ = jax_assign._device_features(
            gdj, int(v[i]), jnp.asarray(placed[i]),
            jnp.asarray(assigned[i], jnp.int32), jnp.asarray(est_end[i]),
            jnp.asarray(avail[i]), jnp.asarray(comp[i]))
        assert np.array_equal(got[i].numpy(), np.asarray(want))
