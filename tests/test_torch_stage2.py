"""Stage II of the port against the JAX reference trainer on the
reference's draws (its key chain turned into the six injected tables of
``assign.rollout_batch``), at eps 0 and at eps 0.2 (whole sampled
trajectories, the explore branch included):

* ``train_rl`` over ``TorchWCEngine`` (the plain trip loop on the CPU)
  against ``train_rl`` over ``JaxOracleEngine``;
* ``stage2_sim_batched`` and the serial ``stage2_sim`` on the copied
  ``WCSimulator(noise_sigma=0.05)`` against the reference's simulator.

The trainers take one update a call.  Each update: rewards bit-identical,
the same sampled actions as the reference's rollout on its keys,
advantages bit-identical to the reference's arithmetic on its reward
statistics, and the step held against the reference's loss, gradient and
AdamW step on the port's pre-update state (``assert_step_matches_
reference``: loss 1e-5, gradient 5e-6, params lr / 100).  At the end the
bookkeeping (history, best, running reward statistics, episode counter)
equal, params within 5e-3 of the reference trainer's (its loop-vs-fused
bar, ``tests/test_train_fused.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import training as jax_training
from repro.core.engine import JaxOracleEngine, SimRewardEngine
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro.core import assign as jax_assign
from repro.core.train_fused import _episode_key_chain, _episode_rng_tables
from repro_torch.core import assign, training
from repro_torch.core.sim_torch import TorchWCEngine
from repro_torch.core.simulator import WCSimulator
from test_torch_train import (assert_params_close,
                              assert_step_matches_reference, before_step,
                              trainer_pair)

EPS0 = dict(eps0=0.0, eps1=0.0, total_episodes=200)
EPS02 = dict(eps0=0.2, eps1=0.0, total_episodes=200)
ATOL = 1e-5


def reference_draws(keys, n: int, nd: int) -> list:
    """The six step-major tables of the reference's non-fused ``rollout``
    on ``keys`` (K, 2): the fused sampler's four
    (``_episode_rng_tables``) and the explore gumbel rows of each pick's
    second key (``k2`` of ``split(kv, 3)`` / ``split(kd, 3)``: its
    ``categorical(k2, where(mask, 0, -inf))``)."""
    K = keys.shape[0]
    kvs, kds = _episode_key_chain(keys, n)

    def explore(ks, width):
        k2 = jax.vmap(lambda k: jax.random.split(k, 3)[1])(
            ks.reshape(-1, 2))
        return jax.vmap(lambda k: jax.random.gumbel(k, (width,)))(
            k2).reshape(n, K, width)
    return [np.array(x) for x in (*_episode_rng_tables(keys, n, nd),
                                  explore(kvs, n), explore(kds, nd))]


def _same_bookkeeping(pt, jt):
    assert pt.best_time == jt.best_time
    assert np.array_equal(pt.best_assignment, jt.best_assignment)
    assert pt.history == [training.EpisodeRecord(**vars(h))
                          for h in jt.history]
    assert pt.episode == jt.episode
    assert (pt._r_sum, pt._r_sqsum, pt._r_count) == (
        jt._r_sum, jt._r_sqsum, jt._r_count)


def step_pair(jt, pt, run_ref, run_port, K, reward=None):
    """One update on each trainer (``run_ref()``; ``run_port(draws)`` on
    the reference's next draws), the port's held against the reference's.

    The reference's next update draws with one ``_next_key`` split K ways
    (``reward`` None: the serial protocol, where the key itself samples
    and the next one goes to the loss); the six draw tables of those
    keys replay its sampling at any eps.  Its rewards are ``reward``'s (a
    reference engine's) on its sampled assignments, and its advantages
    its own arithmetic (``_batched_rl_update`` / ``_rl_episode``) on its
    reward statistics before the update."""
    serial = reward is None
    _, sub = jax.random.split(jt.key)
    keys = sub[None] if serial else jax.random.split(sub, K)
    draws = [reference_draws(keys, jt.g.n, jt.dev.n)]
    # keyword arguments as the reference trainer passes them, so that
    # its compiled functions are reused
    modes = dict(sel_mode=jt.sel_mode, plc_mode=jt.plc_mode,
                 encoder_backend=jt.encoder_backend)
    learned = dict(sel_learned=True, plc_learned=True,
                   encoder_backend=jt.encoder_backend)
    eps = jnp.float32(jt.eps_sched(jt.episode))
    if serial:                   # the reference's sample_assignment
        out = jax_training.rollout(
            jt.params, jt.gd, sub, eps, jt._dummy_actions, jnp.array(False),
            greedy=False, **modes)
        acts = np.array(out["actions"])[None]
    else:
        out = jax_training.rollout_batch(jt.params, jt.gd, keys, eps,
                                         **modes)
        acts = np.array(out["actions"])
    ts = None if serial else np.asarray(reward.exec_times(
        np.array(out["assignment"]), jt.episode))
    (mean, std), count = jt._baseline(), jt._r_count
    before = before_step(pt)
    want = run_ref()
    got = run_port(draws)
    assert got == want                        # bit-identical rewards
    if not serial:
        assert want == ts.tolist()
    got_acts = np.asarray(torch.as_tensor(pt.last_update["actions"]))
    assert np.array_equal(got_acts, acts[0] if serial else acts)
    ew = jnp.float32(jt.entropy_weight)
    if serial:
        adv = -want[0] - mean
        if jt.normalize_adv:
            adv = adv / (std + 1e-9)
        assert pt.last_update["advantages"] == adv

        def ref_loss_and_grad(p):
            return jax_training._pg_loss_and_grad(
                p, jt.gd, keys[0], jnp.asarray(acts[0]), jnp.float32(adv),
                ew, **learned)
    else:
        rs = -ts
        advs = rs - (mean if count else rs.mean())
        if jt.normalize_adv:
            advs = advs / (max(std, float(rs.std())) + 1e-9)
        advs = np.asarray(advs, np.float32)
        assert np.array_equal(pt.last_update["advantages"], advs)

        def ref_loss_and_grad(p):
            return jax_training._pg_loss_and_grad_batch(
                p, jt.gd, keys, jnp.asarray(acts), jnp.asarray(advs), ew,
                **learned)
    assert_step_matches_reference(pt, jt, before, ref_loss_and_grad)
    return got


@pytest.mark.parametrize("gname,fleet", [("diamond", "p100x4"),
                                         ("ffnn", "mixed_gen4")])
def test_train_rl_over_the_oracle_matches_reference(gname, fleet):
    """3 updates at K 4 over ``TorchWCEngine`` (its plain trip loop)
    against the reference's ``train_rl`` over ``JaxOracleEngine``."""
    jt, pt = trainer_pair(gname, fleet, **EPS0)
    jeng = JaxOracleEngine(jt.g, jt.dev)
    eng = TorchWCEngine(pt.g, pt.dev, backend="torch", device="cpu")
    for _ in range(3):
        step_pair(jt, pt,
                  lambda: jt.train_rl(jeng, 1, batch_size=4, stage="oracle"),
                  lambda d: pt.train_rl(eng, 1, batch_size=4,
                                        stage="oracle", draws=d),
                  K=4, reward=jeng)
    _same_bookkeeping(pt, jt)
    assert pt.episode == 12
    assert_params_close(pt, jt)
    assert set(pt.seconds) == {"sample", "oracle", "replay_backward",
                               "adamw"}


@pytest.mark.parametrize("sched", [EPS0, EPS02], ids=["eps0", "eps0.2"])
def test_stage2_sim_batched_matches_reference(sched):
    """``stage2_sim_batched`` on the copied ``WCSimulator(noise_sigma=
    0.05)``: the noisy reward stream bit-identical to the reference's, on
    both of its engines."""
    jt, pt = trainer_pair("diamond", "mixed_gen4", **sched)
    jsim = JaxWCSimulator(jt.g, jt.dev, noise_sigma=0.05)
    sim = WCSimulator(pt.g, pt.dev, noise_sigma=0.05)
    _, serial = trainer_pair("diamond", "mixed_gen4", **sched)
    for _ in range(3):
        draws = []

        def run_port(d):
            draws.append(d)
            return pt.stage2_sim_batched(1, sim=sim, batch_size=4, draws=d)
        want = step_pair(
            jt, pt, lambda: jt.stage2_sim_batched(1, sim=jsim, batch_size=4),
            run_port, K=4, reward=SimRewardEngine(jsim))
        assert serial.stage2_sim_batched(
            1, sim=sim, batch_size=4, sim_engine="serial",
            draws=draws[0]) == want
    _same_bookkeeping(pt, jt)
    assert_params_close(pt, jt)
    assert [h.stage for h in serial.history] == ["sim_batch"] * 3


@pytest.mark.parametrize("sched", [EPS0, EPS02], ids=["eps0", "eps0.2"])
def test_stage2_sim_serial_matches_reference(sched):
    """The per-episode protocol: K = 1 tables from the reference's key
    chain (one key to sample, one consumed by its loss)."""
    jt, pt = trainer_pair("diamond", "mixed_gen4", **sched)
    jsim = JaxWCSimulator(jt.g, jt.dev, noise_sigma=0.05)
    sim = WCSimulator(pt.g, pt.dev, noise_sigma=0.05)
    for _ in range(4):
        step_pair(jt, pt, lambda: jt.stage2_sim(1, sim=jsim),
                  lambda d: pt.stage2_sim(1, sim=sim, draws=d), K=1)
    _same_bookkeeping(pt, jt)
    assert_params_close(pt, jt)


@pytest.mark.parametrize("gname,fleet", [("diamond", "mixed_gen4"),
                                         ("ffnn", "p100x4")])
def test_rollout_eps_matches_reference_key_chain(gname, fleet):
    """Whole eps-0.2 episodes on the six tables of the reference's keys:
    ``rollout_batch`` against its ``rollout_batch`` and one episode
    against its ``rollout`` — the same actions, log-probs and entropies
    within 1e-5.  The fused sampler's four tables (the explore branch on
    the policy's gumbel rows) leave the reference's trajectory."""
    jt, pt = trainer_pair(gname, fleet)
    K, eps = 4, 0.2
    keys = jax.random.split(jax.random.PRNGKey(11), K)
    draws = reference_draws(keys, jt.g.n, jt.dev.n)
    assert (draws[2] < eps).any() and (draws[3] < eps).any()

    def same(out, ref):
        assert np.array_equal(out["actions"].numpy(),
                              np.asarray(ref["actions"]))
        assert np.array_equal(out["assignment"].numpy(),
                              np.asarray(ref["assignment"]))
        for key in ("sel_logp", "plc_logp", "sel_ent", "plc_ent"):
            np.testing.assert_allclose(out[key].numpy(),
                                       np.asarray(ref[key]), atol=ATOL)

    ref = jax_assign.rollout_batch(jt.params, jt.gd, keys, jnp.float32(eps))
    same(assign.rollout_batch(pt.params, pt.gd, K, eps, draws=draws), ref)
    one = jax_assign.rollout(jt.params, jt.gd, keys[0], jnp.float32(eps),
                             jnp.zeros((jt.g.n, 2), jnp.int32),
                             jnp.array(False))
    same(assign.rollout(pt.params, pt.gd, eps,
                        draws=[t[:, :1] for t in draws]), one)
    four = assign.rollout_batch(pt.params, pt.gd, K, eps, draws=draws[:4])
    assert not np.array_equal(four["actions"].numpy(),
                              np.asarray(ref["actions"]))
    with pytest.raises(ValueError):
        assign.rollout_batch(pt.params, pt.gd, K, eps, draws=draws[:5])
