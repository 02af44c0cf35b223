"""The paper's baselines in the port against the JAX reference: GDP and
Placeto (``core/gdp.py``, ``core/placeto.py``) and the
EnumerativeOptimizer (``core/enumopt.py``).

GDP and Placeto train 3 episodes on the reference's draws: its trainer's
key chain (``_nk()`` once for the rollout, once for the gradient) turned
into the injected tables of each rollout, at eps 0 and at the reference's
eps0 (0.2 and 0.5).  Each episode: the sampled assignment equal to the
reference's rollout on its key, the reward bit-identical (the copied
``WCSimulator`` at ``seed=episode``), the loss within 1e-5 relative and
every gradient within 5e-6 of max(1, max|g|) of the reference's
``_gdp_grad`` / ``_placeto_grad`` on the port's pre-episode params, and
the params within lr / 100 of the reference's AdamW step on the port's
gradient (the A5a bars, ``tests/test_torch_train.py``).  At the end
history, best and reward statistics equal, params within 5e-3.
``enumerative_assignment`` is a numpy copy: bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_diamond
from repro.core import enumopt as jax_enumopt
from repro.core import gdp as jax_gdp
from repro.core import placeto as jax_placeto
from repro.core.devices import get_device_model as jax_fleet
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro.core.zero_shot import to_numpy_params
from repro.graphs import workloads as jax_workloads
from repro.train import optim as jax_optim
from repro_torch.core import enumopt, gdp, placeto
from repro_torch.core.devices import get_device_model, uniform_box
from repro_torch.core.nn import tree_leaves
from repro_torch.core.simulator import WCSimulator
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.optim import adamw_init
from test_torch_train import (assert_grads_close, assert_loss_close,
                              as_reference_tree, port_graph)

D_HIDDEN = 16
EPISODES = 3
KINDS = {"gdp": (jax_gdp.GDPTrainer, gdp.GDPTrainer, jax_gdp.gdp_rollout,
                 jax_gdp._gdp_grad),
         "placeto": (jax_placeto.PlacetoTrainer, placeto.PlacetoTrainer,
                     jax_placeto.placeto_rollout, jax_placeto._placeto_grad)}


def _graph(gname):
    gj = make_diamond() if gname == "diamond" else \
        jax_workloads.get_workload(gname)
    return gj, port_graph(gj)


def _fleet(fleet):
    if fleet == "dev4":
        return jax_uniform_box(4), uniform_box(4)
    return jax_fleet(fleet), get_device_model(fleet)


def baseline_pair(kind, gname, fleet, **kw):
    """(reference trainer, port trainer on the CPU) with the same
    params."""
    JT, PT = KINDS[kind][:2]
    (gj, g), (devj, dev) = _graph(gname), _fleet(fleet)
    jt = JT(gj, devj, seed=0, d_hidden=D_HIDDEN, **kw)
    pt = PT(g, dev, seed=0, d_hidden=D_HIDDEN, device="cpu", **kw)
    assert pt.encoder_backend == "torch"
    pt.params = params_from_numpy(to_numpy_params(jt.params))
    pt.opt_state = adamw_init(pt.params)
    return jt, pt


def reference_tables(kind, key, n: int, nd: int) -> list:
    """The injected tables of one rollout on the reference's key: GDP
    ``split(key, 3)`` -> gumbel (n, nd), randint (n,), uniform (n,);
    Placeto per step ``key, kd = split(key)``, ``k1, k2, k3 = split(kd,
    3)`` -> the same three, step-major."""
    if kind == "gdp":
        ks = jax.random.split(key, 3)
        return [np.array(jax.random.gumbel(ks[0], (n, nd))),
                np.array(jax.random.randint(ks[1], (n,), 0, nd)),
                np.array(jax.random.uniform(ks[2], (n,)))]
    gum, unif, u = [], [], []
    for _ in range(n):
        key, kd = jax.random.split(key)
        k1, k2, k3 = jax.random.split(kd, 3)
        gum.append(jax.random.gumbel(k1, (nd,)))
        unif.append(jax.random.randint(k2, (), 0, nd))
        u.append(jax.random.uniform(k3))
    return [np.array(jnp.stack(x)) for x in (gum, unif, u)]


def step_pair(kind, jt, pt):
    """One episode on each trainer, the port's on the reference's next
    draws, held against the reference's rollout, gradient and AdamW
    step on the port's pre-episode state."""
    rollout, grad = KINDS[kind][2:]
    key, k_roll = jax.random.split(jt.key)
    _, k_grad = jax.random.split(key)
    tables = reference_tables(kind, k_roll, jt.g.n, jt.dev.n)
    eps = jnp.float32(jt.eps(jt.episode))
    dummy = jnp.zeros(jt.g.n, jnp.int32)
    want = np.asarray(rollout(jt.params, jt.gd, jt.order, k_roll, eps,
                              dummy, jnp.array(False))["assignment"])
    params0, state0, episode0 = pt.params, pt.opt_state, pt.episode
    jt.train(1, JaxWCSimulator(jt.g, jt.dev, noise_sigma=0.05))
    pt.train(1, WCSimulator(pt.g, pt.dev, noise_sigma=0.05), draws=[tables])
    up = pt.last_update
    assert np.array_equal(up["actions"], want)
    assert pt.history == jt.history                # bit-identical rewards
    (adv,) = [up["advantages"]]

    def ref(tree):
        return as_reference_tree(tree, jt.params)
    l_ref, g_ref = grad(ref(params0), jt.gd, jt.order, k_grad,
                        jnp.asarray(want), jnp.float32(adv),
                        jnp.float32(jt.entropy_weight))
    assert_loss_close(up["loss"], l_ref)
    assert_grads_close(up["grads"], g_ref, scaled=True)
    lr = jt.lr(episode0)
    state = jax_optim.AdamState(jnp.int32(state0.step), ref(state0.mu),
                                ref(state0.nu))
    step, _ = jax_optim.adamw_update(ref(up["grads"]), state, ref(params0),
                                     lr)
    assert pt.opt_state.step == state0.step + 1
    assert_grads_close(pt.params, step, float(lr) / 100)
    moved = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(pt.params), tree_leaves(params0)))
    assert moved >= 0.5 * float(lr)
    return tables


@pytest.mark.parametrize("kind,gname,fleet,eps0", [
    ("gdp", "diamond", "dev4", 0.0),
    ("gdp", "diamond", "dev4", 0.2),
    ("gdp", "chainmm", "mixed_gen4", 0.2),
    ("placeto", "diamond", "dev4", 0.0),
    ("placeto", "diamond", "dev4", 0.5),
    ("placeto", "chainmm", "p100x4", 0.5),
])
def test_baseline_trainer_matches_reference(kind, gname, fleet, eps0):
    jt, pt = baseline_pair(kind, gname, fleet, eps0=eps0)
    fired = False
    for _ in range(EPISODES):
        tables = step_pair(kind, jt, pt)
        fired |= bool((tables[2] < jt.eps(jt.episode - 1)).any())
    assert fired == (eps0 > 0)                 # exploration was exercised
    assert pt.episode == jt.episode == EPISODES
    assert pt.best_time == jt.best_time
    assert np.array_equal(pt.best_assignment, jt.best_assignment)
    assert (pt._rsum, pt._rsq, pt._rcount) == (jt._rsum, jt._rsq,
                                               jt._rcount)
    assert_grads_close(pt.params, jt.params, 5e-3)
    assert set(pt.seconds) == {"sample", "reward", "replay_backward",
                               "adamw"}


@pytest.mark.parametrize("kind", ["gdp", "placeto"])
def test_baseline_greedy_and_forced_rollouts_match_reference(kind):
    """Greedy episodes decision-exact, log-probs and entropies within
    1e-5; a forced replay of a sampled episode returns its actions and
    log-probs."""
    jt, pt = baseline_pair(kind, "chainmm", "mixed_gen4")
    rollout = KINDS[kind][2]
    port_rollout = type(pt).rollout
    dummy = jnp.zeros(jt.g.n, jnp.int32)
    ref = rollout(jt.params, jt.gd, jt.order, jax.random.PRNGKey(0),
                  jnp.float32(0.0), dummy, jnp.array(False), greedy=True)
    out = port_rollout(pt.params, pt.gd, pt.order, greedy=True)
    assert np.array_equal(out["assignment"].numpy(),
                          np.asarray(ref["assignment"]))
    for key in ("logp", "ent"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5)
    gen = torch.Generator().manual_seed(3)
    sampled = port_rollout(pt.params, pt.gd, pt.order, 0.3, generator=gen)
    replay = port_rollout(pt.params, pt.gd, pt.order,
                          forced=sampled["assignment"])
    assert torch.equal(replay["assignment"], sampled["assignment"])
    assert torch.equal(replay["logp"], sampled["logp"])


def test_gdp_positions_are_the_reference_bits():
    assert np.array_equal(gdp._positions(37, 16),
                          np.asarray(jax_gdp._positions(37, 16)))


@pytest.mark.parametrize("kind", ["gdp", "placeto"])
def test_baseline_generator_sampling_is_reproducible(kind):
    """Without injected tables a trainer samples from its generator: two
    trainers of one seed give the same episodes, and the draws are
    valid."""
    runs = []
    for _ in range(2):
        _, pt = baseline_pair(kind, "diamond", "dev4")
        pt.train(2, WCSimulator(pt.g, pt.dev, noise_sigma=0.05))
        a = pt.best_assignment
        assert a.shape == (pt.g.n,) and ((a >= 0) & (a < pt.dev.n)).all()
        runs.append((pt.history, a))
    assert runs[0][0] == runs[1][0]
    assert np.array_equal(runs[0][1], runs[1][1])
    with pytest.raises(ValueError):
        type(pt).rollout(pt.params, pt.gd, pt.order, 0.2)   # no draws


@pytest.mark.parametrize("gname,fleet", [("diamond", "dev4"),
                                         ("chainmm", "mixed_gen4"),
                                         ("chainmm", "two_pod_2x2")])
def test_enumerative_assignment_bit_equal(gname, fleet):
    (gj, g), (devj, dev) = _graph(gname), _fleet(fleet)
    want = jax_enumopt.enumerative_assignment(gj, devj)
    got = enumopt.enumerative_assignment(g, dev)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ((got >= 0) & (got < dev.n)).all()
