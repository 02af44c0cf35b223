"""Port training (Stage I imitation, Stage II REINFORCE) against the JAX
reference trainer on the same parameters and draws.

The reference runs with its "xla" backends (the plain twins of its Pallas
kernels); the port runs its plain versions on the CPU.  Parameters come
across with ``to_numpy_params`` -> ``params_from_numpy``; sampled episodes
are given, or (Stage II, ``tests/test_torch_stage2.py``) replay the
reference's key chain through the six injected draw tables of
``assign.rollout_batch``, which reproduce its non-fused sampling at any
eps.  So:

* the losses and gradients are held on GIVEN actions (sampled at eps 0
  and at eps 0.2): loss within 1e-5 relative, every gradient
  within 5e-6 (the reference's own fused-vs-replay bar), with the
  Table-3 gating;
* every step of a trajectory (Stage I here, Stage II in
  ``tests/test_torch_stage2.py``) is held against the reference's own
  functions on the port's pre-step state: the loss and gradient at the
  bars above (the gradient of max(1, max|g|)), and the parameters within lr / 100 of the reference's
  AdamW step on the port's gradient (``assert_step_matches_reference``);
* over the whole trajectory, losses at rtol 1e-3 / atol 1e-5 and params
  at atol 5e-3 against the reference trainer (its loop-vs-fused bars:
  AdamW's first steps move a parameter by ~lr * sign(g), so a gradient
  near zero may take either sign).  At lr 1e-4 that params bar alone
  would pass a step never taken; the per-step check does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_diamond
from repro.core import training as jax_training
from repro.core.devices import get_device_model as jax_fleet
from repro.core.heuristics import \
    critical_path_assignment as jax_critical_path
from repro.core.zero_shot import to_numpy_params
from repro.graphs import workloads as jax_workloads
from repro.train import optim as jax_optim
from repro_torch.core import training
from repro_torch.core.devices import get_device_model
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.heuristics import critical_path_assignment
from repro_torch.core.nn import tree_leaves
from repro_torch.models.convert import params_from_numpy

LOSS_TOL = 1e-5
GRAD_TOL = 5e-6
PARAM_TOL = 5e-3


def port_graph(gj) -> DataflowGraph:
    """The port's copy of a reference ``DataflowGraph`` (same vertices,
    same edge order)."""
    g = DataflowGraph(gj.name)
    for v in gj.vertices:
        g.add_vertex(v.kind, v.flops, v.out_bytes, v.meta_op, v.role,
                     v.label, v.out_shape)
    for s, d in gj.edges:
        g.add_edge(s, d)
    return g.freeze()


def reference_graph(gname):
    return make_diamond() if gname == "diamond" else \
        jax_workloads.get_workload(gname)


def trainer_pair(gname, fleet, d_hidden=16, **kw):
    """(reference trainer, port trainer on the CPU) with the same params."""
    gj = reference_graph(gname)
    jt = jax_training.DopplerTrainer(gj, jax_fleet(fleet), seed=0,
                                     d_hidden=d_hidden, **kw)
    pt = training.DopplerTrainer(port_graph(gj), get_device_model(fleet),
                                 seed=0, d_hidden=d_hidden, device="cpu",
                                 **kw)
    assert (pt.encoder_backend, pt.oracle_backend) == ("torch", "torch")
    pt.params = params_from_numpy(to_numpy_params(jt.params))
    return jt, pt


def assert_grads_close(g_port, g_ref, tol=GRAD_TOL, scaled=False):
    """Leaf by leaf within ``tol`` (``scaled``: of max(1, max|g|) over the
    whole reference gradient, whose size sets its rounding)."""
    got = tree_leaves(g_port)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(g_ref)]
    assert len(got) == len(want)
    if scaled:
        tol *= max(1.0, max(float(np.abs(b).max()) for b in want))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol)


def assert_params_close(pt, jt, tol=PARAM_TOL):
    assert_grads_close(pt.params, jt.params, tol)


def assert_loss_close(loss, l_ref, tol=LOSS_TOL):
    assert abs(float(loss) - float(l_ref)) <= tol * abs(float(l_ref))


def as_reference_tree(tree, like):
    """A port tree (params, grads, moments) as a jax tree shaped like
    ``like``."""
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jnp.asarray(np.array(x.detach().cpu())) for x in tree_leaves(tree)])


def before_step(pt):
    """What the port's next step starts from: params, AdamW state and
    episode counter (a step replaces them, nothing is updated in
    place)."""
    return pt.params, pt.opt_state, pt.episode


def assert_step_matches_reference(pt, jt, before, ref_loss_and_grad):
    """The step the port just took, held against the reference's own
    functions on the port's pre-step state ``before``: the loss and every
    gradient of ``ref_loss_and_grad(params)`` within LOSS_TOL / GRAD_TOL
    (of max(1, max|g|): the serial protocol's early advantages,
    normalised by a running std of ~1e-6, give gradients of ~1e2, whose
    rounding leaves ~1e-4 on a bias the softmax ignores), and the
    params within lr / 100 of the reference's ``adamw_update``
    on the port's gradient and AdamW state.  A step not applied, taken
    at another lr, or on a gradient of the wrong sign fails here."""
    params0, state0, episode0 = before

    def ref(tree):
        return as_reference_tree(tree, jt.params)

    l_ref, g_ref = ref_loss_and_grad(ref(params0))
    assert_loss_close(pt.last_update["loss"], l_ref)
    assert_grads_close(pt.last_update["grads"], g_ref, scaled=True)
    lr = jt.lr_sched(episode0)
    state = jax_optim.AdamState(jnp.int32(state0.step), ref(state0.mu),
                                ref(state0.nu))
    want, _ = jax_optim.adamw_update(ref(pt.last_update["grads"]), state,
                                     ref(params0), lr)
    assert pt.opt_state.step == state0.step + 1
    assert_grads_close(pt.params, want, float(lr) / 100)
    moved = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(pt.params), tree_leaves(params0)))
    assert moved >= 0.5 * float(lr)


# ------------------------------------------------------------ the losses
@pytest.mark.parametrize("gname,fleet,eps", [
    ("diamond", "p100x4", 0.0),
    ("diamond", "mixed_gen4", 0.2),
    ("ffnn", "p100x4", 0.2),
    ("ffnn", "mixed_gen4", 0.0),
])
def test_pg_loss_and_grad_batch_matches_reference(gname, fleet, eps):
    jt, pt = trainer_pair(gname, fleet)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    out = jax_training.rollout_batch(jt.params, jt.gd, keys,
                                     jnp.float32(eps))
    actions = np.array(out["actions"])
    advs = np.array([0.7, -1.3, 0.2, -0.4], np.float32)
    l_ref, g_ref = jax_training._pg_loss_and_grad_batch(
        jt.params, jt.gd, keys, out["actions"], jnp.asarray(advs),
        jnp.float32(1e-2))
    loss, grads = training._pg_loss_and_grad_batch(pt.params, pt.gd,
                                                   actions, advs, 1e-2)
    assert_loss_close(loss, l_ref)
    assert_grads_close(grads, g_ref)
    # every leaf gets a gradient from a full-policy loss, but the two
    # output biases a softmax ignores (0 up to rounding)
    shift_free = {id(grads[h]["layers"][-1]["b"])
                  for h in ("sel_head", "plc_head2")}
    assert all(bool((g != 0).any()) for g in tree_leaves(grads)
               if id(g) not in shift_free)

    if gname != "diamond":
        return
    # the single-episode loss is the batch loss at K = 1
    l1_ref, g1_ref = jax_training._pg_loss_and_grad(
        jt.params, jt.gd, keys[0], out["actions"][0], jnp.float32(0.7),
        jnp.float32(1e-2))
    l1, g1 = training._pg_loss_and_grad(pt.params, pt.gd, actions[0], 0.7,
                                        1e-2)
    assert_loss_close(l1, l1_ref)
    assert_grads_close(g1, g1_ref)


@pytest.mark.parametrize("flag,head", [("sel_learned", "sel_head"),
                                       ("plc_learned", "plc_head1")])
def test_pg_batch_ablation_gates_gradients(flag, head):
    """Table-3 modes: the heuristic-replaced policy's parameters get an
    exactly zero gradient, and the rest match the reference's."""
    jt, pt = trainer_pair("diamond", "p100x4")
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    out = jax_training.rollout_batch(jt.params, jt.gd, keys,
                                     jnp.float32(0.1))
    advs = np.ones(3, np.float32)
    l_ref, g_ref = jax_training._pg_loss_and_grad_batch(
        jt.params, jt.gd, keys, out["actions"], jnp.asarray(advs),
        jnp.float32(1e-2), **{flag: False})
    loss, grads = training._pg_loss_and_grad_batch(
        pt.params, pt.gd, np.array(out["actions"]), advs, 1e-2,
        **{flag: False})
    assert all(float(x.abs().max()) == 0.0 for x in tree_leaves(grads[head]))
    assert_loss_close(loss, l_ref)
    assert_grads_close(grads, g_ref)


@pytest.mark.parametrize("gname,fleet", [("diamond", "p100x4"),
                                         ("ffnn", "mixed_gen4")])
def test_imitation_loss_and_grad_matches_reference(gname, fleet):
    jt, pt = trainer_pair(gname, fleet)
    _, acts_ref = jax_critical_path(jt.g, jt.dev, seed=5,
                                    return_actions=True)
    _, acts = critical_path_assignment(pt.g, pt.dev, seed=5,
                                       return_actions=True)
    assert np.array_equal(acts, acts_ref)          # the teacher is a copy
    l_ref, g_ref = jax_training._imitation_loss_and_grad(
        jt.params, jt.gd, jax.random.PRNGKey(0), jnp.asarray(acts_ref))
    loss, grads = training._imitation_loss_and_grad(pt.params, pt.gd, acts)
    assert_loss_close(loss, l_ref)
    assert_grads_close(grads, g_ref)


# ------------------------------------------------------------- Stage I
@pytest.mark.parametrize("gname,fleet", [("diamond", "p100x4"),
                                         ("ffnn", "mixed_gen4")])
def test_stage1_imitation_matches_reference(gname, fleet):
    """6 episodes, one call each (episode i imitates the teacher at seed
    3 + i, as one call of 6 at seed 3 does), every step held against the
    reference's loss, gradient and AdamW step."""
    jt, pt = trainer_pair(gname, fleet, total_episodes=200)
    want, got = [], []
    for i in range(6):
        before = before_step(pt)
        want += jt.stage1_imitation(1, seed=3 + i)
        got += pt.stage1_imitation(1, seed=3 + i)
        acts = jnp.asarray(pt.last_update["actions"])
        assert_step_matches_reference(
            pt, jt, before, lambda p: jax_training._imitation_loss_and_grad(
                p, jt.gd, jax.random.PRNGKey(0), acts,
                encoder_backend=jt.encoder_backend))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert pt.episode == jt.episode == 6
    assert_params_close(pt, jt)
    assert pt.opt_state.step == int(jt.opt_state.step) == 6
    assert set(pt.seconds) == {"teacher", "replay", "backward", "adamw"}


def test_train_rl_serial_requires_batch_one():
    _, pt = trainer_pair("diamond", "p100x4")
    with pytest.raises(ValueError):
        pt.train_rl(lambda a: 1.0, 1, batch_size=2, serial=True)


def test_cuda_trainer_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        training.DopplerTrainer(port_graph(make_diamond()),
                                get_device_model("p100x4"), d_hidden=16)
