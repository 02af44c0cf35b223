"""The port's AdamW and LR schedules against ``repro.train.optim``.

Random float32 trees (made with numpy from a seed) go through both
optimizers for several steps; parameters, moments and the clipped norm
agree within 1e-7, and the schedules' float32 values within 1e-7 (most
bit for bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as jax_optim
from repro_torch.core.nn import tree_leaves, tree_map
from repro_torch.train import optim

TOL = 1e-7


def _tree(rng, scale=1.0):
    def leaf(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"a": {"w": leaf(5, 3), "b": leaf(3)},
            "layers": [{"w": leaf(4, 4), "b": leaf(4)}, {"w": leaf(2, 7)}],
            "z": leaf(1)}


def _to_torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(torch_tree, jax_tree, atol=TOL):
    got = [x.numpy() for x in tree_leaves(torch_tree)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("max_grad_norm,weight_decay,gscale", [
    (1.0, 0.0, 1.0),          # the trainer's setting, norm clipped
    (1.0, 0.0, 1e-3),         # below the norm: no clipping
    (None, 0.01, 1.0),        # no clipping, decoupled weight decay
])
def test_adamw_matches_reference(max_grad_norm, weight_decay, gscale):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    p_t, p_j = _to_torch(params), jax.tree_util.tree_map(jnp.asarray, params)
    s_t, s_j = optim.adamw_init(p_t), jax_optim.adamw_init(p_j)
    sched = optim.linear_schedule(3e-3, 1e-5, 10)
    sched_j = jax_optim.linear_schedule(3e-3, 1e-5, 10)
    for step in range(6):
        grads = _tree(rng, gscale)
        lr, lr_j = sched(step), sched_j(step)
        assert np.float32(lr) == np.float32(lr_j)
        p_t, s_t = optim.adamw_update(_to_torch(grads), s_t, p_t, lr,
                                      weight_decay=weight_decay,
                                      max_grad_norm=max_grad_norm)
        p_j, s_j = jax_optim.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads), s_j, p_j, lr_j,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        assert s_t.step == int(s_j.step) == step + 1
        _close(p_t, p_j)
        _close(s_t.mu, s_j.mu)
        _close(s_t.nu, s_j.nu)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    for scale in (1e-12, 1e-3, 1.0, 1e3):
        g = _tree(rng, scale)
        c_t, n_t = optim.clip_by_global_norm(_to_torch(g), 1.0)
        c_j, n_j = jax_optim.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), 1.0)
        np.testing.assert_allclose(float(n_t), float(n_j), rtol=1e-6)
        _close(c_t, c_j, atol=TOL * max(scale, 1.0))
    assert float(optim.global_norm(_to_torch(g))) == pytest.approx(
        float(jax_optim.global_norm(g)), rel=1e-6)


def test_schedules_match_reference_in_float32():
    cases = [(optim.linear_schedule(1e-4, 1e-7, 4000),
              jax_optim.linear_schedule(1e-4, 1e-7, 4000)),
             (optim.linear_schedule(0.2, 0.0, 200),
              jax_optim.linear_schedule(0.2, 0.0, 200)),
             (optim.linear_schedule(0.5, 0.1, 0),
              jax_optim.linear_schedule(0.5, 0.1, 0)),
             (optim.cosine_schedule(1e-3, 1e-5, 100, warmup=10),
              jax_optim.cosine_schedule(1e-3, 1e-5, 100, warmup=10)),
             (optim.cosine_schedule(3e-4, 0.0, 50),
              jax_optim.cosine_schedule(3e-4, 0.0, 50))]
    for ours, ref in cases:
        for step in (0, 1, 5, 9, 10, 11, 37, 49, 50, 99, 100, 150, 4000,
                     5000):
            got, want = ours(step), np.asarray(ref(step))
            assert isinstance(got, np.float32) and want.dtype == np.float32
            assert abs(float(got) - float(want)) <= TOL
    # the linear schedule (the trainer's lr and eps) is bit-equal
    for ours, ref in cases[:3]:
        for step in range(0, 4100, 37):
            assert ours(step) == np.asarray(ref(step))
    # float32, not float64: the trainer's eps at episode 0 is 0.2f
    assert optim.linear_schedule(0.2, 0.0, 10)(0) == np.float32(0.2)
