"""The port's fused losses (``repro_torch.core.train_fused``) against
``repro.core.train_fused`` on the same recordings.

Recordings are the reference's ``sample_episodes`` / reduced
``_sample_scan`` on its keys (at eps 0.2), carried over as tensors;
parameters come across with ``to_numpy_params`` -> ``params_from_numpy``.
Bars:

* ``fused_pg_loss`` and ``_reduced``: loss within 1e-5 relative and
  gradients within 5e-6 of the JAX losses on the same recordings, and
  1e-4 relative / 5e-6 against the port's forced replay
  ``_pg_loss_and_grad_batch`` (the reference's own fused-vs-replay bars),
  a policy left out (Table 3) with an exactly zero gradient;
* the reduced loss's gradient accumulated over equal chunks within 1e-6
  of the whole batch's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import train_fused as jax_fused
from repro_torch.core import train_fused, training
from repro_torch.core.assign import encode
from repro_torch.core.nn import tree_leaves, tree_map
from test_torch_fused import as_port, reference_draws
from test_torch_train import (GRAD_TOL, assert_grads_close,
                              assert_loss_close, trainer_pair)

CHUNK_TOL = 1e-6


# ------------------------------------------------------------ the losses
def _recorded(gname, fleet, K, seed, eps=0.0):
    jt, pt = trainer_pair(gname, fleet)
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    rec = jax_fused.sample_episodes(jt.params, jt.gd, keys, jnp.float32(eps))
    return jt, pt, keys, rec


@pytest.mark.parametrize("gname,fleet,learned", [
    ("diamond", "p100x4", {}), ("ffnn", "mixed_gen4", {}),
    ("ffnn", "p100x4", {"sel_learned": False}),
    ("diamond", "mixed_gen4", {"plc_learned": False})])
def test_fused_pg_loss_matches_reference(gname, fleet, learned):
    """The full and reduced losses on the reference's recordings against
    the JAX losses on the same recordings, and against the port's forced
    replay of the same actions; a policy left out gets a zero gradient."""
    jt, pt, keys, rec = _recorded(gname, fleet, 4, 1, eps=0.2)
    advs = np.array([0.5, -0.3, 1.2, -0.8], np.float32)
    ew = 1e-2
    l_ref, g_ref = jax.value_and_grad(jax_fused.fused_pg_loss)(
        jt.params, jt.gd, rec, jnp.asarray(advs), jnp.float32(ew), **learned)
    loss, grads = training._value_and_grad(
        lambda p: train_fused.fused_pg_loss(p, pt.gd, as_port(rec),
                                            torch.from_numpy(advs), ew,
                                            **learned), pt.params)
    assert_loss_close(loss, l_ref)
    assert_grads_close(grads, g_ref)
    l_rep, g_rep = training._pg_loss_and_grad_batch(
        pt.params, pt.gd, np.array(rec["actions"]), advs, ew, **learned)
    assert abs(float(loss) - float(l_rep)) <= 1e-4 * abs(float(l_rep))
    for a, b in zip(tree_leaves(grads), tree_leaves(g_rep)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=GRAD_TOL)
    for flag, head in (("sel_learned", "sel_head"),
                       ("plc_learned", "plc_head1")):
        if flag in learned:
            assert all(float(x.abs().max()) == 0.0
                       for x in tree_leaves(grads[head]))

    # the reduced recordings of the same keys
    jenc = jax_fused.episode_encodings(jt.params, jt.gd.x, jt.gd.edges,
                                       jt.gd.edge_feat, jt.gd.b_path,
                                       jt.gd.t_path)
    red = jax_fused._sample_scan(jt.params, jt.gd, keys, jnp.float32(0.2),
                                 "learned", "learned", jenc, "reduced")
    l_red_ref, g_red_ref = jax.value_and_grad(
        jax_fused.fused_pg_loss_reduced)(jt.params, jt.gd, red,
                                         jnp.asarray(advs), jnp.float32(ew),
                                         **learned)
    l_red, g_red = training._value_and_grad(
        lambda p: train_fused.fused_pg_loss_reduced(
            p, pt.gd, as_port(red), torch.from_numpy(advs), ew, **learned),
        pt.params)
    assert_loss_close(l_red, l_red_ref)
    assert_grads_close(g_red, g_red_ref)
    assert abs(float(l_red) - float(l_rep)) <= 1e-4 * abs(float(l_rep))


def test_chunked_gradient_parity():
    """The reduced loss's gradient accumulated over four equal chunks ==
    the whole batch's, to 1e-6 (the mean of chunk means is the batch
    mean: what the chunked update relies on)."""
    jt, pt = trainer_pair("diamond", "p100x4")
    keys = jax.random.split(jax.random.PRNGKey(4), 16)
    draws = [torch.from_numpy(x) for x in
             reference_draws(keys, jt.g.n, jt.dev.n)]
    enc = encode(pt.params, pt.gd)
    rec = train_fused._sample_scan(pt.params, pt.gd, draws,
                                   torch.tensor(0.0), "learned", "learned",
                                   enc, "reduced")
    advs = torch.linspace(-1.0, 1.0, 16)

    def grad(r, a):
        return training._value_and_grad(
            lambda p: train_fused.fused_pg_loss_reduced(p, pt.gd, r, a, 1e-2),
            pt.params)[1]
    g_full = grad(rec, advs)
    gc = 4
    g_sum = None
    for c in range(16 // gc):
        sl = slice(c * gc, (c + 1) * gc)
        g_c = grad({k: v[sl] for k, v in rec.items()}, advs[sl])
        g_sum = g_c if g_sum is None else tree_map(torch.add, g_sum, g_c)
    for a, b in zip(tree_leaves(g_full), tree_leaves(g_sum)):
        np.testing.assert_allclose((b / (16 // gc)).numpy(), a.numpy(),
                                   rtol=0, atol=CHUNK_TOL)
