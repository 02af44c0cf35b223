"""The port's fused Stage II entry point, ``stage2_fused``, against the
reference trainer's, over whole trajectories.

Eager on the CPU: the function a CUDA graph captures on the card runs
here as it is (``tests/test_torch_cuda.py`` holds the captured replay
against it).  Draws are the reference trainer's key chain (per update
``key, sub = split(key)``, its K episode keys split off ``sub``) turned
into injected tables, at eps 0.  The reference runs its XLA oracle and
encoder; the port its plain versions.  Bars: makespans bit-identical,
bookkeeping equal (episode counter, history, best, the reward count; the
reward sum within 1e-6 relative), params within 5e-3 at the end (the
reference's fused-vs-loop bar); over 6 updates at 3 a dispatch, a
remainder dispatch, the chunked engine against the monolithic one and
the reference's, and both ablations.  Step-by-step checks, Stage I and
the rest are in ``tests/test_torch_fused_steps.py``.
"""
import jax
import numpy as np
import pytest

from repro_torch.core import training
from repro_torch.core.nn import tree_leaves
from test_torch_fused import reference_draws
from test_torch_train import assert_params_close, trainer_pair

EPS0 = dict(eps0=0.0, eps1=0.0, total_episodes=200)


def key_chain_draws(jt, n_updates: int, K: int) -> list:
    """The draw tables of the reference trainer's next ``n_updates``
    fused updates of K episodes."""
    key, out = jt.key, []
    for _ in range(n_updates):
        key, sub = jax.random.split(key)
        out.append(reference_draws(jax.random.split(sub, K), jt.g.n,
                                   jt.dev.n))
    return out


def same_bookkeeping(pt, jt) -> None:
    assert pt.episode == jt.episode
    assert pt.history == [training.EpisodeRecord(**vars(h))
                          for h in jt.history]
    assert pt.best_time == jt.best_time
    assert np.array_equal(pt.best_assignment, jt.best_assignment)
    assert pt._r_count == jt._r_count
    assert pt._r_sum == pytest.approx(jt._r_sum, rel=1e-6)


def same_params(a, b, tol=5e-3) -> None:
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=tol)


# -------------------------------------------------------------- Stage II
@pytest.mark.parametrize("gname,fleet", [("diamond", "p100x4"),
                                         ("ffnn", "mixed_gen4")])
def test_stage2_fused_matches_reference(gname, fleet):
    """6 updates at K 4, 3 a dispatch."""
    jt, pt = trainer_pair(gname, fleet, **EPS0)
    draws = key_chain_draws(jt, 6, 4)
    want = jt.stage2_fused(6, batch_size=4, updates_per_dispatch=3)
    got = pt.stage2_fused(6, batch_size=4, updates_per_dispatch=3,
                          draws=draws)
    assert got == want                        # bit-identical makespans
    same_bookkeeping(pt, jt)
    assert pt.episode == 24 and [h.stage for h in pt.history] == [
        "sim_fused"] * 6
    assert_params_close(pt, jt)
    assert pt.opt_state.step == int(jt.opt_state.step) == 6
    assert len(pt.losses) == 6 and np.isfinite(pt.losses).all()
    assert set(pt.seconds) == {"updates"}


def test_stage2_fused_remainder_matches_reference():
    """5 updates at 2 a dispatch: the tail dispatch replays the same
    engine (one graph on the card) fewer times."""
    jt, pt = trainer_pair("diamond", "mixed_gen4", **EPS0)
    draws = key_chain_draws(jt, 5, 4)
    want = jt.stage2_fused(5, batch_size=4, updates_per_dispatch=2)
    got = pt.stage2_fused(5, batch_size=4, updates_per_dispatch=2,
                          draws=draws)
    assert len(got) == 20 and got == want
    same_bookkeeping(pt, jt)
    assert_params_close(pt, jt)
    assert sum(k[0] == "stage2" for k in pt._fused_cache) == 1


def test_stage2_fused_chunked_matches_monolithic_and_reference():
    """K 8 sampled and scored in chunks of 4, the gradient accumulated over
    chunks of 4: the monolithic engine's episodes, bit for bit, and the
    reference's chunked engine's."""
    jt, pt = trainer_pair("diamond", "p100x4", **EPS0)
    _, mono = trainer_pair("diamond", "p100x4", **EPS0)
    draws = key_chain_draws(jt, 2, 8)
    want = jt.stage2_fused(2, batch_size=8, updates_per_dispatch=2,
                           chunk_size=4, grad_chunk_size=4)
    got = pt.stage2_fused(2, batch_size=8, updates_per_dispatch=2,
                          chunk_size=4, grad_chunk_size=4, draws=draws)
    got_mono = mono.stage2_fused(2, batch_size=8, updates_per_dispatch=2,
                                 chunk_size=0, draws=draws)
    assert got == want == got_mono
    same_bookkeeping(pt, jt)
    assert_params_close(pt, jt)
    same_params(pt, mono)
    eng = next(e for k, e in pt._fused_cache.items() if k[0] == "stage2")
    assert (eng.sample_chunk, eng.grad_chunk) == (4, 4)
    with pytest.raises(ValueError, match="chunk_size"):
        pt.stage2_fused(1, batch_size=8, chunk_size=3)


@pytest.mark.parametrize("mode,head", [({"sel_mode": "cp"}, "sel_head"),
                                       ({"plc_mode": "etf"}, "plc_head1")])
def test_stage2_fused_ablations_match_reference(mode, head):
    jt, pt = trainer_pair("diamond", "mixed_gen4", **EPS0, **mode)
    draws = key_chain_draws(jt, 2, 4)
    want = jt.stage2_fused(2, batch_size=4, updates_per_dispatch=2)
    got = pt.stage2_fused(2, batch_size=4, updates_per_dispatch=2,
                          draws=draws)
    assert got == want
    same_bookkeeping(pt, jt)
    assert_params_close(pt, jt)
    # the heuristic-replaced policy's terms drop out of the loss
    assert all(float(g.abs().max()) == 0.0
               for g in tree_leaves(pt.last_update["grads"][head]))
