"""The port's LM training against the JAX reference on the CPU.

Every registry config, ``.reduced()`` (the families' code paths at tiny
widths) with params and compute in float32, on the reference's own
``init_params`` with every vector perturbed (so that each norm scale,
bias, ``A_log`` and ``dt_bias`` counts), carried across with
``params_from_numpy``; both packages train on ``SyntheticTokenStream``'s
batches, batch 2 x seq 24 (three SSM chunks of 8), seed 0.  Most of the
time is the reference's compiles (~5-20 s a config), so the ten configs
are split over four files, each under a minute: the dense ones here,
zamba2 in ``test_torch_lm_train_ssm.py``, xLSTM in
``test_torch_lm_train_xlstm.py``, the MoE and stub configs in
``test_torch_lm_train_families.py``; those import this file's parity
tests and ``pytest_generate_tests``, which runs them over each file's
own ``ARCHS``.

Bars (float32):
- ``ce`` and ``aux`` within LOSS_TOL (1e-5) relative, as the reference's
  own twin-to-twin losses (ROADMAP, parity);
- every gradient leaf within F32_TOL (1e-4) of the leaf's max-abs, the
  logits bar of ``tests/test_torch_lm.py``; the clipped step's grad norm
  within LOSS_TOL relative;
- after ``make_train_step`` (step 1, then step 2 resumed from the
  reference's params and ``AdamState`` through the converters): mu and
  nu within what the gradient bar lets through (``moment_bars``), and
  each param within ``param_bars``: lr / 100, plus what a gradient gap of
  the bar can move AdamW's step by, lr * 2 * gap / sqrt(v_hat), capped at
  2 lr (a flipped sign of a gradient under the bar).  So a step not
  taken, taken at another lr or with another sign fails wherever the
  gradient stands clear of its bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.train import optim as jax_optim
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import SyntheticTokenStream as JaxStream
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.nn import tree_leaves, value_and_grad
from repro_torch.models import steps, transformer
from repro_torch.models.common import IGNORE_ID, cross_entropy_loss
from repro_torch.models.convert import (adam_state_from_numpy,
                                        adam_state_to_numpy,
                                        params_from_numpy, params_to_numpy)
from repro_torch.train.data import DataConfig, SyntheticTokenStream
from repro_torch.train.optim import adamw_init, cosine_schedule

from test_torch_pretrain import one_thread_a_process  # noqa: F401

B, S = 2, 24
LOSS_TOL, F32_TOL = 1e-5, 1e-4
B1, B2, EPS = 0.9, 0.999, 1e-8
LR = (3e-4, 3e-5, 8, 1)        # cosine_schedule(lr0, lr_min, n, warmup)
ARCHS = ("gemma_2b", "phi4_mini_3p8b", "olmo_1b", "qwen1p5_110b")
F32 = dict(param_dtype="float32", compute_dtype="float32")


def configs(arch, **kw):
    cfg_j = dataclasses.replace(jax_get_config(arch).reduced(), **F32, **kw)
    cfg_t = dataclasses.replace(get_config(arch).reduced(), **F32, **kw)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    return cfg_j, cfg_t


def reference_params(cfg_j, seed=0):
    """The reference's init, every vector perturbed, as numpy leaves."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.3).astype(x.dtype)
        if x.ndim - 1 <= 1 and x.shape[-1] <= 512 else x,
        jax.tree_util.tree_map(np.asarray, jax_tf.init_params(
            cfg_j, jax.random.PRNGKey(seed))))


def batches(cfg_t, n, seed=0):
    """The first ``n`` batches of the port's stream, as numpy."""
    stream = SyntheticTokenStream(cfg_t, DataConfig(S, B, seed))
    return [stream.next_batch() for _ in range(n)]


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_port(batch):
    return {k: torch.from_numpy(v).to(torch.float32 if v.dtype == np.float32
                                      else torch.int64)
            for k, v in batch.items()}


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


class Run:
    """One config's reference run: loss and gradients at the params, and
    two train steps (the second on the next batch)."""

    def __init__(self, arch):
        self.cfg_j, self.cfg = configs(arch)
        self.params = reference_params(self.cfg_j)
        self.batches = batches(self.cfg, 2)
        jp, jb = to_jax(self.params), [to_jax(b) for b in self.batches]
        vg = jax.jit(jax.value_and_grad(jax_tf.lm_loss, has_aux=True),
                     static_argnums=1)
        (_, (ce, aux)), grads = vg(jp, self.cfg_j, jb[0])
        self.ce, self.aux = float(ce), float(aux)
        step = jax.jit(jax_steps.make_train_step(
            self.cfg_j, jax_optim.cosine_schedule(*LR)))
        p1, s1, m1 = step(jp, jax_optim.adamw_init(jp), jb[0], 1)
        p2, s2, m2 = step(p1, s1, jb[1], 2)
        _, grads2 = vg(p1, self.cfg_j, jb[1])      # step 2's gradient
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
        self.grads = [np_tree(grads), np_tree(grads2)]
        self.steps = [(np_tree(p1), np_tree(s1), np_tree(m1)),
                      (np_tree(p2), np_tree(s2), np_tree(m2))]


_RUNS = {}


def run_of(arch) -> Run:
    if arch not in _RUNS:
        _RUNS[arch] = Run(arch)
    return _RUNS[arch]


def assert_rel(got, want, tol, what=""):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (what, got, want)


def assert_leaves_close(got, want, tol):
    """Each leaf within ``tol`` of the reference leaf's max-abs."""
    a, b = leaves(params_to_numpy(got)), leaves(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape
        bar = tol * float(np.abs(y).max())
        assert float(np.abs(x - y).max()) <= bar, (i, x.shape)


def clipped_grad_bar(metrics, grads_ref) -> list:
    """Per leaf: what the gradient and grad-norm bars let a clipped
    gradient differ by."""
    scale = min(1.0, 1.0 / max(float(metrics["grad_norm"]), 1e-9))
    return [(F32_TOL + LOSS_TOL) * scale * float(np.abs(g).max())
            for g in leaves(grads_ref)]


def moment_bars(gap, g_max):
    """mu moves by (1 - b1) g, nu by (1 - b2) g^2: a gradient gap ``gap``
    moves them by at most (1 - b1) gap and (1 - b2) (2 |g| gap + gap^2)
    (1% for their own rounding)."""
    return ((1 - B1) * gap * 1.01,
            (1 - B2) * (2 * g_max * gap + gap * gap) * 1.01)


def param_bars(gap, nu_ref, count, lr):
    """Elementwise: lr / 100, plus lr * 2 * gap / sqrt(v_hat) capped at
    2 lr (AdamW's step lr * m_hat / (sqrt(v_hat) + eps) moved by a
    gradient gap of ``gap``; the cap: a flipped sign)."""
    v_hat = nu_ref / (1 - B2 ** count)
    return lr / 100 + lr * np.minimum(2.0, 2 * gap / (np.sqrt(v_hat) + EPS))


def assert_step_close(params, opt, metrics, want, grads_ref, count, lr):
    """The port's step ``count`` against the reference's: metrics, the
    AdamW state and the params at the bars above."""
    p_ref, s_ref, m_ref = want
    assert_rel(metrics["loss"], m_ref["loss"], LOSS_TOL, "ce")
    assert_rel(metrics["aux_loss"], m_ref["aux_loss"], LOSS_TOL, "aux")
    assert_rel(metrics["grad_norm"], m_ref["grad_norm"], LOSS_TOL, "norm")
    assert float(metrics["lr"]) == float(m_ref["lr"]) == np.float32(lr)
    assert opt.step == int(s_ref.step) == count
    gaps = clipped_grad_bar(m_ref, grads_ref)
    port = [leaves(params_to_numpy(t)) for t in (params, opt.mu, opt.nu)]
    ref = [leaves(t) for t in (p_ref, s_ref.mu, s_ref.nu)]
    for i, (gap, g) in enumerate(zip(gaps, leaves(grads_ref))):
        (p, mu, nu), (pr, mur, nur) = [x[i] for x in port], \
            [x[i] for x in ref]
        bar_mu, bar_nu = moment_bars(gap, float(np.abs(g).max()))
        assert float(np.abs(mu - mur).max()) <= bar_mu, ("mu", i)
        assert float(np.abs(nu - nur).max()) <= bar_nu, ("nu", i)
        assert (np.abs(p - pr) <= param_bars(gap, nur, count, lr)).all(), \
            ("params", i, float(np.abs(p - pr).max()))


def port_grads(cfg, params, batch, **kw):
    return value_and_grad(lambda p: transformer.lm_loss(p, cfg, batch, **kw),
                          params, has_aux=True)


# ------------------------------------------------------------- the configs
def pytest_generate_tests(metafunc):
    """``arch`` over the ARCHS of the module the test is collected in."""
    if "arch" in metafunc.fixturenames:
        metafunc.parametrize("arch", metafunc.module.ARCHS)


def test_loss_and_grads_match_reference(arch):
    run = run_of(arch)
    (loss, (ce, aux)), grads = port_grads(
        run.cfg, params_from_numpy(run.params), to_port(run.batches[0]))
    assert_rel(ce, run.ce, LOSS_TOL, "ce")
    assert_rel(aux, run.aux, LOSS_TOL, "aux")
    assert_rel(loss, run.ce + 0.01 * run.aux, LOSS_TOL, "loss")
    assert_leaves_close(grads, run.grads[0], F32_TOL)


def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step from fresh AdamW state at step 1 (the
    schedule's first step past its warm-up)."""
    run = run_of(arch)
    step = steps.make_train_step(run.cfg, cosine_schedule(*LR))
    p0 = params_from_numpy(run.params)
    params, opt, metrics = step(p0, adamw_init(p0), to_port(run.batches[0]),
                                1)
    assert_step_close(params, opt, metrics, run.steps[0], run.grads[0], 1,
                      cosine_schedule(*LR)(1))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(params), tree_leaves(p0)))
    assert moved >= 0.5 * LR[0]


def test_resumed_step_matches_reference(arch):
    """Step 2 from the reference's params and AdamW state after step 1,
    carried across with the converters (and back, bit-equal)."""
    run = run_of(arch)
    p1, s1, _ = run.steps[0]
    opt = adam_state_from_numpy(s1)
    back = adam_state_to_numpy(opt)
    assert back[0] == s1.step and back[0].dtype == np.int32
    assert all(np.array_equal(a, b) for a, b in
               zip(leaves(back[1:]), leaves((s1.mu, s1.nu))))
    step = steps.make_train_step(run.cfg, cosine_schedule(*LR))
    params, opt, metrics = step(params_from_numpy(p1), opt,
                                to_port(run.batches[1]), 2)
    assert_step_close(params, opt, metrics, run.steps[1], run.grads[1], 2,
                      cosine_schedule(*LR)(2))


def test_eval_step_matches_reference(arch):
    run = run_of(arch)
    got = steps.make_eval_step(run.cfg)(params_from_numpy(run.params),
                                        to_port(run.batches[0]))
    assert not got["loss"].requires_grad
    assert_rel(got["loss"], run.ce, LOSS_TOL, "ce")
    assert_rel(got["aux_loss"], run.aux, LOSS_TOL, "aux")


# ---------------------------------------------------------------- the rest
def test_remat_gives_the_same_loss_and_grads():
    """``remat`` (activation checkpointing around each repetition of the
    unit) recomputes the forward in the backward pass: the same loss and
    gradients as without it, and twice the unit's forward work."""
    _, cfg = configs("zamba2_1p2b", n_layers=8)
    params = params_from_numpy(reference_params(configs(
        "zamba2_1p2b", n_layers=8)[0]))
    batch = to_port(batches(cfg, 1)[0])
    calls = []
    real = transformer._ssm_block_apply

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        calls.clear()
        transformer._ssm_block_apply = counted
        try:
            out[remat] = port_grads(c, params, batch)
        finally:
            transformer._ssm_block_apply = real
        out[remat] += (len(calls),)
    (va, ga, na), (vb, gb, nb) = out[False], out[True]
    assert float(va[0]) == pytest.approx(float(vb[0]), rel=1e-6)
    assert_leaves_close(gb, params_to_numpy(ga), 1e-6)
    unit, reps, rem = transformer.unit_and_reps(cfg)
    n_unit = reps * sum(k != "attn_shared" for k in unit)
    assert (na, nb) == (n_unit + len(rem), 2 * n_unit + len(rem))


def test_remat_policy_dots_raises():
    _, cfg = configs("olmo_1b", remat=True, remat_policy="dots")
    p = transformer.init_params(cfg, 0, device="cpu")
    batch = to_port(batches(cfg, 1)[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.lm_loss(p, cfg, batch)
    with torch.no_grad():            # no backward: nothing to checkpoint
        transformer.lm_loss(p, cfg, batch)


def test_train_mode_gives_every_leaf_a_gradient():
    """``model_apply(mode="train")`` on the "torch" backends: every
    parameter leaf of reduced zamba2 (the shared attention, the stacked
    unit, the remainder, the tied embedding) gets a nonzero gradient."""
    _, cfg = configs("zamba2_1p2b", n_layers=8)
    params = transformer.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(batches(cfg, 1)[0]["tokens"]).long()

    def loss(p):
        logits, _, _ = transformer.model_apply(
            p, cfg, {"tokens": tokens}, mode="train", attn_backend="torch",
            ssm_backend="torch")
        return logits.square().mean()
    _, grads = value_and_grad(loss, params)
    flat = tree_leaves(grads)
    assert len(flat) == len(tree_leaves(params)) > 10
    assert all(bool(g.abs().max() > 0) for g in flat)


def test_cross_entropy_every_label_ignored():
    """The denominator is floored at 1: every label ignored gives 0, and a
    zero gradient, in both packages."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = np.full((2, 5), IGNORE_ID, np.int32)
    want = jax.value_and_grad(lambda x: jax_tf.cross_entropy_loss(
        x, jnp.asarray(labels), IGNORE_ID))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy_loss(x, torch.from_numpy(labels))
    got.backward()
    assert float(got.detach()) == float(want[0]) == 0.0
    assert float(x.grad.abs().max()) == float(np.abs(want[1]).max()) == 0.0
    labels[0, 1:3] = (3, 6)                   # two counted
    want = jax_tf.cross_entropy_loss(jnp.asarray(logits),
                                     jnp.asarray(labels), IGNORE_ID)
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    assert_rel(got, want, LOSS_TOL)


def test_vision_stub_patch_positions_are_ignored():
    """paligemma: the logits cover patches + tokens, the labels the tokens;
    the patches' positions are prepended as ignored, so the loss is the
    cross-entropy over the text positions alone."""
    _, cfg = configs("paligemma_3b")
    params = transformer.init_params(cfg, 0, device="cpu")
    batch = to_port(batches(cfg, 1)[0])
    assert batch["patches"].shape == (B, cfg.n_patches, cfg.d_model)
    with torch.no_grad():
        logits, _, _ = transformer.model_apply(params, cfg, batch)
        _, (ce, _) = transformer.lm_loss(params, cfg, batch)
    assert logits.shape[1] == cfg.n_patches + S
    text = cross_entropy_loss(logits[:, cfg.n_patches:], batch["labels"])
    assert float(ce) == float(text)


def test_token_stream_matches_reference():
    """Batch for batch equal to the reference's stream at steps 0, 1 and
    17 and after ``restore``; torch tensors on a device when asked."""
    for arch in ("olmo_1b", "musicgen_large", "paligemma_3b"):
        cfg_j, cfg = configs(arch)
        mine = SyntheticTokenStream(cfg, DataConfig(S, B, seed=3))
        ref = JaxStream(cfg_j, JaxDataConfig(S, B, seed=3))

        def same(a, b):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        for step in (0, 1):
            same(mine.next_batch(), ref.next_batch())
        assert mine.skip_ahead(17) == ref.skip_ahead(17) == 15
        same(mine.next_batch(), ref.next_batch())
        mine.restore({"step": 1})
        ref.restore(ref.state() | {"step": 1})
        same(mine.next_batch(), ref.next_batch())
        assert mine.state() == ref.state() == {"step": 2}
        on = SyntheticTokenStream(cfg, DataConfig(S, B, seed=3), device="cpu")
        first = on.next_batch()
        mine.restore({"step": 0})
        for k, v in mine.next_batch().items():
            assert isinstance(first[k], torch.Tensor)
            assert first[k].dtype == (torch.float32 if v.dtype == np.float32
                                      else torch.int64)
            assert np.array_equal(first[k].numpy(), v)


def test_every_registry_config_is_held():
    import test_torch_lm_train_families as moe_stubs
    import test_torch_lm_train_ssm as ssm
    import test_torch_lm_train_xlstm as xlstm
    assert sorted(ARCHS + ssm.ARCHS + xlstm.ARCHS + moe_stubs.ARCHS) == \
        sorted(ARCH_IDS)
