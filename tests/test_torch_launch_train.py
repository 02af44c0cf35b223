"""The port's LM training driver (``repro_torch.launch.train``) and int8
gradient compression (``repro_torch.train.compression``) against the JAX
reference's, on the CPU.

Both drivers run in-process on reduced olmo-1b (2 layers, d_model 64),
``get_config`` patched in each driver's module to the fp32-compute
config (the parameters are fp32 already), batch 2 x seq 16, 6 steps, a
checkpoint every 2 (so steps 2, 4 and the final 5 are kept).

- Unbroken against resumed, in the port: steps 4 and 5 deleted, the run
  again resumes from 2; the two final ``arrays.msgpack`` are the same
  bytes.
- Across the packages, each way: one driver writes step 2, the other
  resumes it to step 5.  The result is held against the first driver's
  unbroken run at ``tests/test_torch_lm_train.py``'s step bars,
  summed over the three resumed steps: each step may move a parameter by
  lr / 100 plus what a gradient gap of (1e-4 + 1e-5) of the leaf's max
  (the two packages' gradient bar, after clipping) can move AdamW's step
  by, and the moments by what that gap moves them by.  The bars' gradients
  and second moments come from replaying the unbroken run's three steps
  in the port from its step-2 checkpoint.  The stream is at the same
  batch (step 6) in both, and the printed losses agree at their 4
  decimals.
- Compression: codes and scales bit-equal to the reference's jitted
  ``int8_quantize`` (its scale is max|x| times the float32 reciprocal of
  127, the form XLA compiles; see the module), the tree transform and
  three error-feedback steps likewise; one ``make_train_step`` step
  through the transform against the reference's jitted step at the step
  bars, the gradient gap widened by one int8 step where the reference's
  clipped gradient lies within the gap of a rounding boundary.
"""
import contextlib
import dataclasses
import io
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.train as jax_train
from repro.configs.registry import get_config as jax_get_config
from repro.models import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.train import compression as jax_comp
from repro.train import optim as jax_optim
from repro_torch.configs.registry import get_config
from repro_torch.core.nn import tree_leaves, value_and_grad
from repro_torch.launch import train as port_train
from repro_torch.models import steps, transformer
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train import compression
from repro_torch.train.checkpoint import read_manifest, restore_checkpoint
from repro_torch.train.data import DataConfig, SyntheticTokenStream
from repro_torch.train.optim import (AdamState, adamw_init,
                                     clip_by_global_norm, cosine_schedule)

from test_torch_lm_train import (B1, F32_TOL, LOSS_TOL, batches, configs,
                                 moment_bars, param_bars, reference_params,
                                 to_port)
from test_torch_pretrain import one_thread_a_process  # noqa: F401

ARCH, STEPS, EVERY, BATCH, SEQ, LR = "olmo_1b", 6, 2, 2, 16, 3e-4
RESUME = 2
ARGV = ["--arch", ARCH, "--reduced", "--steps", str(STEPS), "--batch",
        str(BATCH), "--seq", str(SEQ), "--ckpt-every", str(EVERY),
        "--log-every", "1", "--lr", str(LR)]


def fp32(get):
    return lambda arch: dataclasses.replace(get(arch),
                                            compute_dtype="float32")


def run_port(ckpt_dir, *extra):
    """The port's driver in-process on the CPU; -> (result, stdout)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(port_train, "get_config", fp32(get_config))
        res = port_train.main([*ARGV, "--device", "cpu", "--ckpt-dir",
                               str(ckpt_dir), *extra])
    return res, out.getvalue()


def run_reference(ckpt_dir):
    """The reference's driver in-process (it reads ``sys.argv``); ->
    stdout."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jax_train, "get_config", fp32(jax_get_config))
        mp.setattr(sys, "argv", ["repro.launch.train", *ARGV, "--ckpt-dir",
                                 str(ckpt_dir)])
        jax_train.main()
    return out.getvalue()


def cut_to(src, dst, step):
    """A copy of checkpoint dir ``src`` with every step after ``step``
    deleted."""
    shutil.copytree(src, dst)
    for d in dst.glob("step_*"):
        if int(d.name.split("_")[1]) > step:
            shutil.rmtree(d)
    return dst


def losses(stdout) -> dict:
    """{step: loss} of the "step N loss ..." lines."""
    out = {}
    for line in stdout.splitlines():
        parts = line.split()
        if parts[:1] == ["step"] and parts[2] == "loss":
            out[int(parts[1])] = float(parts[3])
    return out


def cfg_t():
    return dataclasses.replace(get_config(ARCH).reduced(),
                               compute_dtype="float32")


def load(ckpt_dir, step):
    """Checkpoint ``step`` as the port's (params, AdamState) on the CPU."""
    like = transformer.init_params(cfg_t(), 0, device="cpu")
    (params, opt), extra = restore_checkpoint(
        ckpt_dir, step, (like, port_train._as_saved(adamw_init(like))))
    assert opt.step.dtype == torch.int32 and opt.step.dim() == 0
    return params, AdamState(int(opt.step), opt.mu, opt.nu), extra


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unbroken runs of both drivers."""
    root = tmp_path_factory.mktemp("train")
    port, port_out = run_port(root / "port")
    ref_out = run_reference(root / "ref")
    return {"root": root, "port": port, "port_out": port_out,
            "ref_out": ref_out}


def step_bars(ckpt_dir):
    """Replay steps RESUME + 1 .. STEPS - 1 of the run in ``ckpt_dir``
    from its step-RESUME checkpoint in the port; -> per leaf the summed
    bars on (params, mu, nu) after the last step."""
    cfg = cfg_t()
    params, opt, extra = load(ckpt_dir, RESUME)
    data = SyntheticTokenStream(cfg, DataConfig(SEQ, BATCH, 0), "cpu")
    data.restore(extra["data"])
    sched = cosine_schedule(LR, LR * 0.1, STEPS, warmup=max(STEPS // 20, 1))
    step_fn = steps.make_train_step(cfg, sched)
    total = None
    for step in range(RESUME + 1, STEPS):
        batch = data.next_batch()
        _, grads = value_and_grad(
            lambda p: transformer.lm_loss(p, cfg, batch), params,
            has_aux=True)
        _, gnorm = clip_by_global_norm(grads, 1.0)
        scale = min(1.0, 1.0 / max(float(gnorm), 1e-9))
        params, opt, _ = step_fn(params, opt, batch, step)
        bars = []
        for g, nu in zip(tree_leaves(grads), tree_leaves(opt.nu)):
            g_max = float(g.abs().max())
            gap = (F32_TOL + LOSS_TOL) * scale * g_max
            bar_mu, bar_nu = moment_bars(gap, g_max)
            bars.append([param_bars(gap, nu.numpy(), opt.step,
                                    sched(step)), bar_mu, bar_nu])
        total = bars if total is None else [
            [a + b for a, b in zip(x, y)] for x, y in zip(total, bars)]
    return total


def assert_within_step_bars(got_dir, want_dir):
    """Checkpoint STEPS - 1 of ``got_dir`` against ``want_dir``'s: the
    same structure, the AdamW count, the stream's step, and every
    parameter and moment within the summed step bars."""
    gp, go, gx = load(got_dir, STEPS - 1)
    wp, wo, wx = load(want_dir, STEPS - 1)
    assert gx == wx == {"data": {"step": STEPS}}
    assert int(go.step) == int(wo.step) == STEPS
    bars = step_bars(want_dir)
    trees = [(gp, wp), (go.mu, wo.mu), (go.nu, wo.nu)]
    for kind, (got, want) in enumerate(trees):
        for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
            diff = (a - b).abs().numpy()
            assert (diff <= bars[i][kind]).all(), (kind, i, float(diff.max()))


def assert_same_lines(resumed_out, unbroken_out):
    assert resumed_out.splitlines()[0] == f"resumed from step {RESUME}"
    assert resumed_out.splitlines()[-1] == "done"
    got, want = losses(resumed_out), losses(unbroken_out)
    assert sorted(got) == list(range(RESUME + 1, STEPS))
    for s, loss in got.items():
        assert abs(loss - want[s]) <= 5e-5 + LOSS_TOL * abs(want[s]), s


# --------------------------------------------------------------- resume
def test_port_resume_is_bit_equal_to_its_unbroken_run(runs):
    root = runs["root"]
    assert sorted(p.name for p in (root / "port").glob("step_*")) == [
        "step_000000002", "step_000000004", "step_000000005"]
    res, out = run_port(cut_to(root / "port", root / "port_resumed",
                               RESUME))
    assert res.start == RESUME + 1 and len(res.metrics) == STEPS - RESUME - 1
    assert_same_lines(out, runs["port_out"])
    last = f"step_{STEPS - 1:09d}"
    for name in ("arrays.msgpack",):
        assert (root / "port_resumed" / last / name).read_bytes() == \
            (root / "port" / last / name).read_bytes()
    assert read_manifest(root / "port_resumed", STEPS - 1)["extra"] == \
        read_manifest(root / "port", STEPS - 1)["extra"]
    # the final state in memory is the checkpoint's
    params, opt, _ = load(root / "port", STEPS - 1)
    assert opt.step == res.opt_state.step == STEPS
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(res.params)))


def test_port_resumes_a_reference_checkpoint(runs):
    root = runs["root"]
    assert sorted(p.name for p in (root / "ref").glob("step_*")) == [
        "step_000000002", "step_000000004", "step_000000005"]
    manifest = read_manifest(root / "ref", RESUME)
    n = len(tree_leaves(load(root / "ref", RESUME)[0]))
    assert manifest["index"][n] == {"key": f"arr_{n:05d}", "shape": [],
                                    "dtype": "int32"}
    _, out = run_port(cut_to(root / "ref", root / "ref_to_port", RESUME))
    assert_same_lines(out, runs["ref_out"])
    assert_within_step_bars(root / "ref_to_port", root / "ref")


def test_reference_resumes_a_port_checkpoint(runs):
    root = runs["root"]
    manifest = read_manifest(root / "port", RESUME)
    n = len(tree_leaves(load(root / "port", RESUME)[0]))
    assert manifest["index"][n] == {"key": f"arr_{n:05d}", "shape": [],
                                    "dtype": "int32"}
    out = run_reference(cut_to(root / "port", root / "port_to_ref", RESUME))
    assert_same_lines(out, runs["port_out"])
    assert_within_step_bars(root / "port_to_ref", root / "port")


def test_driver_logs_as_the_reference(runs):
    """The same lines at the same steps; the losses differ (each package
    draws its own init)."""
    for out in (runs["port_out"], runs["ref_out"]):
        lines = out.splitlines()
        assert lines[-1] == "done"
        assert sorted(losses(out)) == list(range(STEPS))
        assert all(line.endswith(" ms/step)") for line in lines[:-1])


def test_edges(tmp_path):
    # --mesh pod / multipod train over a real group of 256 / 512 ranks:
    # none is up, then one of the wrong size
    for mesh in ("pod", "multipod"):
        with pytest.raises(ValueError, match="256 ranks for a pod, 512"):
            port_train.main([*ARGV, "--device", "cpu", "--mesh", mesh])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        for mesh, n in (("pod", 256), ("multipod", 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks .* has "
                                                 f"1$"):
                port_train.main([*ARGV, "--device", "cpu", "--mesh", mesh])
    finally:
        dist.destroy_process_group()
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.main(ARGV)


# ---------------------------------------------------------- compression
def _arrays():
    rng = np.random.default_rng(0)
    out = []
    for i in range(40):
        x = (rng.standard_normal((17, 29))
             * 10 ** rng.uniform(-9, 3)).astype(np.float32)
        if i % 3 == 0:
            x[rng.random(x.shape) < 0.5] = 0
        if i % 4 == 0:                   # ties at half a code
            s = np.float32(np.abs(x).max()) * np.float32(1 / 127)
            x[:3, :3] = (np.arange(9).reshape(3, 3) + 0.5).astype(
                np.float32) * s
        out.append(x)
    out += [np.zeros((5, 3), np.float32), np.full((4,), -2.5, np.float32),
            np.array([1e-30, -3e-31], np.float32)]
    return out


def test_int8_codes_and_scales_bit_equal():
    quant = jax.jit(jax_comp.int8_quantize)
    for x in _arrays():
        qj, sj = quant(jnp.asarray(x))
        qt, st = compression.int8_quantize(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        assert np.array_equal(np.asarray(qj), qt.numpy())
        assert np.asarray(sj).tobytes() == st.numpy().tobytes()
        back = compression.int8_dequantize(qt, st)
        assert np.asarray(jax_comp.int8_dequantize(qj, sj)).tobytes() == \
            back.numpy().tobytes()


def test_int8_transform_and_error_feedback_bit_equal():
    cfg_j = jax_get_config(ARCH).reduced()
    params = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(cfg_j, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32),
        params) for _ in range(3)]
    same = lambda a, b: all(
        np.asarray(x).tobytes() == y.numpy().tobytes() for x, y in
        zip(jax.tree_util.tree_leaves(a), tree_leaves(b)))
    transform = jax.jit(jax_comp.make_int8_grad_transform())
    port = compression.make_int8_grad_transform()
    assert same(transform(grads[0]), port(params_from_numpy(grads[0])))
    ef_j, ef_t = jax_comp.ErrorFeedbackCompressor(), \
        compression.ErrorFeedbackCompressor()
    res_j, res_t = ef_j.init(params), ef_t.init(params_from_numpy(params))
    compress = jax.jit(ef_j.compress)
    for g in grads:
        q_j, res_j = compress(g, res_j)
        q_t, res_t = ef_t.compress(params_from_numpy(g), res_t)
        assert same(q_j, q_t) and same(res_j, res_t)
    assert max(float(r.abs().max()) for r in tree_leaves(res_t)) > 0


def test_int8_train_step_matches_reference():
    """One ``make_train_step`` step (step 1 of cosine_schedule(3e-4, 3e-5,
    8, 1), fresh AdamW) through the int8 transform in both packages, from
    the reference's init with every vector perturbed."""
    cfg_j, cfg = configs(ARCH)
    params = reference_params(cfg_j)
    batch = batches(cfg, 1)[0]
    sched = (3e-4, 3e-5, 8, 1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    step_j = jax.jit(jax_steps.make_train_step(
        cfg_j, jax_optim.cosine_schedule(*sched),
        grad_transform=jax_comp.make_int8_grad_transform()))
    p_ref, s_ref, m_ref = jax.tree_util.tree_map(
        np.asarray, step_j(jp, jax_optim.adamw_init(jp), jb, 1))
    (_, _), g_ref = jax.jit(jax.value_and_grad(jax_tf.lm_loss, has_aux=True),
                            static_argnums=1)(jp, cfg_j, jb)
    g_ref, _ = jax_optim.clip_by_global_norm(g_ref, 1.0)
    seen = []

    def recorded(grads):                 # the clipped gradients it gets
        seen.append(grads)
        return compression.make_int8_grad_transform()(grads)
    step_t = steps.make_train_step(cfg, cosine_schedule(*sched),
                                   grad_transform=recorded)
    p0 = params_from_numpy(params)
    params_t, opt_t, m_t = step_t(p0, adamw_init(p0), to_port(batch), 1)
    for key in ("loss", "grad_norm"):
        assert abs(float(m_t[key]) - float(m_ref[key])) <= \
            LOSS_TOL * abs(float(m_ref[key]))
    lr = float(cosine_schedule(*sched)(1))
    assert float(m_t["lr"]) == float(m_ref["lr"]) == np.float32(lr)
    assert opt_t.step == int(s_ref.step) == 1
    port = [jax.tree_util.tree_leaves(params_to_numpy(t))
            for t in (params_t, opt_t.mu)]
    quant = jax.jit(jax_comp.int8_quantize)
    for i, (g, g_t) in enumerate(zip(jax.tree_util.tree_leaves(g_ref),
                                     tree_leaves(seen[0]))):
        g = np.asarray(g)
        scale = np.float32(np.abs(g).max()) * np.float32(1 / 127)
        gap = (F32_TOL + LOSS_TOL) * float(np.abs(g).max())
        near = np.abs(np.abs(g / scale) % 1.0 - 0.5) <= gap / scale
        # a code differs only where a gradient gap of the bar can move it
        codes = np.asarray(quant(jnp.asarray(g))[0])
        flipped = codes != compression.int8_quantize(g_t)[0].numpy()
        assert not (flipped & ~near).any(), i
        gap_el = np.where(near, gap + scale, gap)
        nu = jax.tree_util.tree_leaves(s_ref.nu)[i]
        p, mu = port[0][i], port[1][i]
        pr, mur = (jax.tree_util.tree_leaves(t)[i] for t in (p_ref, s_ref.mu))
        assert (np.abs(mu - mur) <= (1 - B1) * gap_el * 1.01).all(), i
        assert (np.abs(p - pr) <= param_bars(gap_el, nu, 1, lr)).all(), i
