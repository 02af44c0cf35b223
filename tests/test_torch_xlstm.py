"""The port's xLSTM blocks and the reduced xlstm-1.3b against the JAX
reference on the CPU.

Blocks: ``mlstm_forward`` (prefill through ``ssd_scan``, whose CPU path
is the plain chunked scan) and ``mlstm_step``, ``slstm_forward`` and
``slstm_step``, on the reference's own parameters, with and without a
carried state, S a multiple of the chunk, ragged and shorter than it.
Bar: 1e-5 of max(|ref|, 1) in float32.  One more mLSTM case scales
``w_if`` by 4, so that the input gate reaches its clip at 5 (exp(5) =
148 on v); there both fp32 implementations sit ~1e-5 from the port's
block run in float64 (the case prints both distances: the reference
9.4e-6, the port 2.5e-5 on a CPU; ``pytest -s``), so that case is held
at the model's bar, 1e-4.  The bf16 cases print their errors and bars
too.

In bf16 each block, on the reference's parameters and inputs cast to
bf16, is within BF16_BLOCK_TOL (2.5 bf16 ulps) of the reference's: the
two frameworks round at different places (XLA fuses an elementwise chain
and rounds once, PyTorch rounds after each op), one ulp measured on the
mLSTM block, none on the sLSTM block.

Model: ``xlstm_1p3b.reduced()`` (8 layers: 7 mLSTM and 1 sLSTM, d_model
64, 2 SSM heads, chunk 8), S = 24 (three chunks), logits of train,
prefill and teacher-forced decode against ``repro``'s ``model_apply``:
within 1e-4 of max(|ref|, 1) in float32 (norm vectors perturbed so that
every scale counts), as ``tests/test_torch_lm.py``.  In bf16 (on the
reference's initial values) the random 8-layer model is chaotic: the
reference's own bf16 logits leave its fp32 logits by 0.70 of their
scale, so ``tests/test_torch_lm.py``'s fixed bf16 bar (0.1, set on
zamba2, whose gap is 0.074) says nothing here; the port's bf16 logits
are held to no further from the reference's bf16 logits than those are
from the reference's fp32 logits (0.196 measured against 0.70), the
rule of chip_smoke.py's bf16 gates.  Prefill + decode against the port's
own forward within 2e-3, as tests/test_models.py holds the reference.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.models.config import SSMConfig as JaxSSMConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.nn import tree_leaves
from repro_torch.models import ssm, steps, transformer
from repro_torch.models.config import SSMConfig
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from test_torch_pretrain import one_thread_a_process  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BLOCK_TOL, BF16_BLOCK_TOL = 1e-5, 2e-2
F32_TOL = 1e-4
B, S, SPLIT, CACHE = 2, 24, 20, 28
D_BLOCK = 32


def _scaled_err(got, ref):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ssm_cfgs(chunk):
    jcfg = JaxSSMConfig(state_dim=8, conv_width=4, expand=2, chunk=chunk,
                        n_heads=2)
    return jcfg, SSMConfig(**dataclasses.asdict(jcfg))


# ------------------------------------------------------------- mLSTM
@pytest.mark.parametrize("S_,chunk,carried,gate_scale,tol", [
    (24, 8, False, 1.0, BLOCK_TOL), (24, 8, True, 1.0, BLOCK_TOL),
    (13, 8, False, 1.0, BLOCK_TOL), (13, 8, True, 1.0, BLOCK_TOL),
    (6, 8, True, 1.0, BLOCK_TOL),       # S <= chunk
    (24, 8, True, 4.0, F32_TOL)])       # the input gate's clip reached
def test_mlstm_forward_and_step_match_reference(S_, chunk, carried,
                                                gate_scale, tol):
    jcfg, cfg = _ssm_cfgs(chunk)
    jp = jax_ssm.init_mlstm(jax.random.PRNGKey(S_), D_BLOCK, jcfg,
                            jnp.float32)
    jp = {**jp, "w_if": jp["w_if"] * gate_scale}
    tp = params_from_numpy(_np(jp))
    rng = np.random.default_rng(S_ + carried)
    x = rng.standard_normal((B, S_, D_BLOCK)).astype(np.float32)
    H, P = jcfg.n_heads, jcfg.expand * D_BLOCK // jcfg.n_heads
    st = (rng.standard_normal((B, H, P + 1, P)).astype(np.float32) * 0.3
          if carried else None)
    y_r, st_r = jax_ssm.mlstm_forward(jp, jnp.asarray(x), jcfg,
                                      None if st is None else jnp.asarray(st))
    for backend in ("torch", "cuda"):   # "cuda" on CPU tensors: plain
        y, st_t = ssm.mlstm_forward(tp, _t(x), cfg,
                                    None if st is None else _t(st),
                                    backend=backend)
        assert y.shape == (B, S_, D_BLOCK) and st_t.shape == (B, H, P + 1, P)
        assert _scaled_err(y, y_r) <= tol
        assert _scaled_err(st_t, st_r) <= tol
    if gate_scale != 1.0:               # both fp32 paths against fp64
        y64, _ = ssm.mlstm_forward(
            params_from_numpy(_np(jp), dtype=torch.float64),
            _t(x).double(), cfg, _t(st).double())
        print(f"mLSTM, gate clip reached: vs the port in float64, the "
              f"reference {_scaled_err(y_r, y64)}, the port "
              f"{_scaled_err(y, y64)}")
    x1 = rng.standard_normal((B, 1, D_BLOCK)).astype(np.float32)
    y_r, st_r2 = jax_ssm.mlstm_step(jp, jnp.asarray(x1), jcfg, st_r)
    y, st2 = ssm.mlstm_step(tp, _t(x1), cfg, st_t)
    assert _scaled_err(y, y_r) <= tol
    assert _scaled_err(st2, st_r2) <= tol


# ------------------------------------------------------------- sLSTM
@pytest.mark.parametrize("S_,carried", [(13, False), (13, True), (1, True)])
def test_slstm_forward_and_step_match_reference(S_, carried):
    jcfg, cfg = _ssm_cfgs(8)
    jp = jax_ssm.init_slstm(jax.random.PRNGKey(7 + S_), D_BLOCK, jcfg,
                            jnp.float32)
    tp = params_from_numpy(_np(jp))
    rng = np.random.default_rng(S_ + 10 * carried)
    x = (rng.standard_normal((B, S_, D_BLOCK)) * 2.0).astype(np.float32)
    H, P = jcfg.n_heads, D_BLOCK // jcfg.n_heads
    st = None
    if carried:                          # (c, n, m, h), m finite
        st = tuple(rng.standard_normal((B, H, P)).astype(np.float32)
                   for _ in range(4))
    y_r, st_r = jax_ssm.slstm_forward(
        jp, jnp.asarray(x), jcfg,
        None if st is None else tuple(jnp.asarray(a) for a in st))
    y, st_t = ssm.slstm_forward(tp, _t(x), cfg,
                                None if st is None else tuple(map(_t, st)))
    assert _scaled_err(y, y_r) <= BLOCK_TOL
    for a, b in zip(st_t, st_r):
        assert _scaled_err(a, b) <= BLOCK_TOL
    x1 = rng.standard_normal((B, 1, D_BLOCK)).astype(np.float32)
    y_r, st_r2 = jax_ssm.slstm_step(jp, jnp.asarray(x1), jcfg, st_r)
    y, st2 = ssm.slstm_step(tp, _t(x1), cfg, st_t)
    assert _scaled_err(y, y_r) <= BLOCK_TOL
    for a, b in zip(st2, st_r2):
        assert _scaled_err(a, b) <= BLOCK_TOL


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_in_bf16_match_reference(kind):
    """bf16 parameters and inputs (the reference's cast-at-use values):
    the block's output within BF16_BLOCK_TOL of max(|ref|, 1), the state
    within BLOCK_TOL (both keep it in fp32)."""
    jcfg, cfg = _ssm_cfgs(8)
    jp = getattr(jax_ssm, f"init_{kind}")(jax.random.PRNGKey(0), 64, jcfg,
                                          jnp.float32)
    tp = params_from_numpy(_np(jp), dtype=torch.bfloat16)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    x = np.random.default_rng(0).standard_normal((B, S, 64)).astype(
        np.float32)
    y_r, st_r = getattr(jax_ssm, f"{kind}_forward")(
        jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    y, st = getattr(ssm, f"{kind}_forward")(tp, _t(x).bfloat16(), cfg)
    assert y.dtype == torch.bfloat16
    err = _scaled_err(y, np.asarray(y_r.astype(jnp.float32)))
    print(f"{kind} in bf16 vs the reference: {err}")
    assert err <= BF16_BLOCK_TOL
    for a, b in zip(tree_leaves(st), jax.tree_util.tree_leaves(st_r)):
        assert a.dtype == torch.float32
        assert _scaled_err(a, b) <= BF16_BLOCK_TOL


def test_slstm_initial_state_is_the_references():
    st = ssm.slstm_init_state((2, 3, 4))
    assert len(st) == 4 and all(t.shape == (2, 3, 4) for t in st)
    assert torch.equal(st[2], torch.full((2, 3, 4), -1e30)) and all(
        float(t.abs().max()) == 0.0 for t in (st[0], st[1], st[3]))


# ------------------------------------------------------- the reduced model
def _cfgs(compute_dtype):
    cfg_j = dataclasses.replace(jax_get_config("xlstm_1p3b").reduced(),
                                compute_dtype=compute_dtype)
    cfg_t = dataclasses.replace(get_config("xlstm_1p3b").reduced(),
                                compute_dtype=compute_dtype)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    assert cfg_t.pattern_for_depth() == ("mlstm",) * 7 + ("slstm",)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def ref_init():
    cfg_j, _ = _cfgs("float32")
    return _np(jax_tf.init_params(cfg_j, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_params(ref_init):
    rng = np.random.default_rng(0)

    def perturb(x):                  # the zero norm vectors -> random
        if x.ndim - 1 <= 1 and x.shape[-1] <= 512:
            return (x + rng.standard_normal(x.shape) * 0.3).astype(x.dtype)
        return x
    return jax.tree_util.tree_map(perturb, ref_init)


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (B, S)).astype(
        np.int32)


def _run_jax(cfg, params, toks, state_dtype):
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    full, _, _ = jax_tf.model_apply(jp, cfg, {"tokens": jnp.asarray(toks)})
    state = jax_tf.init_decode_state(cfg, B, CACHE, dtype=state_dtype)
    pre, state, _ = jax_tf.model_apply(
        jp, cfg, {"tokens": jnp.asarray(toks[:, :SPLIT])}, mode="prefill",
        state=state)
    dec = []
    for i in range(SPLIT, S):
        lg, state, _ = jax_tf.model_apply(
            jp, cfg, {"tokens": jnp.asarray(toks[:, i:i + 1])},
            mode="decode", state=state, cache_pos=i)
        dec.append(lg[:, 0])
    return full, pre, dec


def _run_port(cfg, params, toks, state_dtype):
    tp = transformer.cast_params(params_from_numpy(params), cfg)
    t = torch.from_numpy(toks).long()
    full, _, _ = transformer.model_apply(tp, cfg, {"tokens": t})
    state = transformer.init_decode_state(cfg, B, CACHE, dtype=state_dtype,
                                          device="cpu")
    pre, state, _ = transformer.model_apply(
        tp, cfg, {"tokens": t[:, :SPLIT]}, mode="prefill", state=state)
    decode = steps.make_decode_step(cfg)
    dec = []
    for i in range(SPLIT, S):
        lg, state = decode(tp, {"tokens": t[:, i:i + 1]}, state, i)
        dec.append(lg)
    return full, pre, dec


def _logit_errs(got, ref):
    """Scaled errors of (full, prefill, decode steps) logits."""
    return [_scaled_err(got[0], ref[0]), _scaled_err(got[1], ref[1])] + [
        _scaled_err(a, b) for a, b in zip(got[2], ref[2])]


@pytest.mark.parametrize("compute_dtype,perturbed", [
    ("float32", True), ("float32", False), ("bfloat16", False)])
def test_logits_match_reference(ref_init, ref_params, compute_dtype,
                                perturbed):
    params = ref_params if perturbed else ref_init
    cfg_j, cfg_t = _cfgs(compute_dtype)
    toks = _tokens(cfg_t.vocab)
    sdt = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[compute_dtype]
    ref = _run_jax(cfg_j, params, toks, sdt[0])
    got = _run_port(cfg_t, params, toks, sdt[1])
    assert got[0].shape == (B, S, cfg_t.vocab)
    assert got[0].dtype == getattr(torch, compute_dtype)
    tol = F32_TOL
    if compute_dtype == "bfloat16":     # the reference's own bf16 gap
        ref32 = _run_jax(_cfgs("float32")[0], params, toks, jnp.float32)
        tol = max(_logit_errs(
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), ref),
            ref32))
    errs = _logit_errs(got, ref)
    print(f"{compute_dtype} logits vs the reference: {max(errs)}, bar {tol}")
    assert max(errs) <= tol, (errs, tol)


def test_prefill_decode_matches_own_forward(ref_params):
    _, cfg = _cfgs("float32")
    full, pre, dec = _run_port(cfg, ref_params, _tokens(cfg.vocab),
                               torch.float32)
    np.testing.assert_allclose(pre.numpy(), full[:, :SPLIT].numpy(),
                               rtol=2e-3, atol=2e-3)
    for i, lg in zip(range(SPLIT, S), dec):
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_plain_path_in_float64(ref_params):
    """Parameters and decode state in float64 keep the whole plain path
    in fp64 (mLSTM and sLSTM states included), within F32_TOL of fp32."""
    _, cfg = _cfgs("float32")
    p32 = transformer.cast_params(params_from_numpy(ref_params), cfg)
    p64 = params_from_numpy(ref_params, dtype=torch.float64)
    t = torch.from_numpy(_tokens(cfg.vocab)).long()
    out = {}
    for name, p, dt in (("f32", p32, torch.float32),
                        ("f64", p64, torch.float64)):
        state = transformer.init_decode_state(cfg, B, CACHE, dtype=dt,
                                              device="cpu")
        pre, state, _ = transformer.model_apply(
            p, cfg, {"tokens": t[:, :SPLIT]}, mode="prefill", state=state)
        assert all(x.dtype == dt for x in tree_leaves(state["unit"]))
        lg, _ = steps.make_decode_step(cfg)(
            p, {"tokens": t[:, SPLIT:SPLIT + 1]}, state, SPLIT)
        out[name] = (pre, lg)
    assert all(x.dtype == torch.float64 for x in out["f64"])
    for a, b in zip(out["f32"], out["f64"]):
        assert _scaled_err(a, b.numpy()) <= F32_TOL


def test_decode_state_matches_reference():
    """Structure, shapes and dtypes: an mLSTM block's (reps, B, H, P + 1,
    P) fp32 state, an sLSTM block's (c, n, m, h) with m at -1e30."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    ref = _np(jax_tf.init_decode_state(cfg_j, B, CACHE))
    mine = params_to_numpy(transformer.init_decode_state(cfg_t, B, CACHE,
                                                         device="cpu"))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(mine)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_init_params_shapes_match_reference():
    cfg_j, cfg_t = _cfgs("float32")
    ref = jax.eval_shape(lambda: jax_tf.init_params(cfg_j,
                                                    jax.random.PRNGKey(0)))
    mine = params_to_numpy(transformer.init_params(cfg_t, 0, device="cpu"))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(mine)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_params_round_trip_and_cast(ref_params):
    tp = params_from_numpy(ref_params)
    back = params_to_numpy(tp)
    assert jax.tree_util.tree_structure(ref_params) == \
        jax.tree_util.tree_structure(back)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(ref_params),
                   jax.tree_util.tree_leaves(back)))
    _, cfg = _cfgs("bfloat16")
    cast = transformer.cast_params(tp, cfg)
    # matrices (r_gates: (reps, H, P, 4P)) to bf16, the norm vectors fp32,
    # as the reference's cast at use
    mlstm, slstm = cast["unit"][0], cast["unit"][7]
    assert all(mlstm["core"][k].dtype == torch.bfloat16
               for k in ("w_in", "w_q", "w_k", "w_v", "w_if", "w_out"))
    assert slstm["core"]["r_gates"].dtype == torch.bfloat16
    assert mlstm["ln1"].dtype == slstm["ln1"].dtype == torch.float32


def test_kernel_backend_on_cpu_is_the_plain_path(ref_params):
    _, cfg = _cfgs("float32")
    tp = params_from_numpy(ref_params)
    t = torch.from_numpy(_tokens(cfg.vocab)).long()
    a, _, _ = transformer.model_apply(tp, cfg, {"tokens": t},
                                      ssm_backend="cuda")
    b, _, _ = transformer.model_apply(tp, cfg, {"tokens": t},
                                      ssm_backend="torch")
    assert torch.equal(a, b)


def test_serve_entry_point_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "xlstm_1p3b", "--reduced", "--device",
                          "cpu", "--prompt-len", "12", "--gen", "4"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "xlstm-1.3b on cpu" in out.stdout
    assert "prefill_s=" in out.stdout and "decode_ms_per_step=" in out.stdout
