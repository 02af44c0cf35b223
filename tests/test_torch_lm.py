"""The port's LM serving path against the JAX reference on the CPU.

Reduced zamba2 with 8 layers: one full (mamba x 5, attn_shared) unit plus
a 2-block remainder, so the shared attention and the ``rem`` segment both
run; S = 24 with SSM chunk 8 (three chunks).  The reference's parameters
(from its own ``init_params``, vectors perturbed so every scale and bias
counts) are carried across with ``params_from_numpy``.

A few-layer gemma-2b (head_dim 256, one KV head, GeGLU, tied embeddings;
d_model 512, 2 heads, vocab 512) is held the same way.

Bars: logits of train / prefill / decode within 1e-4 of ``repro``'s
``model_apply``, scaled by max(|ref|, 1), at compute_dtype float32.  In
bf16 the two frameworks round at different places (XLA fuses elementwise
chains and rounds once, PyTorch rounds after each op: ``silu`` alone
differs by one bf16 ulp, 0.7%), and 8 random layers amplify that.  So the
bf16 case runs on the reference's own initial values (the perturbed
vectors make bf16 chaotic: the reference's own bf16 logits then differ
from its fp32 ones by 50%), where the largest gap measured is 0.054,
against 0.074 between the reference's own bf16 and fp32 logits; the bar
BF16_TOL is 0.1.  Prefill + decode matches the port's own full forward
within 2e-3, as in tests/test_models.py.
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
from repro.models import transformer as jax_tf
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.nn import tree_leaves, tree_map
from repro_torch.models import steps, transformer
from repro_torch.models.common import cast_block_params
from repro_torch.models.convert import params_from_numpy, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
B, S, SPLIT, CACHE = 2, 24, 20, 28
F32_TOL = 1e-4
BF16_TOL = 0.1


def _cfgs(compute_dtype):
    cfg_j = dataclasses.replace(jax_get_config("zamba2_1p2b").reduced(),
                                n_layers=8, compute_dtype=compute_dtype)
    cfg_t = dataclasses.replace(get_config("zamba2_1p2b").reduced(),
                                n_layers=8, compute_dtype=compute_dtype)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def ref_init():
    cfg_j, _ = _cfgs("float32")
    return jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(cfg_j, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_params(ref_init):
    rng = np.random.default_rng(0)

    def perturb(x):                  # zeros / ones vectors -> random
        if x.ndim - 1 <= 1 and x.shape[-1] <= 512:
            return (x + rng.standard_normal(x.shape) * 0.3).astype(x.dtype)
        return x
    return jax.tree_util.tree_map(perturb, ref_init)


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (B, S)).astype(
        np.int32)


def _scaled_err(got, ref):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1)


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


@pytest.mark.parametrize("compute_dtype,tol,perturbed", [
    ("float32", F32_TOL, True), ("float32", F32_TOL, False),
    ("bfloat16", BF16_TOL, False)])
def test_logits_match_reference(ref_init, ref_params, compute_dtype, tol,
                                perturbed):
    params = ref_params if perturbed else ref_init
    cfg_j, cfg_t = _cfgs(compute_dtype)
    toks = _tokens(cfg_t.vocab)
    sdt = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[compute_dtype]
    full_j, pre_j, dec_j = _run_jax(cfg_j, params, toks, sdt[0])
    full_t, pre_t, dec_t = _run_port(cfg_t, params, toks, sdt[1])
    assert full_t.shape == (B, S, cfg_t.vocab)
    assert full_t.dtype == getattr(torch, compute_dtype)
    errs = [_scaled_err(full_t, full_j), _scaled_err(pre_t, pre_j)]
    errs += [_scaled_err(a, b) for a, b in zip(dec_t, dec_j)]
    assert max(errs) <= tol, errs


def _gemma_cfgs():
    """gemma-2b cut to 2 layers, d_model 512, 2 query heads, vocab 512;
    its head_dim 256, one KV head (MQA), GeGLU and tied embeddings kept."""
    kw = dict(n_layers=2, d_model=512, n_heads=2, d_ff=1024, vocab=512,
              compute_dtype="float32")
    cfg_j = dataclasses.replace(jax_get_config("gemma_2b"), **kw)
    cfg_t = dataclasses.replace(get_config("gemma_2b"), **kw)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    assert (cfg_t.head_dim, cfg_t.n_kv_heads, cfg_t.act,
            cfg_t.tie_embeddings) == (256, 1, "geglu", True)
    return cfg_j, cfg_t


def test_gemma_logits_match_reference():
    """A few-layer gemma (head_dim 256, MQA, GeGLU, tied embeddings):
    train, prefill and decode logits within 1e-4 of ``repro``'s
    ``model_apply`` on the same converted weights (the norm vectors
    perturbed so that every scale counts)."""
    cfg_j, cfg_t = _gemma_cfgs()
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.3).astype(x.dtype)
        if x.ndim - 1 <= 1 and x.shape[-1] <= 512 else x,
        jax.tree_util.tree_map(np.asarray, jax_tf.init_params(
            cfg_j, jax.random.PRNGKey(1))))
    toks = _tokens(cfg_t.vocab)
    full_j, pre_j, dec_j = _run_jax(cfg_j, params, toks, jnp.float32)
    full_t, pre_t, dec_t = _run_port(cfg_t, params, toks, torch.float32)
    assert full_t.shape == (B, S, cfg_t.vocab)
    errs = [_scaled_err(full_t, full_j), _scaled_err(pre_t, pre_j)]
    errs += [_scaled_err(a, b) for a, b in zip(dec_t, dec_j)]
    assert max(errs) <= F32_TOL, errs


def test_prefill_decode_matches_own_forward(ref_params):
    """KV caches, SSD states, conv tails and the shared attention's
    per-occurrence caches, as tests/test_models.py checks the reference."""
    _, cfg = _cfgs("float32")
    toks = _tokens(cfg.vocab)
    full, pre, dec = _run_port(cfg, ref_params, toks, torch.float32)
    np.testing.assert_allclose(pre.numpy(), full[:, :SPLIT].numpy(),
                               rtol=2e-3, atol=2e-3)
    for i, lg in zip(range(SPLIT, S), dec):
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("prompt_len", [1, 2])
def test_short_prompt_prefill_and_decode(ref_params, prompt_len):
    """A prompt shorter than conv_width - 1 (ROADMAP C1): prefill pads the
    conv tail with zeros, so prefill + decode equals ``repro``'s
    train-mode forward over prompt + decoded tokens (the reference's own
    decode has the same fault and cannot be the oracle)."""
    cfg_j, cfg = _cfgs("float32")
    assert prompt_len < cfg.ssm.conv_width - 1
    toks = _tokens(cfg.vocab)[:, :prompt_len + 4]
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    full, _, _ = jax_tf.model_apply(jp, cfg_j, {"tokens": jnp.asarray(toks)})
    tp = transformer.cast_params(params_from_numpy(ref_params), cfg)
    t = torch.from_numpy(toks).long()
    state = transformer.init_decode_state(cfg, B, CACHE, dtype=torch.float32,
                                          device="cpu")
    pre, state, _ = transformer.model_apply(
        tp, cfg, {"tokens": t[:, :prompt_len]}, mode="prefill", state=state)
    errs = [_scaled_err(pre, full[:, :prompt_len])]
    decode = steps.make_decode_step(cfg)
    for i in range(prompt_len, toks.shape[1]):
        lg, state = decode(tp, {"tokens": t[:, i:i + 1]}, state, i)
        errs.append(_scaled_err(lg, full[:, i]))
    assert max(errs) <= F32_TOL, errs


def test_plain_path_in_float64(ref_params):
    """Parameters and decode state cast to float64 keep the whole plain
    path in fp64 (the numerics reference chip_smoke.py holds the fp32
    paths against); it agrees with the fp32 path within F32_TOL."""
    _, cfg = _cfgs("float32")
    p32 = transformer.cast_params(params_from_numpy(ref_params), cfg)
    p64 = tree_map(lambda x: x.double() if x.is_floating_point() else x,
                   p32)
    toks = _tokens(cfg.vocab)
    out = {}
    for name, p, dt in (("f32", p32, torch.float32),
                        ("f64", p64, torch.float64)):
        state = transformer.init_decode_state(cfg, B, CACHE, dtype=dt,
                                              device="cpu")
        t = torch.from_numpy(toks).long()
        pre, state, _ = transformer.model_apply(
            p, cfg, {"tokens": t[:, :SPLIT]}, mode="prefill", state=state)
        decode = steps.make_decode_step(cfg)
        lg, _ = decode(p, {"tokens": t[:, SPLIT:SPLIT + 1]}, state, SPLIT)
        out[name] = (pre, lg)
    assert all(x.dtype == torch.float64 for x in out["f64"])
    for a, b in zip(out["f32"], out["f64"]):
        assert _scaled_err(a, b.numpy()) <= F32_TOL


def test_kernel_backends_on_cpu_are_the_plain_path(ref_params):
    _, cfg = _cfgs("float32")
    tp = params_from_numpy(ref_params)
    t = torch.from_numpy(_tokens(cfg.vocab)).long()
    a, _, _ = transformer.model_apply(tp, cfg, {"tokens": t},
                                      attn_backend="cuda", ssm_backend="cuda")
    b, _, _ = transformer.model_apply(tp, cfg, {"tokens": t},
                                      attn_backend="torch",
                                      ssm_backend="torch")
    assert torch.equal(a, b)


def test_params_round_trip_and_cast(ref_params):
    tp = params_from_numpy(ref_params)
    back = params_to_numpy(tp)
    la = jax.tree_util.tree_leaves(ref_params)
    lb = jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(ref_params) == \
        jax.tree_util.tree_structure(back)
    assert len(la) == len(lb) and all(
        a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(la, lb))
    _, cfg = _cfgs("bfloat16")
    cast = transformer.cast_params(tp, cfg)
    # matrices to bf16, vectors (stacked over reps: 2-D) kept fp32
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["shared_attn"]["wq"].dtype == torch.bfloat16
    assert cast["unit"][0]["core"]["w_in"].dtype == torch.bfloat16
    assert cast["unit"][0]["core"]["conv"].dtype == torch.bfloat16
    assert cast["unit"][0]["core"]["A_log"].dtype == torch.float32
    assert cast["unit"][0]["ln1"].dtype == torch.float32
    assert cast["final_norm"].dtype == torch.float32
    # casting once gives the reference's cast-at-use values: each block's
    # weights, sliced from the stacked unit, as the per-use cast gives them
    def same(a, b):
        la = [x for x in tree_leaves(a) if x is not None]
        lb = [x for x in tree_leaves(b) if x is not None]
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))
    for i, p in enumerate(tp["unit"]):
        if p is not None:
            for r in range(tree_leaves(p)[0].shape[0]):
                assert same(tree_map(lambda t: t[r], cast["unit"][i]),
                            cast_block_params(tree_map(lambda t: t[r], p),
                                              torch.bfloat16))
    for k in ("embed", "shared_attn", "final_norm", "rem"):
        assert same(cast[k], cast_block_params(tp[k], torch.bfloat16))


def test_init_params_shapes_match_reference():
    cfg_j, cfg_t = _cfgs("float32")
    ref = jax.eval_shape(lambda: jax_tf.init_params(cfg_j,
                                                    jax.random.PRNGKey(0)))
    mine = transformer.init_params(cfg_t, 0, device="cpu")
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(params_to_numpy(mine))
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(params_to_numpy(mine))):
        assert a.shape == b.shape and a.dtype == b.dtype


def _serve(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)


def test_serve_entry_point_runs_on_cpu():
    out = _serve("--arch", "zamba2_1p2b", "--reduced", "--device", "cpu",
                 "--prompt-len", "12", "--gen", "4")
    assert out.returncode == 0, out.stderr
    assert "prefill_s=" in out.stdout and "decode_ms_per_step=" in out.stdout


def test_serve_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would serve")
    out = _serve("--arch", "zamba2_1p2b")
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_every_arch_resolves():
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
