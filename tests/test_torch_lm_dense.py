"""The three dense configs that only the card's paths had left unheld
(olmo-1b, phi4-mini-3.8b, qwen1.5-110b): the port's serving path against
the JAX reference on the CPU.

Each config is cut as ``tests/test_torch_lm.py``'s gemma is, by hand and
not by ``ModelConfig.reduced()`` (which turns phi4's 24/8 heads into
4/4): 2 layers, vocab 512, narrow widths, with each config's own features
kept and asserted against the published config:
- olmo-1b: the non-parametric LayerNorm, a tied head, H = KV (16/16 -> 4/4);
- phi4-mini-3.8b: GQA 3:1 (24/8 -> 6/2), RMSNorm, a tied head;
- qwen1.5-110b: QKV bias, rope theta 1e6, an untied head, GQA 8:1 (64/8
  -> 16/2).

Bars (``tests/test_torch_lm.py``'s): logits of train, prefill and decode
within F32_TOL (1e-4) of ``repro``'s ``model_apply``, scaled by max(|ref|,
1), at compute_dtype float32 on the reference's init with every vector
perturbed (the QKV biases start at zero, the RMSNorm scales at zero
offsets: unperturbed, neither would count); in bf16 within BF16_TOL (0.1)
on the reference's own init.  ``attn_mixed_precision`` (the probabilities
rounded to bf16 before the product with v) is held on olmo in bf16
within BF16_TOL as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import transformer as jax_tf
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.convert import params_to_numpy

from test_torch_lm import (B, BF16_TOL, F32_TOL, S, _run_jax, _run_port,
                           _scaled_err, _tokens)
from test_torch_pretrain import one_thread_a_process  # noqa: F401

# per config: the cut (2 layers, vocab 512) and the features it keeps
CUTS = {
    "olmo_1b": dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                    d_ff=128),
    "phi4_mini_3p8b": dict(d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
                           d_ff=128),
    "qwen1p5_110b": dict(d_model=64, n_heads=16, n_kv_heads=2, head_dim=8,
                         d_ff=128),
}
FEATURES = ("norm", "qkv_bias", "rope_theta", "tie_embeddings", "act",
            "family", "block_pattern")


def configs(arch, **kw):
    """``arch`` cut to 2 layers, vocab 512 and ``CUTS[arch]``, in both
    packages (the same fields)."""
    cut = {"n_layers": 2, "vocab": 512, "compute_dtype": "float32",
           **CUTS[arch], **kw}
    cfg_j = dataclasses.replace(jax_get_config(arch), **cut)
    cfg_t = dataclasses.replace(get_config(arch), **cut)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    return cfg_j, cfg_t


def reference_init(cfg_j, seed):
    return jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(cfg_j, jax.random.PRNGKey(seed)))


def perturbed(params, seed):
    """Every vector leaf (norm scales, QKV biases) moved off its init."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.3).astype(x.dtype)
        if x.ndim - 1 <= 1 and x.shape[-1] <= 512 else x, params)


def max_err(cfg_j, cfg_t, params, dtype):
    toks = _tokens(cfg_t.vocab)
    sdt = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    full_j, pre_j, dec_j = _run_jax(cfg_j, params, toks, sdt[0])
    full_t, pre_t, dec_t = _run_port(cfg_t, params, toks, sdt[1])
    assert full_t.shape == (B, S, cfg_t.vocab)
    assert full_t.dtype == getattr(torch, dtype)
    errs = [_scaled_err(full_t, full_j), _scaled_err(pre_t, pre_j)]
    errs += [_scaled_err(a, b) for a, b in zip(dec_t, dec_j)]
    return max(errs), errs


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_cut_keeps_the_config_features(arch):
    pub = get_config(arch)
    _, cfg = configs(arch)
    assert [getattr(cfg, f) for f in FEATURES] == \
        [getattr(pub, f) for f in FEATURES]
    assert cfg.n_heads // cfg.n_kv_heads == pub.n_heads // pub.n_kv_heads
    assert cfg.n_heads % cfg.n_kv_heads == 0
    assert pub.pattern_for_depth() == ("attn",) * pub.n_layers
    want = {"olmo_1b": ("nonparametric", True, False, 1e4, 1),
            "phi4_mini_3p8b": ("rms", True, False, 1e4, 3),
            "qwen1p5_110b": ("rms", False, True, 1e6, 8)}[arch]
    assert (cfg.norm, cfg.tie_embeddings, cfg.qkv_bias, cfg.rope_theta,
            cfg.n_heads // cfg.n_kv_heads) == want


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_params_match_reference_structure(arch):
    """The port's init has the reference's tree, shapes and dtypes: no
    norm vectors for olmo, no head where tied, q/k/v biases for qwen."""
    cfg_j, cfg_t = configs(arch)
    ref = jax.eval_shape(lambda: jax_tf.init_params(cfg_j,
                                                    jax.random.PRNGKey(0)))
    mine = params_to_numpy(transformer.init_params(cfg_t, 0, device="cpu"))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(mine)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype
    attn = mine["unit"][0]
    assert ("head" in mine) == (not cfg_t.tie_embeddings)
    assert ("final_norm" in mine) == (cfg_t.norm == "rms")
    assert ("ln1" in attn) == (cfg_t.norm == "rms")
    assert ({"bq", "bk", "bv"} <= set(attn)) == cfg_t.qkv_bias


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_logits_match_reference_fp32(arch):
    """Train, prefill and decode logits within 1e-4 of ``repro``'s on the
    same converted weights, every vector perturbed."""
    cfg_j, cfg_t = configs(arch)
    params = perturbed(reference_init(cfg_j, 1), 2)
    err, errs = max_err(cfg_j, cfg_t, params, "float32")
    assert err <= F32_TOL, errs


@pytest.mark.parametrize("arch,mixed", [(a, False) for a in sorted(CUTS)]
                         + [("olmo_1b", True)])
def test_logits_match_reference_bf16(arch, mixed):
    """In bf16 on the reference's own init, within BF16_TOL; with
    ``attn_mixed_precision`` the reference's bf16 products of P and v
    against the port's plain mixed mode (the CPU path)."""
    cfg_j, cfg_t = configs(arch, compute_dtype="bfloat16",
                           attn_mixed_precision=mixed)
    params = reference_init(cfg_j, 1)
    err, errs = max_err(cfg_j, cfg_t, params, "bfloat16")
    assert err <= BF16_TOL, errs


def test_mixed_precision_changes_the_bf16_attention():
    """The mixed mode is not the fp32 mode under another name: on the same
    bf16 inputs it rounds P, so the two differ (by under the bf16 bar),
    and in fp32 the two are the same function."""
    _, cfg = configs("olmo_1b", compute_dtype="bfloat16")
    params = transformer.cast_params(
        transformer.init_params(cfg, 0, device="cpu"), cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab)).long()
    out = {}
    for dtype in ("bfloat16", "float32"):
        for mixed in (False, True):
            c = dataclasses.replace(cfg, compute_dtype=dtype,
                                    attn_mixed_precision=mixed)
            p = params if dtype == "bfloat16" else transformer.cast_params(
                transformer.init_params(c, 0, device="cpu"), c)
            out[dtype, mixed] = transformer.model_apply(
                p, c, {"tokens": toks})[0].float()
    gap = _scaled_err(out["bfloat16", True], out["bfloat16", False].numpy())
    assert 0 < gap <= BF16_TOL
    assert torch.equal(out["float32", True], out["float32", False])


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_serve_entry_point_runs_on_cpu(arch):
    """``launch/serve.py``'s ``main`` on the reduced config: finite logits,
    tokens in the vocabulary."""
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--prompt-len", "12", "--gen", "4", "--batch", "2"])
    vocab = get_config(arch).reduced().vocab
    assert res.tokens.shape == (2, 4)
    assert bool(((res.tokens >= 0) & (res.tokens < vocab)).all())
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
