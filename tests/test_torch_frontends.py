"""The audio and vision stub frontends against the JAX reference on the
CPU, and the serving entry point for the MoE and stub configs.

Reduced musicgen (inputs are frame embeddings (B, S, D), non-gated GELU,
untied head) and reduced paligemma (n_patches patch embeddings in front
of the tokens, MQA, GeGLU, tied embeddings): train, prefill and decode
logits within F32_TOL of the reference's ``model_apply`` on converted
parameters, decode positions after the patches; and the port's prefill +
decode against its own forward (tests/test_models.py's check of the
reference).

``launch/serve.py --reduced --device cpu`` for the four configs of this
slice, paligemma also at ``--prompt-len 8 --gen 3``: the reference's
``serve.py`` sizes its cache as prompt + gen, leaving out the patches,
and crashes there (ROADMAP C); the port's cache holds n_patches + prompt
+ gen positions.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer
from test_torch_moe import (B, S, SPLIT, _reduced, assert_model_matches,
                            model_batch, perturbed_params, run_port)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["musicgen_large", "paligemma_3b"])
def test_reduced_frontend_model_matches_reference(arch):
    cfg_j, cfg_t = _reduced(arch)
    assert cfg_t.frontend in ("audio_stub", "vision_stub")
    got = assert_model_matches(cfg_j, cfg_t, perturbed_params(cfg_j, 7),
                               model_batch(cfg_t, 8))
    assert float(got[0][1]) == 0.0              # no MoE layer: no aux


@pytest.mark.parametrize("arch", ["musicgen_large", "paligemma_3b"])
def test_frontend_prefill_decode_matches_own_forward(arch):
    cfg_j, cfg = _reduced(arch)
    got = run_port(cfg, perturbed_params(cfg_j, 9), model_batch(cfg, 10))
    full = got[0][0]
    off = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    np.testing.assert_allclose(got[1][0].numpy(),
                               full[:, :off + SPLIT].numpy(),
                               rtol=2e-3, atol=2e-3)
    for i, (lg, _) in zip(range(SPLIT, S), got[2:]):
        np.testing.assert_allclose(lg.numpy(), full[:, off + i].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_vision_cache_holds_patches_prompt_and_gen():
    """``generate`` sizes the KV cache n_patches + prompt + gen and decodes
    at positions after the patches; a decode past the cache raises rather
    than writing a clamped slot."""
    cfg = get_config("paligemma_3b").reduced()
    params = serve.load_model(cfg, 0, "cpu")
    prompt, steps_in = serve.prompt_inputs(cfg, 2, 8, 3, 0, "cpu")
    assert steps_in is None
    assert prompt["patches"].shape == (2, cfg.n_patches, cfg.d_model)
    assert serve.prompt_positions(prompt) == cfg.n_patches + 8
    res = serve.generate(params, cfg, prompt, 3)
    assert res.tokens.shape == (2, 3)
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    state = transformer.init_decode_state(cfg, 2, 12, dtype=torch.float32,
                                          device="cpu")
    with pytest.raises(IndexError, match="outside the 12-position"):
        transformer.model_apply(params, cfg, {"tokens": res.tokens[:, :1]},
                                mode="decode", state=state, cache_pos=12)


def test_audio_decode_steps_take_fresh_frames():
    cfg = get_config("musicgen_large").reduced()
    params = serve.load_model(cfg, 0, "cpu")
    prompt, steps_in = serve.prompt_inputs(cfg, 2, 6, 4, 0, "cpu")
    assert prompt["frames"].shape == (2, 6, cfg.d_model)
    assert steps_in["frames"].shape == (2, 3, cfg.d_model)
    assert prompt["frames"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="step_inputs"):
        serve.generate(params, cfg, prompt, 4)
    res = serve.generate(params, cfg, prompt, 4, step_inputs=steps_in)
    assert res.tokens.shape == (2, 4)
    # the same request again gives the same tokens
    again = serve.generate(params, cfg, prompt, 4, step_inputs=steps_in)
    assert torch.equal(res.tokens, again.tokens)


def _serve(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True,
                          timeout=180, cwd=ROOT, env=env)


@pytest.mark.parametrize("arch,extra", [
    ("granite_moe_3b_a800m", ()),
    ("qwen3_moe_235b_a22b", ("--layers", "2")),
    ("musicgen_large", ()),
    ("paligemma_3b", ()),
    ("paligemma_3b", ("--prompt-len", "8", "--gen", "3"))])
def test_serve_entry_point_runs_each_new_config(arch, extra):
    out = _serve("--arch", arch, "--reduced", "--device", "cpu", *extra)
    assert out.returncode == 0, out.stderr
    assert "prefill_s=" in out.stdout and "decode_ms_per_step=" in out.stdout
    if arch == "paligemma_3b" and extra:
        # 4 patches + 8 tokens + 3 generated
        assert "prompt 8 (12 positions), gen 3, cache 15" in out.stdout
