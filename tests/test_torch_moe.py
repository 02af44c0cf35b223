"""The port's token-choice MoE against the JAX reference on the CPU.

``moe_ffn`` against ``repro.models.mlp.moe_ffn`` on the same numpy inputs
and parameters, in three routing shapes (reduced granite: E 4, K 2;
granite's E 40, K 8 and qwen3-moe's E 128, K 8 at narrow width), each at
capacity factor 1.25 (assignments dropped) and 16 (none dropped): the
expert choices (the reference's top-k, computed in JAX) and the kept
assignments equal, y within 1e-5 of max(|ref|, 1) in fp32, aux within
1e-6, and y in bf16 within BF16_TOL (tests/test_torch_lm.py's bar).

The whole reduced model for granite and qwen3-moe: train, prefill and
decode logits and the summed aux against the reference's ``model_apply``
within F32_TOL.  Decode runs at capacity 1 (2 tokens, top-2 of 4
experts), so it drops assignments and is held against the reference's
decode, not the port's own forward; at capacity factor 16 the port's
prefill + decode equals its own forward, as tests/test_models.py checks
the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import mlp as jax_mlp
from repro.models import transformer as jax_tf
from repro.models.common import cast_block_params as jax_cast
from repro.models.config import MoEConfig as JaxMoEConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import mlp, steps, transformer
from repro_torch.models.common import cast_block_params
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import params_from_numpy, params_to_numpy

F32_TOL = 1e-4
Y_TOL, AUX_TOL, BF16_TOL = 1e-5, 1e-6, 0.1
B, S, SPLIT, CACHE = 2, 12, 9, 16

# (n_experts, top_k, d_model, d_expert, tokens): reduced granite, then
# granite's and qwen3-moe's routing at narrow width
SHAPES = {"granite_reduced": (4, 2, 64, 32, 48),
          "granite_routing": (40, 8, 64, 32, 96),
          "qwen3_routing": (128, 8, 64, 32, 160)}


def _scaled_err(got, ref):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1)


def _moe_case(shape, cf, seed=0):
    E, K, D, F, T = SHAPES[shape]
    kw = dict(n_experts=E, top_k=K, d_expert=F, capacity_factor=cf)
    params = jax.tree_util.tree_map(np.asarray, jax_mlp.init_moe_ffn(
        jax.random.PRNGKey(seed), D, JaxMoEConfig(**kw), "swiglu",
        jnp.float32))
    x = np.random.default_rng(seed).standard_normal((2, T // 2, D)).astype(
        np.float32)
    return JaxMoEConfig(**kw), MoEConfig(**kw), params, x


def _reference_plan(params, x, cfg):
    """The reference's top-k and kept assignments (its argsort dispatch),
    computed in JAX: -> (experts (T, K), kept (T * K,) in flat order)."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32)
                           @ jnp.asarray(params["router"]), axis=-1)
    _, experts = jax.lax.top_k(probs, cfg.top_k)
    T = xf.shape[0]
    cap = int(max(1, round(T * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor)))
    flat_e = experts.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.zeros(cfg.n_experts, jnp.int32).at[se].add(1)
    starts = jnp.cumsum(counts) - counts
    keep = (jnp.arange(T * cfg.top_k) - starts[se]) < cap
    kept = jnp.zeros(T * cfg.top_k, bool).at[order].set(keep)
    return np.asarray(experts), np.asarray(kept)


@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_moe_ffn_matches_reference(shape, cf):
    cfg_j, cfg_t, params, x = _moe_case(shape, cf)
    y_j, aux_j = jax_mlp.moe_ffn(jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.asarray(x), cfg_j, "swiglu")
    tp = params_from_numpy(params)
    xt = torch.from_numpy(x)
    y_t, aux_t = mlp.moe_ffn(tp, xt, cfg_t, "swiglu")
    assert y_t.shape == x.shape and y_t.dtype == torch.float32

    experts_j, kept_j = _reference_plan(params, x, cfg_j)
    xf = xt.reshape(-1, x.shape[-1])
    route = mlp.moe_route(tp, xf, cfg_t)
    np.testing.assert_array_equal(route.experts.numpy(), experts_j)
    cap = mlp.moe_capacity(xf.shape[0], cfg_t)
    plan = mlp.moe_slots(route.experts, cfg_t.n_experts, cap)
    kept_t = torch.zeros_like(plan.keep)
    kept_t[plan.order] = plan.keep
    np.testing.assert_array_equal(kept_t.numpy(), kept_j)
    n_drop = int((~kept_t).sum())
    assert (n_drop > 0) == (cf < 2), n_drop     # each case drops or not
    # the buffer's rows hold exactly the kept assignments' tokens
    T = xf.shape[0]
    kept_slots = plan.slot[plan.keep]
    assert kept_slots.unique().numel() == kept_slots.numel()
    assert torch.equal(plan.source[kept_slots],
                       plan.order[plan.keep] // cfg_t.top_k)
    empty = torch.ones(plan.source.numel(), dtype=torch.bool)
    empty[kept_slots] = False
    assert bool((plan.source[empty] == T).all())

    assert _scaled_err(y_t, y_j) <= Y_TOL
    assert abs(float(aux_t) - float(aux_j)) <= AUX_TOL


@pytest.mark.parametrize("shape", list(SHAPES))
def test_moe_ffn_bf16_matches_reference(shape):
    """Matrices (the router too) in bf16, as ``cast_params`` and the
    reference's per-use cast give them; x in bf16."""
    cfg_j, cfg_t, params, x = _moe_case(shape, 1.25, seed=1)
    pj = jax_cast(jax.tree_util.tree_map(jnp.asarray, params), jnp.bfloat16)
    y_j, aux_j = jax_mlp.moe_ffn(pj, jnp.asarray(x, jnp.bfloat16), cfg_j,
                                 "swiglu")
    tp = cast_block_params(params_from_numpy(params), torch.bfloat16)
    assert tp["router"].dtype == torch.bfloat16
    y_t, aux_t = mlp.moe_ffn(tp, torch.from_numpy(x).bfloat16(), cfg_t,
                             "swiglu")
    assert y_t.dtype == torch.bfloat16
    assert _scaled_err(y_t, y_j.astype(jnp.float32)) <= BF16_TOL
    assert abs(float(aux_t) - float(aux_j)) <= AUX_TOL


def test_forced_route_keeps_own_gate_values():
    """``moe_route(..., experts=)``: the choices as given, the gate values
    the router's own probabilities there, renormalised; forcing its own
    top-k changes nothing."""
    _, cfg, params, x = _moe_case("granite_routing", 1.25)
    tp = params_from_numpy(params)
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1])
    own = mlp.moe_route(tp, xf, cfg)
    same = mlp.moe_route(tp, xf, cfg, experts=own.experts)
    assert torch.equal(same.gate, own.gate) and torch.equal(same.aux, own.aux)
    other = own.experts.roll(1, dims=0)
    forced = mlp.moe_route(tp, xf, cfg, experts=other)
    assert torch.equal(forced.experts, other)
    want = own.probs.gather(-1, other)
    torch.testing.assert_close(forced.gate, want / want.sum(-1, keepdim=True))


def test_combine_is_a_per_token_sum():
    """The combine gathers each token's contributions and adds them in
    ascending expert order, without atomics: the same bits every call,
    and within bf16 rounding of an explicit per-token sum in that order
    (the batched products may round apart from one row's)."""
    _, cfg, params, x = _moe_case("granite_routing", 1.25, seed=2)
    tp = cast_block_params(params_from_numpy(params), torch.bfloat16)
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1]).bfloat16()
    route = mlp.moe_route(tp, xf, cfg)
    y = mlp.moe_experts(tp, xf, route, cfg, "swiglu")
    assert torch.equal(y, mlp.moe_experts(tp, xf, route, cfg, "swiglu"))
    # the same function with no capacity limit, summed token by token
    big = dataclasses.replace(cfg, capacity_factor=64.0)
    y_all = mlp.moe_experts(tp, xf, route, big, "swiglu")
    for t in (0, 7, 31):
        acc = None
        for k in route.experts[t].argsort():
            e = int(route.experts[t, k])
            h = torch.nn.functional.silu(xf[t] @ tp["w_gate"][e]) * (
                xf[t] @ tp["w_up"][e])
            c = route.gate[t, k].bfloat16() * (h @ tp["w_down"][e])
            acc = c if acc is None else acc + c
        torch.testing.assert_close(y_all[t], acc, rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------ whole model
def _reduced(arch, cf=None, **kw):
    cfg_j = dataclasses.replace(jax_get_config(arch).reduced(),
                                compute_dtype="float32", **kw)
    cfg_t = dataclasses.replace(get_config(arch).reduced(),
                                compute_dtype="float32", **kw)
    if cf is not None:
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
            cfg_j.moe, capacity_factor=cf))
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, capacity_factor=cf))
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    return cfg_j, cfg_t


def perturbed_params(cfg_j, seed):
    """The reference's initial parameters with its vectors perturbed, so
    every norm scale counts."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.3).astype(x.dtype)
        if x.ndim - 1 <= 1 and x.shape[-1] <= 512 else x,
        jax.tree_util.tree_map(np.asarray, jax_tf.init_params(
            cfg_j, jax.random.PRNGKey(seed))))


def model_batch(cfg, seed, n_steps=S):
    """Numpy inputs for ``cfg``'s frontend: tokens, frames (audio stub)
    and patches (vision stub), over ``n_steps`` positions of input."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"frames": (rng.standard_normal((B, n_steps, cfg.d_model))
                           * 0.5).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n_steps)).astype(
        np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patches"] = (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * 0.5).astype(np.float32)
    return batch


def _split(batch, lo, hi):
    """The batch's step inputs (tokens or frames) [lo, hi); patches only
    with the prompt."""
    out = {k: v[:, lo:hi] for k, v in batch.items() if k != "patches"}
    if lo == 0 and "patches" in batch:
        out["patches"] = batch["patches"]
    return out


def run_jax(cfg, params, batch):
    """train logits, aux; prefill logits, aux; decode logits, aux per step."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    off = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    full, _, aux = jax_tf.model_apply(jp, cfg, jb(batch))
    out = [(full, aux)]
    state = jax_tf.init_decode_state(cfg, B, CACHE + off, dtype=jnp.float32)
    pre, state, aux = jax_tf.model_apply(jp, cfg, jb(_split(batch, 0, SPLIT)),
                                         mode="prefill", state=state)
    out.append((pre, aux))
    for i in range(SPLIT, S):
        lg, state, aux = jax_tf.model_apply(
            jp, cfg, jb(_split(batch, i, i + 1)), mode="decode", state=state,
            cache_pos=i + off)
        out.append((lg[:, 0], aux))
    return out


def run_port(cfg, params, batch):
    tp = transformer.cast_params(params_from_numpy(params), cfg)
    tb = lambda b: {k: torch.from_numpy(v).long() if k == "tokens"
                    else torch.from_numpy(v) for k, v in b.items()}
    off = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    full, _, aux = transformer.model_apply(tp, cfg, tb(batch))
    out = [(full, aux)]
    state = transformer.init_decode_state(cfg, B, CACHE + off,
                                          dtype=torch.float32, device="cpu")
    pre, state, aux = transformer.model_apply(
        tp, cfg, tb(_split(batch, 0, SPLIT)), mode="prefill", state=state)
    out.append((pre, aux))
    for i in range(SPLIT, S):
        lg, state, aux = transformer.model_apply(
            tp, cfg, tb(_split(batch, i, i + 1)), mode="decode", state=state,
            cache_pos=i + off)
        out.append((lg[:, 0], aux))
    return out


def assert_model_matches(cfg_j, cfg_t, params, batch):
    ref = run_jax(cfg_j, params, batch)
    got = run_port(cfg_t, params, batch)
    off = cfg_t.n_patches if cfg_t.frontend == "vision_stub" else 0
    assert got[0][0].shape == (B, S + off, cfg_t.vocab)
    errs = [_scaled_err(g, r) for (g, _), (r, _) in zip(got, ref)]
    assert max(errs) <= F32_TOL, errs
    auxes = [abs(float(g) - float(r)) for (_, g), (_, r) in zip(got, ref)]
    assert max(auxes) <= AUX_TOL, auxes
    return got


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "qwen3_moe_235b_a22b"])
def test_reduced_moe_model_matches_reference(arch):
    cfg_j, cfg_t = _reduced(arch)
    got = assert_model_matches(cfg_j, cfg_t, perturbed_params(cfg_j, 3),
                               model_batch(cfg_t, 4))
    assert float(got[0][1]) > 0                  # the layers' aux, summed
    # decode: 2 tokens, top-2 of 4 experts -> capacity 1, drops
    assert mlp.moe_capacity(B, cfg_t.moe) == 1


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "qwen3_moe_235b_a22b"])
def test_moe_prefill_decode_matches_own_forward(arch):
    _, cfg = _reduced(arch, cf=16.0)
    got = run_port(cfg, perturbed_params(_reduced(arch)[0], 5),
                   model_batch(cfg, 6))
    full = got[0][0]
    np.testing.assert_allclose(got[1][0].numpy(), full[:, :SPLIT].numpy(),
                               rtol=2e-3, atol=2e-3)
    for i, (lg, _) in zip(range(SPLIT, S), got[2:]):
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_moe_params_round_trip_and_cast():
    cfg_j, cfg_t = _reduced("granite_moe_3b_a800m")
    ref = jax.tree_util.tree_map(np.asarray, jax_tf.init_params(
        cfg_j, jax.random.PRNGKey(0)))
    back = params_to_numpy(params_from_numpy(ref))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(back)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(back)))
    mine = params_to_numpy(transformer.init_params(cfg_t, 0, device="cpu"))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(mine)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(
        jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(mine)))
    cast = transformer.cast_params(
        params_from_numpy(ref),
        dataclasses.replace(cfg_t, compute_dtype="bfloat16"))
    moe = cast["unit"][0]["moe"]
    assert {k: v.dtype for k, v in moe.items()} == dict.fromkeys(
        ("router", "w_gate", "w_up", "w_down"), torch.bfloat16)
    assert cast["unit"][0]["ln2"].dtype == torch.float32
