"""The port's ``shard_map`` MoE dispatch against the reference's, on the
CPU.

The reduced qwen3-moe layer (E 4, top-2, d_model 64) from one set of
numpy parameters and inputs (a seeded generator), x of shape (4, 16, D)
with a shared direction that skews the routing, and the loss sum(y²) + aux, at the default capacity factor (1.25: some
assignments are dropped) and at 8 (none are):

- the reference's ``moe_ffn`` with ``dispatch="shard_map"`` jitted on
  four XLA host devices, ``make_host_mesh(2, 2)``, in a subprocess;
- the port's on four gloo ranks (subprocesses), mesh (2, 2), the
  parameters laid out by ``param_specs``, x split over 'data'.

Held: each shard's kept and dropped assignments equal (the reference's
counted from its own top-k on the shard's tokens, at the shard's
capacity); y within 1e-6 of max(1, |y|), aux within 1e-6; the loss and
every gradient leaf within 1e-5 of max(1, |ref|).  The aux loss is the
mean over the batch shards of each shard's Switch loss (the reference's),
so at capacity factor 8 the port's shard_map equals, within 1e-5, the
gspmd plan run on each batch shard, and the loss differs from the one
global gspmd run.

The fallbacks, in-process: without a mesh ``dispatch="shard_map"`` is
bit-equal to ``gspmd``; on a mesh whose 'model' size does not divide E
(a fake (1, 3) group) it is the gspmd plan, bit for bit, and equals the
reference's shard_map config on three host devices within 1e-5.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import destroy_sizing_mesh, make_sizing_mesh
from repro_torch.models import mlp
from repro_torch.parallel.annotate import use_mesh

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
ARCH = "qwen3_moe_235b_a22b"
FACTORS = (1.25, 8.0)
X_SHAPE = (4, 16)
Y_TOL, AUX_TOL, GRAD_TOL = 1e-6, 1e-6, 1e-5


def layer_inputs(seed: int = 0) -> dict:
    """Numpy parameters of the reduced layer (the reference's init
    distribution) and x, from ``seed``."""
    cfg = get_config(ARCH).reduced()
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    rng = np.random.default_rng(seed)

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"router": normal(D, E, scale=np.sqrt(1.0 / D)),
            "w_gate": normal(E, D, F, scale=np.sqrt(1.0 / D)),
            "w_up": normal(E, D, F, scale=np.sqrt(1.0 / D)),
            "w_down": normal(E, F, D, scale=np.sqrt(1.0 / F)),
            # a shared direction skews the routing: experts overflow
            "x": (rng.standard_normal((*X_SHAPE, D))
                  + 2.0 * rng.standard_normal(D)).astype(np.float32)}


def run_gloo(tmp_path, code: str, n: int = 4, timeout: int = 400,
             env: dict | None = None) -> list:
    """``code`` on ``n`` gloo ranks, subprocesses on a file store; each
    reads RANK / WORLD / INIT from the environment.  -> their stdouts;
    raises with a rank's stderr if one fails."""
    script = tmp_path / "rank.py"
    script.write_text(code)
    init = tmp_path / "store"
    base = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": SRC,
            "WORLD": str(n), "INIT": f"file://{init}", **(env or {})}
    procs = [subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**base, "RANK": str(r)})
             for r in range(n)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    return [o for o, _ in outs]


REFERENCE = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.launch.mesh import _auto, make_host_mesh
from repro.models import mlp
inp = pickle.load(open({inputs!r}, "rb"))
cfg = get_config({arch!r}).reduced()
params = {{k: jnp.asarray(v) for k, v in inp.items() if k != "x"}}
x = jnp.asarray(inp["x"])
out = {{}}
for cf in {factors!r}:
    moe = dataclasses.replace(cfg.moe, dispatch="shard_map",
                              capacity_factor=cf)

    def loss(p, x):
        y, aux = mlp.moe_ffn(p, x, moe, cfg.act)
        return (y * y).sum() + aux, (y, aux)
    mesh = make_host_mesh(2, 2)
    with jax.set_mesh(mesh):
        (l, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
    # each shard's kept / dropped assignments: its tokens' top-k, its
    # experts, its capacity (the reference's expressions)
    counts = []
    E, K, D = moe.n_experts, moe.top_k, cfg.d_model
    for d in range(2):
        xf = np.asarray(x[2 * d:2 * d + 2]).reshape(-1, D)
        probs = jax.nn.softmax(jnp.asarray(xf) @ params["router"], axis=-1)
        _, e = jax.lax.top_k(probs, K)
        e = np.asarray(e).reshape(-1)
        cap = int(max(1, round(xf.shape[0] * K / E * cf)))
        for r in range(2):
            own = np.bincount(e, minlength=E)[r * E // 2:(r + 1) * E // 2]
            kept = int(np.minimum(own, cap).sum())
            counts.append([kept, int(own.sum()) - kept])
    out[cf] = {{"loss": float(l), "y": np.asarray(y),
                "aux": float(aux), "counts": counts,
                "grads": {{**{{k: np.asarray(v) for k, v in gp.items()}},
                           "x": np.asarray(gx)}}}}
# a 'model' axis of 3 does not divide E = 4: the gspmd plan
moe = dataclasses.replace(cfg.moe, dispatch="shard_map")
mesh = jax.make_mesh((1, 3), ("data", "model"), devices=jax.devices()[:3],
                     axis_types=_auto(2))
with jax.set_mesh(mesh):
    out["model3"] = np.asarray(jax.jit(
        lambda p, x: mlp.moe_ffn(p, x, moe, cfg.act)[0])(params, x))
pickle.dump(out, open({out!r}, "wb"))
"""

PORT = """
import dataclasses, os, pickle
import torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=world)
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import mlp
from repro_torch.parallel.annotate import use_mesh
from repro_torch.parallel.sharding import param_specs, to_placements
inp = pickle.load(open({inputs!r}, "rb"))
cfg = get_config({arch!r}).reduced()
mesh = make_host_mesh(2, 2)
specs = param_specs({{"unit": [{{"moe": {{k: inp[k][None] for k in inp
                                         if k != "x"}}}}]}}, mesh, cfg)
specs = specs["unit"][0]["moe"]
out = {{}}
for cf in {factors!r}:
    moe = dataclasses.replace(cfg.moe, dispatch="shard_map",
                              capacity_factor=cf)
    params = {{k: distribute_tensor(torch.tensor(v), mesh, to_placements(
        specs[k][1:], mesh)).requires_grad_() for k, v in inp.items()
        if k != "x"}}
    x = distribute_tensor(torch.tensor(inp["x"]), mesh,
                          [Shard(0), Replicate()]).requires_grad_()
    with use_mesh(mesh):
        y, aux = mlp.moe_ffn(params, x, moe, cfg.act)
        loss = (y * y).sum() + aux
        grads = torch.autograd.grad(loss, [*params.values(), x])
    # this rank's plan of its shard
    coord = mesh.get_coordinate()
    xl = x.to_local().detach().reshape(-1, cfg.d_model)
    n_local = moe.n_experts // 2
    plan = mlp.local_plan({{"router": torch.tensor(inp["router"])}}, xl, moe,
                          coord[1] * n_local, n_local)
    counts = [None] * world
    dist.all_gather_object(counts, [coord, list(plan.kept_dropped())])
    full = lambda t: t.full_tensor().detach().numpy()
    out[cf] = {{"loss": float(loss.full_tensor()), "y": full(y),
                "aux": float(aux.full_tensor()),
                "placements": [str(y.placements), str(aux.placements)],
                "counts": [c for _, c in sorted(counts)],
                "grads": {{k: full(g) for k, g in zip([*params, "x"],
                                                      grads)}}}}
if rank == 0:
    pickle.dump(out, open({out!r}, "wb"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_dispatch")
    inputs = root / "inputs.pkl"
    pickle.dump(layer_inputs(), open(inputs, "wb"))
    ref_out, port_out = root / "ref.pkl", root / "port.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE.format(
            inputs=str(inputs), arch=ARCH, factors=FACTORS,
            out=str(ref_out))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    run_gloo(root, PORT.format(inputs=str(inputs), arch=ARCH,
                               factors=FACTORS, out=str(port_out)))
    _, err = ref.communicate(timeout=400)
    assert ref.returncode == 0, err[-4000:]
    return pickle.load(open(ref_out, "rb")), pickle.load(open(port_out,
                                                              "rb"))


def _scaled(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("cf", FACTORS)
def test_shard_map_matches_reference(runs, cf):
    ref, port = runs[0][cf], runs[1][cf]
    print(cf, {"y": _scaled(port["y"], ref["y"]),
               "aux": port["aux"] - ref["aux"],
               "loss": port["loss"] - ref["loss"],
               **{k: _scaled(port["grads"][k], v)
                  for k, v in ref["grads"].items()}})
    assert port["counts"] == ref["counts"]
    dropped = sum(d for _, d in ref["counts"])
    assert (dropped > 0) == (cf < 2), ref["counts"]
    assert port["placements"] == ["(Shard(dim=0), Replicate())",
                                  "(Replicate(), Replicate())"]
    assert _scaled(port["y"], ref["y"]) <= Y_TOL
    assert abs(port["aux"] - ref["aux"]) <= AUX_TOL
    assert abs(port["loss"] - ref["loss"]) <= GRAD_TOL * max(
        1.0, abs(ref["loss"]))
    assert set(port["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
        assert _scaled(port["grads"][k], g) <= GRAD_TOL, k


def _torch_params(inp):
    return {k: torch.tensor(v) for k, v in inp.items() if k != "x"}


def test_shard_map_is_each_shards_gspmd_without_drops(runs):
    """At capacity factor 8 nothing drops: y is the gspmd plan run on
    each batch shard, aux the mean of the two shards' losses."""
    inp = layer_inputs()
    cfg = get_config(ARCH).reduced()
    moe = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    x = torch.tensor(inp["x"])
    ys, auxes = zip(*(mlp.moe_ffn(_torch_params(inp), x[2 * d:2 * d + 2],
                                  moe, cfg.act) for d in range(2)))
    port = runs[1][8.0]
    assert _scaled(port["y"], torch.cat(ys).numpy()) <= Y_TOL
    assert abs(port["aux"] - float((auxes[0] + auxes[1]) / 2)) <= AUX_TOL
    _, aux_all = mlp.moe_ffn(_torch_params(inp), x, moe, cfg.act)
    assert abs(port["aux"] - float(aux_all)) > AUX_TOL


def test_dispatch_fallbacks(runs):
    inp = layer_inputs()
    cfg = get_config(ARCH).reduced()
    sm = dataclasses.replace(cfg.moe, dispatch="shard_map")
    x = torch.tensor(inp["x"])
    params = _torch_params(inp)
    want = mlp.moe_ffn(params, x, cfg.moe, cfg.act)
    got = mlp.moe_ffn(params, x, sm, cfg.act)             # no mesh
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    try:
        mesh = make_sizing_mesh({"data": 1, "model": 3})
        assert not mlp.shard_map_applies(sm, mesh)
        with use_mesh(mesh):
            got = mlp.moe_ffn(params, x, sm, cfg.act)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert mlp.shard_map_applies(sm, make_sizing_mesh({"data": 2,
                                                           "model": 2}))
    finally:
        destroy_sizing_mesh()
    assert _scaled(want[0].numpy(), runs[0]["model3"]) <= GRAD_TOL
    assert not mlp.shard_map_applies(sm, None)

