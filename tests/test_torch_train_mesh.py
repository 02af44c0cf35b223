"""The port's sharded LM training (``launch/train.py::train_loop`` over a
device mesh) against the reference's, on the CPU.

One launch of four gloo ranks (subprocesses, mesh ``make_host_mesh(2,
2)``) runs, in turn:

- the driver's loop for 3 steps on reduced olmo-1b and on reduced
  qwen3-moe with ``dispatch="shard_map"``, in fp32, from the reference's
  initial parameters and on the same stream (batch 4 x 16), against the
  reference's loop jitted on four XLA host devices with its
  ``param_specs`` / ``opt_specs`` / ``data_specs`` as in and out
  shardings (the code of ``repro/launch/train.py::main``, copied into
  the reference's script).  Every step's loss and grad_norm within
  ``LOSS_TOL`` (tests/test_torch_launch_train.py's bar) of max(1, |ref|),
  the final parameters within 1e-5 of max(1, |p|) leaf by leaf, and no
  operator run whole on the mesh for olmo;
- one sharded step of each of the ten reduced configs in fp64 (the
  parameters cast, so that what is held is the layout and the
  reductions, not fp32 summation order), against the one-process step:
  loss, grad_norm and every parameter within 1e-5 of max(1, |ref|), no
  operator run whole; or ``check_sharded``'s ``NotImplementedError``
  (the MoEs' gspmd dispatch, ROADMAP A12.5.5);
- checkpoints across layouts, the driver's own run of
  tests/test_torch_launch_train.py (reduced olmo, 6 steps, a checkpoint
  every 2, batch 2): unbroken; resumed from its step-2 checkpoint (the
  final ``arrays.msgpack`` the same bytes); and resumed from the
  reference driver's step-2 checkpoint.  In-process, the reference's
  driver resumes the sharded run's step-2 checkpoint, and the sharded
  checkpoints are held against the one-process runs' within
  tests/test_torch_launch_train.py's step bars.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import destroy_sizing_mesh, make_sizing_mesh
from repro_torch.train.checkpoint import read_manifest

from test_torch_launch_train import (BATCH, EVERY, LR, RESUME, SEQ, STEPS,
                                     assert_within_step_bars, cut_to,
                                     run_port, run_reference)
from test_torch_lm_train import LOSS_TOL
from test_torch_moe_dispatch import SRC, run_gloo
from test_torch_pretrain import one_thread_a_process  # noqa: F401

DRIVER_RUNS = (("olmo_1b", None), ("qwen3_moe_235b_a22b", "shard_map"))
D_STEPS, D_BATCH, D_SEQ = 3, 4, 16
PARAM_TOL = 1e-5

REFERENCE = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.launch.mesh import make_host_mesh
from repro.models.steps import make_train_step
from repro.models.transformer import init_params
from repro.parallel.sharding import data_specs, opt_specs, param_specs
from repro.train.data import DataConfig, SyntheticTokenStream
from repro.train.optim import adamw_init, cosine_schedule
STEPS, BATCH, SEQ, LR = {steps}, {batch}, {seq}, {lr}
out = {{}}
for arch, dispatch in {runs!r}:
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    if dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    mesh = make_host_mesh(2, 2)
    # repro/launch/train.py::main's loop
    params = init_params(cfg, jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.array, params)
    opt_state = adamw_init(params)
    pspecs = param_specs(params, mesh, cfg)
    ospecs = opt_specs(opt_state, pspecs)
    sched = cosine_schedule(LR, LR * 0.1, STEPS,
                            warmup=max(STEPS // 20, 1))
    step_fn = make_train_step(cfg, lr_schedule=sched)
    data = SyntheticTokenStream(cfg, DataConfig(SEQ, BATCH, seed=0))
    sample = data.next_batch()
    data.restore({{"step": data.step - 1}})
    bspecs = data_specs(sample, mesh)
    metrics = []
    with jax.set_mesh(mesh):
        jitted = jax.jit(step_fn,
                         in_shardings=(pspecs, ospecs, bspecs, None),
                         out_shardings=(pspecs, ospecs, None),
                         donate_argnums=(0, 1))
        for step in range(STEPS):
            batch = data.next_batch()
            params, opt_state, m = jitted(params, opt_state, batch,
                                          jnp.asarray(step, jnp.int32))
            metrics.append({{k: float(m[k]) for k in ("loss",
                                                     "grad_norm")}})
    out[arch] = {{"init": init, "metrics": metrics,
                  "final": jax.tree_util.tree_map(np.array, params)}}
pickle.dump(out, open({out!r}, "wb"))
"""

PORT = """
import dataclasses, os, pickle, shutil, traceback
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=world)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.nn import tree_leaves, tree_map
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import check_sharded, train_loop
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.steps import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.parallel.annotate import use_mesh
from repro_torch.parallel.replicated_ops import count_replicated
from repro_torch.parallel.sharding import data_specs, param_specs, shard_tree
from repro_torch.train.data import DataConfig, SyntheticTokenStream
from repro_torch.train.optim import adamw_init
mesh = make_host_mesh(2, 2)
ref = pickle.load(open({ref!r}, "rb"))
full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
out = {{"driver": {{}}, "configs": {{}}}}
# the driver's loop from the reference's initial parameters
for arch, dispatch in {runs!r}:
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    if dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    res = train_loop(cfg, steps={steps}, batch={batch}, seq={seq},
                     lr={lr}, device="cpu", mesh=mesh,
                     init=params_from_numpy(ref[arch]["init"]))
    out["driver"][arch] = {{
        "metrics": [{{k: float(m[k]) for k in ("loss", "grad_norm")}}
                    for m in res.metrics],
        "final": params_to_numpy(tree_map(full, res.params)),
        "replicated": res.replicated}}
# one sharded step of each config in fp64 against the one-process step
for arch in ARCH_IDS:
    cfg = get_config(arch).reduced()
    try:
        check_sharded(cfg, mesh)
    except NotImplementedError as e:
        out["configs"][arch] = {{"raised": str(e)}}
        continue
    params = tree_map(torch.Tensor.double, init_params(cfg, 0, "cpu"))
    batch = SyntheticTokenStream(cfg, DataConfig(16, 4, seed=0),
                                 "cpu").next_batch()
    step = make_train_step(cfg, lr_schedule=1e-4)
    p1, _, m1 = step(params, adamw_init(params), batch, 0)
    sp = shard_tree(params, param_specs(params, mesh, cfg), mesh)
    sb = shard_tree(batch, data_specs(batch, mesh), mesh)
    with use_mesh(mesh), count_replicated() as counts:
        p2, _, m2 = step(sp, adamw_init(sp), sb, 0)
    err = max(float((full(a) - b).abs().max() / max(1.0, b.abs().max()))
              for a, b in zip(tree_leaves(p2), tree_leaves(p1)))
    out["configs"][arch] = {{
        "loss": [float(m1["loss"]), float(full(m2["loss"]))],
        "grad_norm": [float(m1["grad_norm"]), float(full(m2["grad_norm"]))],
        "param_err": err, "replicated": dict(counts)}}
# checkpoints: unbroken, resumed, and resumed from the reference's
root = {root!r}
cfg = dataclasses.replace(get_config("olmo_1b").reduced(),
                          compute_dtype="float32")
kw = dict(steps={ck_steps}, batch={ck_batch}, seq={ck_seq}, lr={lr},
          ckpt_every={ck_every}, log_every=1, device="cpu", mesh=mesh)
train_loop(cfg, ckpt_dir=root + "/sharded", **kw)
for src, dst in (("sharded", "sharded_resumed"), ("ref", "ref_to_sharded")):
    if rank == 0:
        shutil.copytree(root + "/" + src, root + "/" + dst)
        for d in os.listdir(root + "/" + dst):
            if d.startswith("step_") and int(d.split("_")[1]) > {resume}:
                shutil.rmtree(root + "/" + dst + "/" + d)
    dist.barrier()
    res = train_loop(cfg, ckpt_dir=root + "/" + dst, **kw)
    out[dst] = {{"start": res.start}}
if rank == 0:
    pickle.dump(out, open({out!r}, "wb"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_mesh")
    ref_out, port_out = root / "ref.pkl", root / "port.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE.format(
            steps=D_STEPS, batch=D_BATCH, seq=D_SEQ, lr=LR,
            runs=DRIVER_RUNS, out=str(ref_out))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    # the one-process drivers' runs: the reference's checkpoints the
    # sharded loop resumes, the port's the sharded checkpoints are held to
    run_reference(root / "ref")
    port_res, port_log = run_port(root / "port")
    _, err = ref.communicate(timeout=400)
    assert ref.returncode == 0, err[-4000:]
    run_gloo(root, PORT.format(
        ref=str(ref_out), runs=DRIVER_RUNS, steps=D_STEPS, batch=D_BATCH,
        seq=D_SEQ, lr=LR, root=str(root), ck_steps=STEPS,
        ck_batch=BATCH, ck_seq=SEQ, ck_every=EVERY, resume=RESUME, out=str(port_out)),
        timeout=600)
    return {"root": root, "ref": pickle.load(open(ref_out, "rb")),
            "port": pickle.load(open(port_out, "rb"))}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [np.asarray(tree)]


@pytest.mark.parametrize("arch", [a for a, _ in DRIVER_RUNS])
def test_sharded_driver_matches_reference(runs, arch):
    ref, port = runs["ref"][arch], runs["port"]["driver"][arch]
    assert len(port["metrics"]) == len(ref["metrics"]) == D_STEPS
    for s, (got, want) in enumerate(zip(port["metrics"], ref["metrics"])):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= LOSS_TOL * max(
                1.0, abs(want[k])), (s, k, got[k], want[k])
    got, want = _leaves(port["final"]), _leaves(ref["final"])
    assert len(got) == len(want)
    errs = [float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
            for a, b in zip(got, want)]
    print(arch, "param errors", max(errs), "replicated", port["replicated"])
    assert max(errs) <= PARAM_TOL
    if arch == "olmo_1b":
        assert port["replicated"] == {}


def test_all_configs_take_a_sharded_step(runs):
    configs = runs["port"]["configs"]
    assert len(configs) == 10
    raised = sorted(a for a, r in configs.items() if "raised" in r)
    assert raised == ["granite_moe_3b_a800m", "qwen3_moe_235b_a22b"]
    for arch in raised:
        assert "A12.5.5" in configs[arch]["raised"]
    for arch, r in configs.items():
        if arch in raised:
            continue
        print(arch, r)
        for k in ("loss", "grad_norm"):
            one, sharded = r[k]
            assert abs(sharded - one) <= 1e-5 * max(1.0, abs(one)), (arch, k)
        assert r["param_err"] <= 1e-5, arch
        assert r["replicated"] == {}, arch


def test_sharded_checkpoints_resume_across_layouts(runs):
    root, port = runs["root"], runs["port"]
    last = f"step_{STEPS - 1:09d}"
    assert sorted(p.name for p in (root / "sharded").glob("step_*")) == [
        "step_000000002", "step_000000004", "step_000000005"]
    assert port["sharded_resumed"]["start"] == RESUME + 1
    assert port["ref_to_sharded"]["start"] == RESUME + 1
    # resumed = unbroken, byte for byte
    assert (root / "sharded_resumed" / last / "arrays.msgpack").read_bytes() \
        == (root / "sharded" / last / "arrays.msgpack").read_bytes()
    assert read_manifest(root / "sharded_resumed", STEPS - 1)["extra"] == \
        read_manifest(root / "sharded", STEPS - 1)["extra"]
    # the sharded run against the one-process port's, and the sharded
    # loop's resume of the reference's checkpoint against the reference
    assert_within_step_bars(root / "sharded", root / "port")
    assert_within_step_bars(root / "ref_to_sharded", root / "ref")
    # the reference's driver resumes the sharded checkpoint
    run_reference(cut_to(root / "sharded", root / "sharded_to_ref", RESUME))
    assert_within_step_bars(root / "sharded_to_ref", root / "sharded")


def test_mesh_edges():
    cfg = port_train.get_config("granite_moe_3b_a800m").reduced()
    try:
        mesh = make_sizing_mesh({"data": 2, "model": 2})
        with pytest.raises(NotImplementedError, match="A12.5.5"):
            port_train.check_sharded(cfg, mesh)
        sm = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="shard_map"))
        port_train.check_sharded(sm, mesh)
        port_train.check_sharded(cfg, None)
    finally:
        destroy_sizing_mesh()


@pytest.mark.parametrize("H,Hkv,m", [(8, 8, 4), (16, 2, 8), (4, 1, 2),
                                     (12, 3, 2)])
def test_kernel_wrappers_run_on_local_shards(H, Hkv, m):
    """``flash_attention`` and ``ssd_scan`` on DTensors split over the
    heads of a (1, m) mesh (a fake group, each rank in turn; CPU shards:
    the plain versions): each rank's result is its heads of the
    one-device call, with the input's placements; K and V replicated
    give each rank the KV heads its query heads map to; heads that
    straddle a group raise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_scan import ops as ssd_ops
    gen = torch.Generator().manual_seed(H * m)
    q, k, v = (torch.randn(2, 24, h, 8, generator=gen) for h in (H, Hkv, Hkv))
    full = fa_ops.flash_attention(q, k, v)
    sq, sk, sv = (torch.randn(2, 24, H, 4, generator=gen) for _ in range(3))
    log_a = -torch.nn.functional.softplus(torch.randn(2, 24, H,
                                                      generator=gen))
    y, st = ssd_ops.ssd_scan(sq, sk, sv, log_a, 8)
    Hl = H // m

    def heads(t, mesh, r, dim=2):
        n = t.shape[dim] // m
        return DTensor.from_local(t.narrow(dim, r * n, n), mesh,
                                  [Replicate(), Shard(dim)], run_check=False)
    try:
        for r in range(m):
            mesh = make_sizing_mesh({"data": 1, "model": m}, rank=r)
            dq = heads(q, mesh, r)
            dk, dv = ((heads(t, mesh, r) if Hkv % m == 0 else
                       DTensor.from_local(t, mesh, [Replicate()] * 2,
                                          run_check=False)) for t in (k, v))
            if Hl % (H // Hkv) and (H // Hkv) % Hl:
                with pytest.raises(ValueError, match="whole groups"):
                    fa_ops.flash_attention(dq, dk, dv)
                continue
            out = fa_ops.flash_attention(dq, dk, dv)
            assert tuple(out.placements) == tuple(dq.placements)
            torch.testing.assert_close(out.to_local(),
                                       full[:, :, r * Hl:(r + 1) * Hl],
                                       rtol=0, atol=1e-6)
            dy, dst = ssd_ops.ssd_scan(
                *(heads(t, mesh, r) for t in (sq, sk, sv, log_a)), 8)
            torch.testing.assert_close(dy.to_local(),
                                       y[:, :, r * Hl:(r + 1) * Hl],
                                       rtol=0, atol=1e-6)
            torch.testing.assert_close(dst.to_local(),
                                       st[:, r * Hl:(r + 1) * Hl],
                                       rtol=0, atol=1e-6)
    finally:
        destroy_sizing_mesh()


def test_sharded_save_gathers_one_leaf_at_a_time(tmp_path, monkeypatch):
    """A save of DTensor leaves (a one-rank gloo group) writes the same
    bytes, in the same leaf order, as the save of their plain tensors,
    and moves each gathered leaf to the host before it gathers the
    next."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.train import checkpoint as ckpt
    gen = torch.Generator().manual_seed(32)
    plain = {"b": [torch.randn(3, 5, generator=gen), None,
                   torch.randn(7, generator=gen)],
             "a": {"w": torch.randn(4, 2, generator=gen),
                   "n": torch.arange(6, dtype=torch.int32)}}
    destroy_sizing_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        shards = {"b": [distribute_tensor(plain["b"][0], mesh, [Shard(1)]),
                        None, plain["b"][2]],
                  "a": {"w": distribute_tensor(plain["a"]["w"], mesh,
                                               [Replicate()]),
                        "n": distribute_tensor(plain["a"]["n"], mesh,
                                               [Shard(0)])}}
        events = []
        gather, host = DTensor.full_tensor, ckpt._host
        monkeypatch.setattr(DTensor, "full_tensor", lambda self, **kw: (
            events.append("gather"), gather(self, **kw))[1])
        monkeypatch.setattr(ckpt, "_host", lambda x: (
            events.append("host"), host(x))[1])
        ckpt.save_checkpoint(tmp_path / "sharded", 1, shards)
        # flatten order: a.n, a.w, b[0] (DTensors), b[2] (plain)
        assert events == ["gather", "host"] * 3 + ["host"]
        ckpt.save_checkpoint(tmp_path / "plain", 1, plain)
        back, _ = ckpt.restore_checkpoint(tmp_path / "sharded", 1, shards)
    finally:
        dist.destroy_process_group()
    step = "step_000000001"
    assert (tmp_path / "sharded" / step / "arrays.msgpack").read_bytes() \
        == (tmp_path / "plain" / step / "arrays.msgpack").read_bytes()
    assert read_manifest(tmp_path / "sharded", 1)["index"] == \
        read_manifest(tmp_path / "plain", 1)["index"]
    assert tuple(back["b"][0].placements) == (Shard(1),)
    assert torch.equal(back["b"][0].full_tensor(), plain["b"][0])
    assert torch.equal(back["a"]["n"].to_local(), plain["a"]["n"])


def test_sharded_step_reduces_each_layer_gradient_as_it_ends(monkeypatch):
    """The traced sharded step (olmo-1b's train_4k cell on the 16 x 16
    sizing mesh, 1, 2 and 4 layers): every gradient comes out laid out as
    its parameter, and each layer adds the same bytes to the peak (its
    weights' partial sums are reduced as its backward ends, not held, a
    whole copy of the layer's weights a rank, to the end of the step), so
    the dry-run's extrapolation from one and two layers is the traced
    peak at four."""
    from repro_torch.configs.registry import SHAPES
    from repro_torch.core.nn import tree_leaves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import POD_SHAPE
    from repro_torch.models import steps
    seen = []
    vag = steps.value_and_grad

    def recording(fn, params, has_aux=False):
        out, grads = vag(fn, params, has_aux)
        seen.append([(tuple(p.placements), tuple(g.placements))
                     for p, g in zip(tree_leaves(params), tree_leaves(grads))])
        return out, grads
    monkeypatch.setattr(steps, "value_and_grad", recording)
    cfg = port_train.get_config("olmo_1b")
    mesh = make_sizing_mesh(POD_SHAPE)
    try:
        peaks = [dryrun.trace_step(dryrun.depth_cfg(cfg, d),
                                   SHAPES["train_4k"], POD_SHAPE, mesh)[
                                       "peak_bytes"] for d in (1, 2, 4)]
    finally:
        destroy_sizing_mesh()
    assert all(p == g for s in seen for p, g in s), seen
    assert peaks[2] == pytest.approx(peaks[0] + 3 * (peaks[1] - peaks[0]),
                                     rel=1e-6), peaks
