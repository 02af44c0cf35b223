"""The port's sharding rules (``repro_torch/parallel``) and step specs
(``repro_torch/models/steps.py``), held against the reference's on the
CPU.

- Specs, exact: ``param_specs``, ``opt_specs``, ``data_specs`` and
  ``decode_state_specs`` leaf for leaf (by the reference's leaf paths) for
  all ten configs at full size on meshes (1, 1), (4, 2), (16, 16) and
  (2, 16, 16).  The reference's side runs on ``jax.sharding.AbstractMesh``
  (its rules read only ``mesh.shape``), the port's on the axis sizes.
- Step specs, exact: ``input_specs``, ``param_structs`` and
  ``decode_state_structs``: shapes and dtypes for every config x shape
  cell.
- ``constrain``: a no-op without a mesh (the same tensor back); on a fake
  (16, 16) or (2, 16, 16) mesh the guarded spec equals the one the
  reference hands ``with_sharding_constraint``.
- DTensor placements: a dim over ('pod', 'data') is split pod-major, as
  JAX splits it.
- Real numbers: a gloo group of 4 ranks (mesh 2 x 2) runs a reduced olmo
  train step through the rules; its loss and updated params equal the
  single-process step within 1e-5 (the counterpart of
  ``tests/test_sharding.py``'s end-to-end step).
"""
import functools
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import get_config as ref_config
from repro.models import steps as ref_steps
from repro.parallel import annotate as ref_annotate
from repro.parallel import sharding as ref_sh
from repro_torch.configs.registry import ARCH_IDS, SHAPES, cell_supported
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import destroy_sizing_mesh, make_sizing_mesh
from repro_torch.models import steps
from repro_torch.parallel import annotate
from repro_torch.parallel import sharding as sh

MESHES = ({"data": 1, "model": 1}, {"data": 4, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
P = sh.P


def _abstract(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {ref_sh._path_str(k): tuple(v) for k, v in leaves}


def _port_flat(tree, path="") -> dict:
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, sh.PartitionSpec):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _port_flat(t, join(k)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _port_flat(t, join(i)).items()}
    return {}


def _ref_leaves(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {ref_sh._path_str(k): (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in leaves}


def _port_leaves(tree, path="") -> dict:
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _port_leaves(t, join(k)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _port_leaves(t, join(i)).items()}
    return {}


@functools.lru_cache(maxsize=2)
def _structs(arch):
    """(reference, port) parameter structs of ``arch`` at full size."""
    return (ref_steps.param_structs(ref_config(arch)),
            steps.param_structs(get_config(arch)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    cfg_r, cfg_p = ref_config(arch), get_config(arch)
    ref_ps, port_ps = _structs(arch)
    for shape in MESHES:
        rm = _abstract(shape)
        ref_p = ref_sh.param_specs(ref_ps, rm, cfg_r)
        port_p = sh.param_specs(port_ps, shape, cfg_p)
        assert _port_flat(port_p) == _ref_flat(ref_p), (arch, shape)
        ref_o = ref_sh.opt_specs(None, ref_p)
        port_o = sh.opt_specs(None, port_p)
        assert tuple(port_o.step) == tuple(ref_o.step) == ()
        assert _port_flat(port_o.mu) == _ref_flat(ref_o.mu)
        assert _port_flat(port_o.nu) == _ref_flat(ref_o.nu)
        for name, cell in SHAPES.items():
            if not cell_supported(cfg_p, name)[0]:
                continue
            rb = ref_steps.input_specs(cfg_r, cell.seq_len,
                                       cell.global_batch, cell.kind)
            pb = steps.input_specs(cfg_p, cell.seq_len, cell.global_batch,
                                   cell.kind)
            assert (_port_flat(sh.data_specs(pb, shape))
                    == _ref_flat(ref_sh.data_specs(rb, rm))), (name, shape)
            if cell.kind == "train":
                continue
            rs = ref_steps.decode_state_structs(cfg_r, cell.global_batch,
                                                cell.seq_len)
            ps = steps.decode_state_structs(cfg_p, cell.global_batch,
                                            cell.seq_len)
            assert (_port_flat(sh.decode_state_specs(ps, shape, cfg_p))
                    == _ref_flat(ref_sh.decode_state_specs(rs, rm, cfg_r))
                    ), (name, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_specs_match_reference(arch):
    cfg_r, cfg_p = ref_config(arch), get_config(arch)
    ref_ps, port_ps = _structs(arch)
    assert _port_leaves(port_ps) == _ref_leaves(ref_ps)
    assert all(t.device.type == "meta"
               for t in _tensor_leaves(port_ps)), "structs allocate nothing"
    for name, cell in SHAPES.items():
        if not cell_supported(cfg_p, name)[0]:
            continue
        rb = ref_steps.input_specs(cfg_r, cell.seq_len, cell.global_batch,
                                   cell.kind)
        pb = steps.input_specs(cfg_p, cell.seq_len, cell.global_batch,
                               cell.kind)
        assert _port_leaves(pb) == _ref_leaves(rb), name
        if cell.kind != "train":
            rs = ref_steps.decode_state_structs(cfg_r, cell.global_batch,
                                                cell.seq_len)
            ps = steps.decode_state_structs(cfg_p, cell.global_batch,
                                            cell.seq_len)
            assert _port_leaves(ps) == _ref_leaves(rs), name


def _tensor_leaves(tree) -> list:
    from repro_torch.core.nn import tree_leaves
    return tree_leaves(tree)


def test_guarded_and_batch_axes_match_reference():
    for shape in MESHES:
        rm = _abstract(shape)
        assert sh.batch_axes(shape) == ref_sh.batch_axes(rm)
        assert sh.batch_axis_size(shape) == ref_sh.batch_axis_size(rm)
        for dims, spec in (((40, 16), ("model", "data")),
                           ((64, 48), (("pod", "data"), "model")),
                           ((3, 32, 8), (None, "model", "data"))):
            assert tuple(sh.guarded(shape, dims, *spec)) == tuple(
                ref_sh.guarded(rm, dims, *spec))


def test_constrain_is_noop_without_mesh():
    x = torch.randn(4, 8, 6)
    assert annotate.get_mesh() is None
    assert annotate.constrain_batch(x) is x
    assert annotate.constrain(x, annotate.BATCH, None, "model") is x
    assert annotate.constrain_first(x, "model", (0, 1)) is x


@pytest.fixture
def fake_mesh():
    made = []

    def make(shape):
        made.append(make_sizing_mesh(shape))
        return made[-1]
    yield make
    destroy_sizing_mesh()


# (shape, spec) cases of constrain and (shape, dims) of constrain_first:
# non-dividing, absent ('pod' on one pod), smaller than the axis (MQA's
# single KV head, long_500k's batch of 1) and dividing
CONSTRAIN_CASES = [
    ((256, 4096, 2048), (annotate.BATCH, "model", None)),
    ((1, 4096, 2048), (annotate.BATCH, "model", None)),
    ((32, 4096, 8, 256), (annotate.BATCH, None, "model", None)),
    ((32, 4096, 1, 256), (annotate.BATCH, None, "model", None)),
    ((128, 1, 2048), (annotate.BATCH, "model", None)),
    ((48, 40, 2048), (annotate.BATCH, "model")),
    ((8, 4096, 50304), (annotate.BATCH, None, "model")),
]
FIRST_CASES = [((40, 328, 1536), (0, 1)), ((40, 328, 1536), (0,)),
               ((128, 20, 4096), (0,)), ((10, 15, 7), (0, 1))]


def _ref_constrained(shape, spec, mesh_shape, first=False):
    """The spec the reference hands ``with_sharding_constraint``."""
    got = []
    saved = (ref_annotate.get_abstract_mesh, jax.lax.with_sharding_constraint)
    ref_annotate.get_abstract_mesh = lambda: _abstract(mesh_shape)
    jax.lax.with_sharding_constraint = lambda x, p: got.append(p) or x
    try:
        x = jax.ShapeDtypeStruct(shape, np.float32)
        if first:
            ref_annotate.constrain_first(x, "model", spec)
        else:
            ref_annotate.constrain(x, *spec)
    finally:
        ref_annotate.get_abstract_mesh, jax.lax.with_sharding_constraint = \
            saved
    return tuple(got[0]) if got else None


@pytest.mark.parametrize("mesh_shape", MESHES[2:])
def test_constrain_guards_match_reference(fake_mesh, mesh_shape):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    mesh = fake_mesh(mesh_shape)
    fake = FakeTensorMode()
    rep = [Replicate()] * mesh.ndim
    sizes = sh.mesh_sizes(mesh)
    with fake, annotate.use_mesh(mesh):
        for shape, spec in CONSTRAIN_CASES:
            want = _ref_constrained(shape, spec, mesh_shape)
            got = annotate.guard_spec(shape, spec, sizes)
            assert tuple(got) == want, (shape, spec, mesh_shape)
            x = DTensor.from_local(torch.empty(shape), mesh, rep,
                                   run_check=False)
            y = annotate.constrain(x, *spec)
            assert tuple(y.placements) == tuple(
                sh.to_placements(want, mesh)), (shape, spec)
            assert tuple(y.shape) == shape
        for shape, dims in FIRST_CASES:
            want = _ref_constrained(shape, dims, mesh_shape, first=True)
            got = annotate.first_spec(shape, "model", dims, sizes)
            assert tuple(got) == want, (shape, dims)
            x = DTensor.from_local(torch.empty(shape), mesh, rep,
                                   run_check=False)
            y = annotate.constrain_first(x, "model", dims)
            assert tuple(y.placements) == tuple(sh.to_placements(want, mesh))


def test_two_axis_dim_is_split_pod_major():
    """('pod', 'data') on one dim: JAX splits it pod-major (device (p, d)
    holds block p * |data| + d).  Rank 5 of a (2, 2, 2) mesh sits at
    (pod 1, data 0, model 1): block 2 of 4, rows 8..11 of 16."""
    code = f"""
import sys; sys.path.insert(0, {SRC!r})
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import \\
    compute_local_shape_and_global_offset
from repro_torch.parallel.sharding import P, to_placements
dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
mesh = init_device_mesh("cpu", (2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
pl = to_placements(P(("pod", "data"), "model"), mesh)
print(compute_local_shape_and_global_offset((16, 6), mesh, pl))
dist.destroy_process_group()
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "((4, 3), (8, 3))"
    with pytest.raises(ValueError):
        class _Mesh:
            mesh_dim_names = ("pod", "data", "model")
        sh.to_placements(P(("data", "pod")), _Mesh())


GLOO_RANK = """
import json, os, sys
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs.registry import get_config
from repro_torch.core.nn import tree_leaves, tree_map
from repro_torch.launch.aten_static import trace_cost
from repro_torch.parallel.sharding import shard_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.steps import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.parallel.annotate import use_mesh
from repro_torch.parallel.sharding import data_specs, param_specs
from repro_torch.train.optim import AdamState, adamw_init
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                        rank=rank, world_size=4)
cfg = dataclasses.replace(get_config("olmo_1b").reduced(),
                          compute_dtype="float32")
params = init_params(cfg, 0, device="cpu")
rng = np.random.default_rng(0)
batch = {{k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))
         for k in ("tokens", "labels")}}
step = make_train_step(cfg, lr_schedule=1e-3)
p1, _, m1 = step(params, adamw_init(params), batch, 0)
mesh = make_host_mesh(2, 2)
dp = shard_tree(params, param_specs(params, mesh, cfg), mesh)
db = shard_tree(batch, data_specs(batch, mesh), mesh)
opt = AdamState(0, tree_map(torch.zeros_like, dp), tree_map(torch.zeros_like, dp))
with use_mesh(mesh):
    res = trace_cost(lambda p, o, b: step(p, o, b, 0), dp, opt, db,
                     n_devices=4, exact=True)
p2, _, m2 = res["out"]
err = max(float((a.full_tensor() - b).abs().max())
          for a, b in zip(tree_leaves(p2), tree_leaves(p1)))
loss2 = m2["loss"].full_tensor() if hasattr(m2["loss"], "full_tensor") \\
    else m2["loss"]
if rank == 0:
    print(json.dumps({{"loss1": float(m1["loss"]), "loss2": float(loss2),
                      "param_err": err, "fallbacks": res["fallbacks"],
                      "collectives": res["cost"].as_dict()
                      ["collective_counts"]}}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_four_ranks_train_step_matches_one_process(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(GLOO_RANK.format(src=SRC, port=_free_port()))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    print(res)
    assert res["fallbacks"] == {}
    assert sum(res["collectives"].values()) > 0, "the step communicated"
    assert abs(res["loss2"] - res["loss1"]) <= 1e-5 * max(1.0, abs(
        res["loss1"]))
    assert res["param_err"] <= 1e-5
