"""The port's dry-run (``repro_torch/launch/{aten_analysis, aten_static,
dryrun}.py``) held against the reference's (``repro/launch/{hlo_analysis,
hlo_static, dryrun}.py``) on the CPU.

- Formulas, exact: ``model_flops`` for every config and step kind, and
  ``roofline_terms``.
- Toy programs (``tests/test_substrate.py``'s two): the walker against
  ``analyze_hlo`` under that test's bars (flops 5%, bytes 25%; the scan's
  flops within [16x, 1.3 x 16x] of its body's product).
- Reduced train steps (olmo, zamba2) on mesh (1, 1): the walker's matmul
  flops within 1% of the dots of the reference's compiled step, total
  flops within 15%; the bytes ratio is printed (PERF.md records it: the
  reference prices XLA's fusion boundaries, the walker each operator's).
- Eight devices (``slow``, as the reference's own dry-run smoke test):
  olmo at full width over 2 layers, batch 8 x 256, on a (4, 2) mesh,
  against the reference compiled on 8 host devices in a subprocess:
  per-device argument bytes within 1%, total collective bytes within 2x;
  each kind's ratio is printed (GSPMD and DTensor pick different
  collectives for the same specs).
- The CLI: a supported cell carries the reference's result keys, an
  unsupported one the reference's skip reason; the fake process group is
  gone after each cell.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import get_config as ref_config
from repro.launch import hlo_analysis as ref_analysis
from repro.launch.hlo_static import HloAnalyzer, analyze_hlo
from repro_torch.configs.registry import ARCH_IDS, SHAPES, ShapeCell
from repro_torch.configs.registry import get_config
from repro_torch.launch import aten_analysis, dryrun
from repro_torch.launch.aten_static import trace_cost
from repro_torch.launch.mesh import HW_H100

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ONE = {"data": 1, "model": 1}


# ------------------------------------------------------------- formulas
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    for kind in ("train", "prefill", "decode"):
        for n in (1, 4096, 256 * 4096):
            assert aten_analysis.model_flops(get_config(arch), n, kind) == \
                ref_analysis.model_flops(ref_config(arch), n, kind)


def test_roofline_terms_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, c = rng.uniform(0, 1e15, 3)
        n = int(rng.integers(1, 512))
        for per in (True, False):
            args = (f, b, c, n, HW_H100["peak_flops_bf16"], HW_H100["hbm_bw"],
                    HW_H100["ici_bw"], per)
            assert aten_analysis.roofline_terms(*args) == \
                ref_analysis.roofline_terms(*args)
    assert aten_analysis.roofline_terms(1, 2, 3, 4) == \
        ref_analysis.roofline_terms(1, 2, 3, 4)


def test_collective_bytes_sums_per_kind():
    recs = [{"kind": "all-gather", "out_bytes": 10.0},
            {"kind": "all-reduce", "out_bytes": 4.0},
            {"kind": "all-gather", "out_bytes": 6.0}]
    out = aten_analysis.collective_bytes(recs)
    assert out["bytes"]["all-gather"] == 16.0
    assert out["counts"] == {"all-gather": 2, "all-reduce": 1,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}
    assert out["total_bytes"] == 20.0


# --------------------------------------------------------- toy programs
def _fake(*shapes):
    with FakeTensorMode():
        return [torch.empty(s) for s in shapes]


def test_walker_matches_reference_scanfree():
    def g(a, b):
        return jnp.tanh(a @ b) @ b

    comp = jax.jit(g).lower(jax.ShapeDtypeStruct((128, 128), jnp.float32),
                            jax.ShapeDtypeStruct((128, 128), jnp.float32)
                            ).compile()
    ref = analyze_hlo(comp.as_text())
    cost = trace_cost(lambda a, b: torch.tanh(a @ b) @ b,
                      *_fake((128, 128), (128, 128)))["cost"]
    assert cost.flops == pytest.approx(ref["flops"], rel=0.05)
    assert cost.mem_bytes == pytest.approx(ref["mem_bytes"], rel=0.25)


def test_walker_counts_every_loop_step():
    """The reference's walker multiplies a while body by its trip count;
    the port's trace runs the loop, so it records each step."""
    def f(c, xs):
        def body(c, x):
            return jnp.tanh(c @ x), None
        return jax.lax.scan(body, c, xs)[0]

    comp = jax.jit(f).lower(
        jax.ShapeDtypeStruct((64, 64), jnp.float32),
        jax.ShapeDtypeStruct((16, 64, 64), jnp.float32)).compile()
    ref = analyze_hlo(comp.as_text())

    def loop(c, xs):
        for x in xs:
            c = torch.tanh(c @ x)
        return c

    cost = trace_cost(loop, *_fake((64, 64), (16, 64, 64)))["cost"]
    expected = 16 * 2 * 64 ** 3
    assert expected <= cost.flops < expected * 1.3
    assert cost.flops == pytest.approx(ref["flops"], rel=0.05)


# ------------------------------------------------- reduced train steps
class _DotFlops(HloAnalyzer):
    """The reference's walker counting only its dots' flops."""

    def _instr_cost(self, comp, ins):
        c = super()._instr_cost(comp, ins)
        if ins.opcode not in ("dot", "fusion", "while", "call",
                              "conditional", "async-start"):
            c.flops = 0.0
        return c


def _adam_structs(pstructs):
    """The reference dry-run's ``_adam_structs`` (``repro/launch/
    dryrun.py`` is not imported: it sets ``XLA_FLAGS`` for 512 devices in
    the importing process, which a later test's subprocess would
    inherit)."""
    from repro.train.optim import AdamState
    like = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype), t)
    return AdamState(jax.ShapeDtypeStruct((), jnp.int32), like(pstructs),
                     like(pstructs))


def _ref_train_hlo(cfg, seq, batch):
    from repro.launch.mesh import make_host_mesh
    from repro.models.steps import input_specs, make_train_step, \
        param_structs
    from repro.parallel.sharding import data_specs, opt_specs, param_specs
    mesh = make_host_mesh(1, 1)
    b = input_specs(cfg, seq, batch, "train")
    ps = param_structs(cfg)
    pspecs = param_specs(ps, mesh, cfg)
    os_ = _adam_structs(ps)
    with jax.set_mesh(mesh):
        jitted = jax.jit(make_train_step(cfg),
                         in_shardings=(pspecs, opt_specs(os_, pspecs),
                                       data_specs(b, mesh), None),
                         out_shardings=(pspecs, opt_specs(os_, pspecs),
                                        None))
        return jitted.lower(ps, os_, b, jax.ShapeDtypeStruct(
            (), jnp.int32)).compile().as_text()


@pytest.mark.parametrize("arch", ["olmo_1b", "zamba2_1p2b"])
def test_reduced_train_step_matches_reference(arch):
    seq, batch = 64, 4
    hlo = _ref_train_hlo(ref_config(arch).reduced(), seq, batch)
    ref = analyze_hlo(hlo)
    ref_dots = _DotFlops(hlo).analyze()["flops"]
    tr = dryrun.trace_step(get_config(arch).reduced(),
                           ShapeCell("t", seq, batch, "train"), ONE)
    cost = tr["cost"]
    print(f"{arch}: matmul flops {cost.matmul_flops / ref_dots:.6f}, "
          f"flops {cost.flops / ref['flops']:.6f}, bytes "
          f"{cost.mem_bytes / ref['mem_bytes']:.6f} of the reference's")
    assert tr["fallbacks"] == {}
    assert cost.matmul_flops == pytest.approx(ref_dots, rel=0.01)
    assert cost.flops == pytest.approx(ref["flops"], rel=0.15)
    assert cost.coll_bytes == 0.0


REF8 = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, dataclasses, json
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.steps import input_specs, param_structs, make_train_step
from repro.parallel.sharding import param_specs, data_specs, opt_specs
from repro.launch.hlo_static import analyze_hlo
from repro.train.optim import AdamState
from repro.launch.mesh import _auto
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=_auto(2))
cfg = dataclasses.replace(get_config({arch!r}), n_layers={layers})
batch = input_specs(cfg, {seq}, {batch}, "train")
ps = param_structs(cfg)
pspecs = param_specs(ps, mesh, cfg)
like = lambda t: jax.tree_util.tree_map(
    lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype), t)
os_ = AdamState(jax.ShapeDtypeStruct((), jnp.int32), like(ps), like(ps))
with jax.set_mesh(mesh):
    jitted = jax.jit(make_train_step(cfg),
                     in_shardings=(pspecs, opt_specs(os_, pspecs),
                                   data_specs(batch, mesh), None),
                     out_shardings=(pspecs, opt_specs(os_, pspecs), None))
    compiled = jitted.lower(ps, os_, batch,
                            jax.ShapeDtypeStruct((), jnp.int32)).compile()
st = analyze_hlo(compiled.as_text(), n_devices=8)
mem = compiled.memory_analysis()
print(json.dumps({{"argument_bytes": mem.argument_size_in_bytes,
                  "temp_bytes": mem.temp_size_in_bytes, **st}}))
"""


def _eight_devices(arch, layers=2, seq=256, batch=8) -> tuple:
    """(the reference's per-device numbers on 8 host devices, the port's
    trace on (4, 2), the port's argument bytes) for ``arch`` at full width
    over ``layers`` layers; each ratio printed."""
    out = subprocess.run(
        [sys.executable, "-c", REF8.format(src=SRC, arch=arch, layers=layers,
                                           seq=seq, batch=batch)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    cell = ShapeCell("t", seq, batch, "train")
    mesh = {"data": 4, "model": 2}
    args = dryrun.argument_bytes(cfg, cell, mesh)
    tr = dryrun.trace_step(cfg, cell, mesh)
    cost = tr["cost"]
    kinds = sorted(set(ref["collective_by_kind"]) | set(cost.coll_by_kind))
    print(arch, "argument bytes", args["total"] / ref["argument_bytes"],
          "temp", tr["peak_bytes"] / ref["temp_bytes"],
          "collective bytes", cost.coll_bytes / ref["collective_bytes"],
          "flops", cost.flops / ref["flops"],
          {k: (cost.coll_by_kind.get(k, 0.0),
               ref["collective_by_kind"].get(k, 0.0)) for k in kinds},
          "fallbacks", tr["fallbacks"])
    return ref, tr, args


@pytest.mark.slow
def test_eight_devices_match_reference_per_device():
    ref, tr, args = _eight_devices("olmo_1b")
    assert tr["fallbacks"] == {}
    assert args["total"] == pytest.approx(ref["argument_bytes"], rel=0.01)
    assert 0.5 <= tr["cost"].coll_bytes / ref["collective_bytes"] <= 2.0


@pytest.mark.slow
def test_eight_devices_moe_cell_matches_reference():
    """granite-moe (the 40-expert capacity fallback) over 2 layers on
    (4, 2) at olmo's bars; the dispatch plan's ``searchsorted`` runs on
    the replicated sorted choices (``aten_static._on_replicas``), so no
    operator falls back."""
    ref, tr, args = _eight_devices("granite_moe_3b_a800m")
    assert tr["fallbacks"] == {}
    assert args["total"] == pytest.approx(ref["argument_bytes"], rel=0.01)
    assert 0.5 <= tr["cost"].coll_bytes / ref["collective_bytes"] <= 2.0


def test_shard_to_shard_is_an_all_to_all_on_either_torch(monkeypatch):
    """A Shard -> Shard redistribution on the sizing mesh (a 'cpu' mesh,
    where DTensor falls back to all-gather + chunk) is recorded as the
    all-to-all it is on cards, also without the helpers torch 2.11 lacks
    (``_group_or_group_name``): C10's cause on the card."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch.mesh import destroy_sizing_mesh, make_sizing_mesh
    monkeypatch.delattr(funcol, "_group_or_group_name", raising=False)
    mesh = make_sizing_mesh({"data": 4, "model": 2})
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as fake:
            local = torch.empty(2, 8, 16)
        x = DTensor.from_local(local, mesh, [Shard(0), Shard(2)],
                               run_check=False, shape=(8, 8, 32),
                               stride=(256, 32, 1))
        with fake:
            res = trace_cost(lambda t: t.redistribute(
                mesh, [Shard(0), Shard(1)]), x, n_devices=8)
    finally:
        destroy_sizing_mesh()
    assert dict(res["cost"].coll_counts) == {"all-to-all": 1.0}


def test_embedding_gradient_needs_no_dtensor_strategy(monkeypatch):
    """The embedding's lookup (``index``) and gradient (``index_put``)
    in the vocab-sharded table run the walker's own rules
    (``aten_static._index``, ``_index_put``): the same cell with
    DTensor's strategies for them removed (torch 2.11 has none for
    ``index_put``, and shards ``index`` otherwise) has the same temp,
    collectives and (no) fallbacks."""
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=2)
    cell = ShapeCell("t", 64, 8, "train")
    mesh = {"data": 4, "model": 2}

    def trace():
        tr = dryrun.trace_step(cfg, cell, mesh)
        return (tr["peak_bytes"], dict(tr["cost"].coll_by_kind),
                dict(tr["cost"].coll_counts), tr["fallbacks"])
    with_strategy = trace()
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    removed = 0
    for table in (prop.op_strategy_funcs, prop.op_to_rules,
                  getattr(prop, "op_single_dim_strategy_funcs", {})):
        for op in [op for op in table if "index_put" in str(op)
                   or str(op) == "aten.index.Tensor"]:
            monkeypatch.delitem(table, op)
            removed += 1
    assert removed
    # the shardings DTensor already worked out, in Python and in C++
    monkeypatch.setattr(prop, "propagate_op_sharding", type(
        prop.propagate_op_sharding)(prop.propagate_op_sharding_non_cached))
    getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
            lambda: None)()
    without = trace()
    assert without == with_strategy
    assert without[3] == {}


# ------------------------------------------------------------------ CLI
def test_cli_cells_carry_the_reference_keys(tmp_path, monkeypatch,
                                            capsys):
    import torch.distributed as dist
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    # a small supported cell: olmo's decode step over 2 layers
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        get_config(a), n_layers=2))
    assert dryrun.main(["--arch", "olmo_1b", "--shape", "decode_32k",
                        "--mesh", "pod"]) == 0
    assert not dist.is_initialized(), "the fake group is torn down"
    res = json.loads((tmp_path / "olmo_1b__decode_32k__pod.json")
                     .read_text())
    ref_keys = {"arch", "shape", "kind", "mesh", "n_chips", "config",
                "hlo_flops_per_device", "hlo_bytes_per_device",
                "collective_bytes_per_device", "collective_breakdown",
                "collective_counts", "roofline", "model_flops_global",
                "model_flops_per_device", "useful_flops_fraction",
                "memory_analysis", "tokens", "ideal_compute_s",
                "roofline_fraction", "compile_seconds", "skipped"}
    assert ref_keys <= set(res)
    assert res["mesh"] == "16x16" and res["n_chips"] == 256
    assert res["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert res["memory_analysis"]["argument_size_in_bytes"] > 0
    assert res["dtensor_fallbacks"] == {}
    # cached: a second call reads the file
    assert dryrun.run_cell("olmo_1b", "decode_32k", False) == res
    # an unsupported cell: the reference's reason
    skip = dryrun.run_cell("gemma_2b", "long_500k", True)
    ok, why = __import__("repro.configs.registry", fromlist=["x"]) \
        .cell_supported(ref_config("gemma_2b"), "long_500k")
    assert skip == {"arch": "gemma_2b", "shape": "long_500k",
                    "mesh": "2x16x16", "skipped": True, "reason": why}
    assert not ok
    assert "OK   olmo_1b decode_32k pod" in capsys.readouterr().out


def test_argument_bytes_are_the_local_shards():
    """Per-device argument bytes from the specs: one card holds all of
    params + AdamW (float32, 3x) + the int32 batch; a (16, 16) mesh 1/256
    of each sharded leaf."""
    cfg = get_config("olmo_1b")
    cell = SHAPES["train_4k"]
    one = dryrun.argument_bytes(cfg, cell, ONE)
    n = cfg.n_params()
    ps = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        dryrun.param_structs(cfg)))
    assert abs(ps - n) / n < 0.01
    assert one["params"] == one["mu"] == one["nu"] == 4 * ps
    assert one["batch"] == 2 * 4 * cell.global_batch * cell.seq_len
    pod = dryrun.argument_bytes(cfg, cell, {"data": 16, "model": 16})
    assert pod["params"] < one["params"] / 200
    assert pod["batch"] == one["batch"] / 16
