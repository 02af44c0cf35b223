"""Multi-pod dry-run (twin of ``repro/launch/dryrun.py``): size every
(arch x shape x mesh) cell without a device.

For each cell this:
  1. builds the production mesh (``launch/mesh.py``: (16, 16) or
     (2, 16, 16) on a fake process group, this process rank 0),
  2. builds the inputs (``models.steps.input_specs``), parameter, AdamW
     and decode-state structs (``meta`` tensors: nothing is allocated)
     and their specs (``parallel/sharding.py``),
  3. lays each out as a DTensor of fake local shards and runs the train,
     prefill or decode step under the static walker
     (``launch/aten_static.py``) with the mesh ambient, so the models'
     ``constrain`` calls redistribute their activations,
  4. records one device's argument bytes (the local shards of params,
     AdamW, batch and decode state, exact from the specs), the trace's
     temp peak, flops, bytes and collective bytes, and the roofline terms
     at ``HW_H100``.

The trace runs the step at one and at two repetitions of the model's
unit and extrapolates to its depth (each repetition's cost is the
difference), the counterpart of the reference's while-trip multipliers;
a 94-layer model costs two short traces.  It runs on the host: fake
tensors need no device.  The process group is torn down when a cell
returns.

Results are cached to ``results/dryrun_torch/<cell>.json`` so the sweep
is restartable.  Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, SHAPES, cell_supported, get_config
from ..core.nn import tree_leaves, tree_map
from ..models.steps import (decode_state_structs, input_specs,
                            make_decode_step, make_prefill_step,
                            make_train_step, param_structs)
from ..models.transformer import unit_and_reps
from ..parallel.annotate import use_mesh
from ..parallel.sharding import (data_specs, decode_state_specs, local_shape,
                                 map_with_specs, opt_specs, param_specs,
                                 spec_leaves, to_placements)
from ..train.optim import AdamState
from .aten_analysis import COLLECTIVE_OPS, model_flops, roofline_terms
from .aten_static import Cost, trace_cost
from .mesh import (HW_H100, destroy_sizing_mesh, make_sizing_mesh,
                   mesh_label, n_devices, production_shape)

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "dryrun_torch")


def _adam_structs(pstructs) -> AdamState:
    meta = lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta")  # noqa: E731
    return AdamState(0, tree_map(meta, pstructs), tree_map(meta, pstructs))


def local_bytes(structs, specs, mesh) -> float:
    """One device's bytes of ``structs`` laid out by ``specs``."""
    total = 0.0
    for s, sp in zip(tree_leaves(structs), spec_leaves(specs)):
        n = float(np.prod(local_shape(tuple(s.shape), sp, mesh),
                          dtype=np.float64))
        total += n * s.element_size()
    return total


def _lay_out(structs, specs, device_mesh, fake_mode):
    """Meta ``structs`` -> fake tensors (no mesh) or DTensors of fake local
    shards laid out by ``specs``."""
    from torch.distributed.tensor import DTensor

    def one(s, sp):
        shape = (tuple(s.shape) if device_mesh is None else
                 local_shape(tuple(s.shape), sp, device_mesh))
        with fake_mode:
            t = torch.empty(shape, dtype=s.dtype)
        if device_mesh is None:
            return t
        return DTensor.from_local(t, device_mesh,
                                  to_placements(sp, device_mesh),
                                  run_check=False)
    return map_with_specs(one, structs, specs)


def _time_loop(fn) -> bool:
    """The sLSTM's loop over time, costed from its first steps."""
    from ..models.ssm import _slstm_loop
    return getattr(fn, "func", fn) is _slstm_loop


def depth_cfg(cfg, reps: int):
    """``cfg`` cut to ``reps`` repetitions of its unit, remainder kept."""
    unit, _, rem = unit_and_reps(cfg)
    return dataclasses.replace(cfg, n_layers=reps * len(unit) + len(rem))


def cell_arguments(cfg, cell, mesh) -> dict:
    """Structs, specs and one device's bytes of each argument of the
    cell's step (``mesh``: a ``DeviceMesh`` or a {axis: size} mapping)."""
    batch = input_specs(cfg, cell.seq_len, cell.global_batch, cell.kind)
    pstructs = param_structs(cfg)
    pspecs = param_specs(pstructs, mesh, cfg)
    out = {"batch": (batch, data_specs(batch, mesh)),
           "params": (pstructs, pspecs)}
    if cell.kind == "train":
        ostructs = _adam_structs(pstructs)
        ospecs = opt_specs(ostructs, pspecs)
        out["mu"] = (ostructs.mu, ospecs.mu)
        out["nu"] = (ostructs.nu, ospecs.nu)
    else:
        sstructs = decode_state_structs(cfg, cell.global_batch, cell.seq_len)
        out["state"] = (sstructs, decode_state_specs(sstructs, mesh, cfg))
    return out


def argument_bytes(cfg, cell, mesh) -> dict:
    """Per-device argument bytes, by argument and in total."""
    args = cell_arguments(cfg, cell, mesh)
    by = {k: local_bytes(s, sp, mesh) for k, (s, sp) in args.items()}
    by["total"] = float(sum(by.values()))
    return by


def trace_step(cfg, cell, shape: dict, device_mesh=None) -> dict:
    """One trace of the cell's step on a mesh of ``shape`` ({axis: size};
    one device: no mesh, plain fake tensors) -> the walker's result.  The
    sizing mesh is made and torn down here unless ``device_mesh`` (one of
    ``shape``) is given."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n = n_devices(shape)
    own = device_mesh is None and n > 1
    if own:
        device_mesh = make_sizing_mesh(shape)
    rules_mesh = device_mesh if device_mesh is not None else shape
    try:
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        args = cell_arguments(cfg, cell, rules_mesh)
        lay = {k: _lay_out(s, sp, device_mesh, fake)
               for k, (s, sp) in args.items()}
        if cell.kind == "train":
            step = make_train_step(cfg)
            fn = lambda p, mu, nu, b: step(p, AdamState(0, mu, nu), b, 0)  # noqa: E731
            call = (lay["params"], lay["mu"], lay["nu"], lay["batch"])
        elif cell.kind == "prefill":
            step = make_prefill_step(cfg, cell.seq_len)
            fn, call = step, (lay["params"], lay["batch"], lay["state"])
        else:
            step = make_decode_step(cfg)
            fn = lambda p, b, s: step(p, b, s, cell.seq_len - 1)  # noqa: E731
            call = (lay["params"], lay["batch"], lay["state"])
        with use_mesh(device_mesh):
            res = trace_cost(fn, *call, n_devices=n,
                             prefix_loops=_time_loop)
        res.pop("out")
        return res
    finally:
        if own:
            destroy_sizing_mesh()


def trace_cell(cfg, cell, shape: dict) -> dict:
    """The cell's per-device cost at ``cfg``'s full depth: traced at one
    and two repetitions of the unit and extrapolated (exact when the unit
    repeats; a model of one repetition is traced as it is)."""
    _, reps, _ = unit_and_reps(cfg)
    t0 = time.perf_counter()
    # one mesh for both traces: DTensor's sharding cache carries over
    mesh = make_sizing_mesh(shape) if n_devices(shape) > 1 else None
    try:
        if reps <= 2:
            a = b = trace_step(cfg, cell, shape, mesh)
        else:
            a = trace_step(depth_cfg(cfg, 1), cell, shape, mesh)
            b = trace_step(depth_cfg(cfg, 2), cell, shape, mesh)
    finally:
        if mesh is not None:
            destroy_sizing_mesh()
    coll = {k: dict(a["collectives"][k]) for k in ("bytes", "counts")}
    if reps <= 2:
        cost, peak, fb = a["cost"], a["peak_bytes"], a["fallbacks"]
    else:
        for k in coll:
            coll[k] = {kind: v + (reps - 1) * (b["collectives"][k][kind] - v)
                       for kind, v in coll[k].items()}
        per = Cost().add(b["cost"]).add(a["cost"], -1.0)
        cost = Cost().add(a["cost"]).add(per, reps - 1)
        # the peak grows by what a repetition keeps live (none when the
        # second repetition's trace peaks lower: DTensor may lay its
        # operators out otherwise once its sharding cache is warm)
        peak = a["peak_bytes"] + (reps - 1) * max(
            b["peak_bytes"] - a["peak_bytes"], 0.0)
        fb = {k: a["fallbacks"].get(k, 0) + (reps - 1) * (
            b["fallbacks"].get(k, 0) - a["fallbacks"].get(k, 0))
            for k in set(a["fallbacks"]) | set(b["fallbacks"])}
    return {"cost": cost, "peak_bytes": peak, "fallbacks": fb,
            "fallback_errors": {**b["errors"], **a["errors"]},
            "collectives": coll, "trace_seconds": time.perf_counter() - t0,
            "reps": reps}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None, mesh_shape: dict | None = None,
               cell=None):
    """-> (cfg, cell, traced, meta) for one cell.  ``mesh_shape`` replaces
    the production mesh (e.g. {"data": 1, "model": 1} for one card),
    ``cell`` the registry's shape (a ``ShapeCell`` of any batch and
    sequence; ``shape_name`` is then its name)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = cell or SHAPES[shape_name]
    shape = mesh_shape or production_shape(multi_pod)
    traced = trace_cell(cfg, cell, shape)
    traced["arguments"] = argument_bytes(cfg, cell, shape)
    meta = {"arch": arch, "shape": shape_name, "kind": cell.kind,
            "mesh": mesh_label(shape), "n_chips": n_devices(shape),
            "config": cfg.name}
    return cfg, cell, traced, meta


def analyse(cfg, cell, traced, meta, hw: dict = HW_H100) -> dict:
    n_chips = meta["n_chips"]
    stat = traced["cost"].as_dict()
    flops, bytes_acc = stat["flops"], stat["mem_bytes"]
    coll = {"total_bytes": stat["collective_bytes"],
            "bytes": {k: stat["collective_by_kind"].get(k, 0.0)
                      for k in COLLECTIVE_OPS},
            "counts": {k: stat["collective_counts"].get(k, 0)
                       for k in COLLECTIVE_OPS}}
    terms = roofline_terms(flops, bytes_acc, coll["total_bytes"], n_chips,
                           hw["peak_flops_bf16"], hw["hbm_bw"],
                           hw["ici_bw"], per_device=True)
    n_tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                    else 1)
    mflops = model_flops(cfg, n_tokens, cell.kind)
    args = traced["arguments"]
    mem_info = {"argument_size_in_bytes": args["total"],
                "argument_bytes_by_kind": {k: v for k, v in args.items()
                                           if k != "total"},
                "temp_size_in_bytes": traced["peak_bytes"],
                "fits_hbm": (args["total"] + traced["peak_bytes"]
                             <= hw["hbm_bytes"]),
                "hbm_bytes": hw["hbm_bytes"]}
    result = {
        **meta,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "matmul_flops_per_device": stat["matmul_flops"],
        "collective_bytes_per_device": coll["total_bytes"],
        "collective_breakdown": coll["bytes"],
        "collective_counts": coll["counts"],
        "collective_output_bytes": traced["collectives"]["bytes"],
        "roofline": terms,
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / n_chips,
        "useful_flops_fraction":
            (mflops / n_chips) / flops if flops > 0 else 0.0,
        "memory_analysis": mem_info,
        "tokens": n_tokens,
        "dtensor_fallbacks": traced["fallbacks"],
        "dtensor_fallback_errors": traced["fallback_errors"],
        "reps": traced["reps"],
        "hw": {k: hw[k] for k in ("name", "power_limit_w")},
    }
    ideal_s = (mflops / n_chips) / hw["peak_flops_bf16"]
    result["ideal_compute_s"] = ideal_s
    result["roofline_fraction"] = (
        ideal_s / terms["bound_s"] if terms["bound_s"] > 0 else 0.0)
    return result


def size_cell(arch: str, cell, mesh_shape: dict,
              overrides: dict | None = None) -> dict:
    """``analyse`` of one step of ``arch`` at ``cell`` (a ``ShapeCell``)
    on a mesh of ``mesh_shape``, uncached: how a card's own step (e.g. on
    the one-card mesh) is sized."""
    t0 = time.time()
    cfg, cell, traced, meta = lower_cell(arch, cell.name, False, overrides,
                                         mesh_shape, cell)
    res = analyse(cfg, cell, traced, meta)
    res["compile_seconds"] = time.time() - t0
    res["trace_seconds"] = traced["trace_seconds"]
    return res


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, overrides: dict | None = None,
             tag: str = "", results_dir: pathlib.Path | None = None) -> dict:
    out_dir = pathlib.Path(results_dir or RESULTS_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "multipod" if multi_pod else "pod"
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_tag}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = get_config(arch)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        res = {"arch": arch, "shape": shape_name,
               "mesh": mesh_label(production_shape(multi_pod)),
               "skipped": True, "reason": why}
        out_path.write_text(json.dumps(res, indent=1))
        return res
    t0 = time.time()
    cfg, cell, traced, meta = lower_cell(arch, shape_name, multi_pod,
                                         overrides)
    res = analyse(cfg, cell, traced, meta)
    res["compile_seconds"] = time.time() - t0
    res["trace_seconds"] = traced["trace_seconds"]
    res["skipped"] = False
    out_path.write_text(json.dumps(res, indent=1))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tagm = "multipod" if mp else "pod"
                try:
                    r = run_cell(arch, shape, mp, force=args.force)
                    if r.get("skipped"):
                        print(f"SKIP {arch} {shape} {tagm}: {r['reason']}")
                    else:
                        rf, mem = r["roofline"], r["memory_analysis"]
                        print(f"OK   {arch} {shape} {tagm} "
                              f"dom={rf['dominant']} "
                              f"bound={rf['bound_s']*1e3:.2f}ms "
                              f"frac={r['roofline_fraction']:.3f} "
                              f"args={mem['argument_size_in_bytes']/1e9:.2f}GB "
                              f"temp={mem['temp_size_in_bytes']/1e9:.2f}GB "
                              f"({r.get('compile_seconds', 0):.0f}s)",
                              flush=True)
                except Exception as e:   # noqa: BLE001 (reported, counted)
                    failures.append((arch, shape, tagm, repr(e)))
                    print(f"FAIL {arch} {shape} {tagm}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures")
        return 1
    print("\nall cells OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
