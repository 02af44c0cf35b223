"""Checkpoints in the reference's on-disk format (twin of
``repro/train/checkpoint.py``), so that a checkpoint moves between
``repro`` and the port in both directions.

A checkpoint of step s is a directory ``step_{s:09d}/`` holding
``arrays.msgpack`` — one msgpack map a leaf, ``{"key": "arr_00000",
"dtype", "shape", "data": the raw C-order buffer}``, the leaves in
``jax.tree_util`` flatten order (dict keys sorted, lists and tuples in
order, ``None`` no leaf) — and ``manifest.json`` (step, array count, a
tree description no reader parses, the index, ``extra``, time,
``complete``).  Both are written into ``.tmp_step_{s:09d}/`` and
published by one ``os.rename``, so a crashed save never corrupts the
latest checkpoint; the oldest are removed past ``keep``.

The port imports torch and numpy only: the msgpack subset the format
uses is packed and decoded by hand (``_msgpack.py``).  Restore places
each leaf on the target leaf's device and dtype.

Sharded trees (DTensor leaves, a run over a device mesh) keep the same
format: a save gathers the leaves' full tensors one at a time, each
moved to the host as it arrives, rank 0 writes them, and every rank
waits for it; a restore reads the whole
checkpoint on every rank and lays each leaf out as its DTensor target
leaf is.  So a sharded run resumes a one-device checkpoint (either
package's) and the other way round.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import time

import numpy as np
import torch

from ..core.nn import tree_leaves
from ..parallel.annotate import is_dtensor
from . import _msgpack


def _flatten(tree) -> list:
    return [x for x in tree_leaves(tree) if x is not None]


def _unflatten(like, leaves):
    """``leaves`` (in flatten order) placed into the structure of
    ``like``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (list, tuple)):
            return type(t)([build(x) for x in t])
        return next(it)
    return build(like)


def _key(i: int) -> str:
    return f"arr_{i:05d}"


def save_checkpoint(ckpt_dir: str | pathlib.Path, step: int, tree,
                    extra: dict | None = None, keep: int = 3) -> pathlib.Path:
    """Write ``tree``'s tensor leaves and ``extra`` (JSON) as checkpoint
    ``step`` of ``ckpt_dir``; -> the published directory."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    leaves = _flatten(tree)
    if not any(is_dtensor(x) for x in leaves):
        return _write(ckpt_dir, step, (_host(x) for x in leaves), extra,
                      keep)
    import torch.distributed as dist
    # one leaf gathered at a time and moved to the host as it arrives, so a
    # card holds one full leaf beside its shards, never the whole tree
    gathered = (_host(x.full_tensor() if is_dtensor(x) else x)
                for x in leaves)
    if dist.get_rank() == 0:
        _write(ckpt_dir, step, gathered, extra, keep)
    else:
        for _ in gathered:      # the gathers are collectives: every rank
            pass                # takes part, only rank 0 keeps the leaf
    dist.barrier()
    return ckpt_dir / f"step_{step:09d}"


def _host(leaf: torch.Tensor) -> np.ndarray:
    return leaf.detach().cpu().numpy()          # tobytes() is C order


def _write(ckpt_dir: pathlib.Path, step: int, arrays, extra: dict | None,
           keep: int) -> pathlib.Path:
    """``arrays`` (numpy, in flatten order; an iterable, consumed once)
    written and published as checkpoint ``step``."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step:09d}"
    final = ckpt_dir / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    index = []
    with open(tmp / "arrays.msgpack", "wb") as f:
        for i, arr in enumerate(arrays):
            index.append({"key": _key(i), "shape": list(arr.shape),
                          "dtype": str(arr.dtype)})
            f.write(_msgpack.pack({"key": _key(i), "dtype": str(arr.dtype),
                                   "shape": list(arr.shape),
                                   "data": arr.tobytes()}))
    manifest = {"step": step, "n_arrays": len(index),
                "treedef": f"{len(index)} leaves in jax.tree_util order",
                "index": index,
                "extra": extra or {}, "time": time.time(),
                "complete": True}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted(ckpt_dir.glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    """The newest published step of ``ckpt_dir`` (None: there is none)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    for cand in reversed(sorted(ckpt_dir.glob("step_*"))):
        if (cand / "manifest.json").exists():
            return int(cand.name.split("_")[1])
    return None


def read_manifest(ckpt_dir: str | pathlib.Path, step: int) -> dict:
    """Checkpoint ``step``'s manifest; raises if the save never
    completed."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((path / "manifest.json").read_text())
    if not manifest.get("complete"):
        raise IOError(f"checkpoint {path} incomplete")
    return manifest


def restore_checkpoint(ckpt_dir: str | pathlib.Path, step: int,
                       target_tree):
    """Checkpoint ``step`` in the structure of ``target_tree`` (tensor
    leaves), each leaf on the target leaf's device and dtype, and laid
    out as it is when it is a DTensor; -> (tree, extra).  Raises on an
    incomplete manifest and on a count or shape mismatch, before
    anything is returned."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    manifest = read_manifest(ckpt_dir, step)
    records = _msgpack.unpack_stream((path / "arrays.msgpack").read_bytes())
    arrays = {rec["key"]: np.frombuffer(rec["data"], dtype=rec["dtype"])
              .reshape(rec["shape"]) for rec in records}
    leaves = _flatten(target_tree)
    if len(leaves) != manifest["n_arrays"]:
        raise ValueError(
            f"checkpoint has {manifest['n_arrays']} arrays, target tree "
            f"has {len(leaves)} — structure mismatch")
    out = []
    for i, leaf in enumerate(leaves):
        arr = arrays[_key(i)]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"array {i} shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        np_dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
        full = torch.from_numpy(arr.astype(np_dtype)).to(leaf.device)
        if is_dtensor(leaf):
            from torch.distributed.tensor import distribute_tensor
            full = distribute_tensor(full, leaf.device_mesh, leaf.placements)
        out.append(full)
    return _unflatten(target_tree, out), manifest["extra"]
