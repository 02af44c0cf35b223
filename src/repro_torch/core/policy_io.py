"""DOPPLER policy checkpointing (twin of ``repro/core/policy_io.py``):
save and restore the dual-policy parameters plus the trainer's state, so
that Stage III can resume in production and a policy can move between
hosts, and between ``repro`` and the port.

The checkpoint is the reference's: the tree ``(params, opt_state)``
(AdamW's step a 0-d int32 leaf, as the reference's scalar) in
``train/checkpoint.py``'s format, and ``extra`` with the reference's
keys: episode counter, running reward statistics (Python floats, never
cast through float32), best time (None for inf) and assignment, the
ablation modes and the reference's PRNG ``key``.  The port never draws
from a JAX key: it keeps one it loads (``trainer.key``, uint32) and
writes it back unchanged, so repro -> port -> repro keeps it; a port
trainer without one writes None, which the reference's loader skips.
The port adds ``torch_generator`` — the sampling generator's device
type and state — which the reference ignores.  A hierarchical trainer
also writes ``hierarchy`` (``HierarchicalPolicy.state_dict``: every
V-cycle level's vertex -> segment map and the refinement state), as the
reference does; loading it checks the maps entry by entry.

A resumed trainer continues with the same trajectories, params and
greedy assignment as the uninterrupted run, on the batched and the fused
Stage II paths (a captured fused engine copies the restored state into
its static buffers at its next dispatch)."""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..train.checkpoint import (latest_step, read_manifest,
                                restore_checkpoint, save_checkpoint)
from ..train.optim import AdamState
from .device import resolve_device
from .nn import tree_map
from .policies import init_policies


def save_policy(ckpt_dir: str | pathlib.Path, trainer) -> pathlib.Path:
    """Checkpoint ``trainer`` as step ``trainer.episode`` of
    ``ckpt_dir``."""
    key = getattr(trainer, "key", None)
    gen = trainer.generator
    extra = {
        "episode": int(trainer.episode),
        "r_sum": float(trainer._r_sum),
        "r_sqsum": float(trainer._r_sqsum),
        "r_count": int(trainer._r_count),
        "key": None if key is None else np.asarray(key, np.uint32).tolist(),
        "best_time": (float(trainer.best_time)
                      if trainer.best_time != float("inf") else None),
        "best_assignment": (np.asarray(trainer.best_assignment).tolist()
                            if trainer.best_assignment is not None
                            else None),
        "sel_mode": trainer.sel_mode,
        "plc_mode": trainer.plc_mode,
        "torch_generator": {"device": gen.device.type,
                            "state": gen.get_state().tolist()},
    }
    hier = getattr(trainer, "hier", None)
    if hier is not None:
        extra["hierarchy"] = hier.state_dict()
    opt = trainer.opt_state
    state = AdamState(torch.tensor(int(opt.step), dtype=torch.int32),
                      opt.mu, opt.nu)
    return save_checkpoint(ckpt_dir, trainer.episode,
                           (trainer.params, state), extra=extra)


def load_policy(ckpt_dir: str | pathlib.Path, trainer,
                step: int | None = None):
    """Restore params, AdamW state, counters, reward statistics, best,
    key and generator into an existing trainer (built for the target
    graph and fleet: transfer is building the trainer on another graph
    first).  Everything is validated before the trainer is touched: a
    count or shape mismatch, an incomplete checkpoint, a hierarchical
    checkpoint into a flat trainer or the reverse, another partition
    stack, or a generator of another device type raises and leaves it as
    it was."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    opt = trainer.opt_state
    like = (trainer.params,
            AdamState(torch.zeros((), dtype=torch.int32), opt.mu, opt.nu))
    (params, opt_state), extra = restore_checkpoint(ckpt_dir, step, like)
    hier_state = extra.get("hierarchy")
    hier = getattr(trainer, "hier", None)
    if hier_state is not None:
        if hier is None:
            raise ValueError(
                "checkpoint is hierarchical (segment-level policy + "
                "refinement state) but the trainer was built flat; pass "
                "hierarchy=HierarchyConfig(n_segments="
                f"{hier_state['n_segments']}, ...) to DopplerTrainer")
        hier.check_state_dict(hier_state)
    elif hier is not None:
        raise ValueError(
            "trainer is hierarchical but the checkpoint was saved by a "
            "flat trainer (its params index a different graph)")
    gen = extra.get("torch_generator")
    mine = trainer.generator.device.type
    if gen is not None and gen["device"] != mine:
        raise ValueError(
            f"checkpoint's generator is a {gen['device']} generator, the "
            f"trainer's a {mine} generator: their states are not "
            f"interchangeable (a CPU mt19937 state, a CUDA Philox seed "
            f"and offset)")
    if hier_state is not None:
        hier.load_state_dict(hier_state)
    trainer.params = params
    trainer.opt_state = AdamState(int(opt_state.step), opt_state.mu,
                                  opt_state.nu)
    trainer.episode = int(extra["episode"])
    if extra.get("key") is not None:       # written by the reference
        trainer.key = np.asarray(extra["key"], dtype=np.uint32)
    trainer._r_sum = float(extra["r_sum"])
    trainer._r_sqsum = float(extra["r_sqsum"])
    trainer._r_count = int(extra["r_count"])
    if extra.get("best_time") is not None:
        trainer.best_time = float(extra["best_time"])
    if extra.get("best_assignment") is not None:
        trainer.best_assignment = np.asarray(extra["best_assignment"])
    if gen is not None:
        trainer.generator.set_state(
            torch.tensor(gen["state"], dtype=torch.uint8))
    return trainer


# ------------------------------------------------- pretrained (cross-graph)
def save_pretrained(ckpt_dir: str | pathlib.Path,
                    pretrained: dict) -> pathlib.Path:
    """Persist a pretraining result (one graph-agnostic parameter set,
    ``params``, and its architecture ``meta``) for zero-shot serving."""
    extra = {"pretrain_meta": pretrained["meta"],
             "per_task": pretrained.get("per_task", {})}
    return save_checkpoint(ckpt_dir, 0, pretrained["params"], extra=extra)


def load_pretrained(ckpt_dir: str | pathlib.Path, step: int | None = None,
                    device: str | torch.device = "cuda") -> dict:
    """Load a pretrained policy without a trainer: the manifest's
    ``pretrain_meta`` (d_hidden, d_z, d_y, gnn_layers) rebuilds an
    ``init_policies`` template (on a CPU generator) that receives the
    leaves, on ``device``.  Returns ``{"params", "meta", "per_task"}``."""
    device = resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no pretrained checkpoint in {ckpt_dir}")
    meta = read_manifest(ckpt_dir, step)["extra"]["pretrain_meta"]
    template = tree_map(lambda x: x.to(device), init_policies(
        torch.Generator().manual_seed(0), d_hidden=int(meta["d_hidden"]),
        d_z=int(meta.get("d_z", 32)), d_y=int(meta.get("d_y", 32)),
        gnn_layers=int(meta["gnn_layers"])))
    params, extra = restore_checkpoint(ckpt_dir, step, template)
    return {"params": params, "meta": extra["pretrain_meta"],
            "per_task": extra.get("per_task", {})}
