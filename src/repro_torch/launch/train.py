"""LM training driver (twin of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --reduced --device cpu --steps 4 --batch 2 --seq 16 \\
        --ckpt-dir /tmp/ck                           # a smoke run on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --steps 8 --batch 4 --seq 2048 --log-every 1  # on the GPU

The loop is the reference's code: parameters from ``--seed``, AdamW, a
cosine schedule from ``--lr`` to lr / 10 with a warm-up of max(steps //
20, 1) steps, ``make_train_step`` (gradients clipped to norm 1, weight
decay 0.01) on ``SyntheticTokenStream``'s batches.  With ``--ckpt-dir``
a checkpoint is written at every step that is a nonzero multiple of
``--ckpt-every`` and once more after the last step; a run that finds a
checkpoint there resumes after its latest step, the stream restored to
the batch it had reached.  Checkpoints are the reference's format (the
params and the ``AdamState``, its step as a 0-d int32 array, and the
stream's state in ``extra``), so either package resumes the other's.  No
supervisor wraps the loop: the reference's docstring says one does, its
code runs none.

``--mesh host`` is the one device.  ``--mesh pod`` / ``multipod`` train
over the reference's (16, 16) ('data', 'model') or (2, 16, 16) ('pod',
'data', 'model') mesh on a real process group of 256 or 512 ranks, one a
GPU, initialised from ``torchrun``'s environment (NCCL,
``torch.cuda.set_device(LOCAL_RANK)``; ``launch/mesh.py::make_run_mesh``):

    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch olmo_1b --mesh pod --steps 100 --batch 256 --seq 4096

Without such a group ``pod`` and ``multipod`` raise ``ValueError``.  Both
go through ``train_loop``, the one loop, which takes the mesh (the tests
pass a ``make_host_mesh(2, 2)`` over four gloo ranks): every rank draws
the global batch from the stream and lays it out by ``data_specs``, the
parameters and AdamW state are laid out by ``param_specs`` /
``opt_specs`` (DTensors), the step runs under the mesh
(``parallel/annotate.use_mesh``), and rank 0 prints the log lines.
Checkpoints keep the format: full tensors gathered, rank 0 writes; a
resume reads them on every rank and lays them out, so a sharded run
resumes a one-device checkpoint and the other way round.  The operators
that ran whole on the mesh in the first step are counted
(``parallel/replicated_ops.py``) into ``TrainResult.replicated`` and
printed to stderr when there are any.  A config whose sharded step is
not ported raises ``NotImplementedError`` (``check_sharded``).

The device defaults to ``cuda``, which raises without a GPU.  Prints the
reference's lines: "step N loss ... gnorm ... (ms/step)" every
``--log-every`` steps and at the last, "resumed from step N", "done".
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time

import torch

from ..configs.registry import get_config
from ..core.device import resolve_device
from ..core.nn import tree_map
from ..models.config import ModelConfig
from ..models.mlp import shard_map_applies
from ..models.steps import make_train_step
from ..models.transformer import init_params
from ..parallel.annotate import is_dtensor, use_mesh
from ..parallel.replicated_ops import count_replicated
from ..parallel.sharding import (data_specs, opt_specs, param_specs,
                                 shard_tree)
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..train.data import DataConfig, SyntheticTokenStream
from ..train.optim import AdamState, adamw_init, cosine_schedule
from .mesh import make_run_mesh


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt_state: AdamState
    start: int              # the first step this run took
    metrics: list           # each step's metrics (0-d tensors)
    step_end_s: list        # seconds from the first step's start to each
                            # step's end (after its log line, if any)
    replicated: dict = dataclasses.field(default_factory=dict)
                            # operators run whole on the mesh in the
                            # first step, by name (empty without a mesh)


def _as_saved(opt: AdamState) -> AdamState:
    """The reference's ``AdamState``: its step a 0-d int32 array."""
    return AdamState(torch.tensor(int(opt.step), dtype=torch.int32),
                     opt.mu, opt.nu)


def check_sharded(cfg: ModelConfig, mesh) -> None:
    """Raise ``NotImplementedError`` for a config whose sharded step the
    port does not run on ``mesh``: an MoE whose dispatch on the mesh is
    the ``gspmd`` plan (ROADMAP A12.5.5)."""
    if mesh is None or cfg.moe is None or shard_map_applies(cfg.moe, mesh):
        return
    raise NotImplementedError(
        f"{cfg.name}: the MoE's gspmd dispatch on a device mesh is not "
        f"ported (ROADMAP A12.5.5); dispatch='shard_map' runs where the "
        f"'model' axis divides its {cfg.moe.n_experts} experts")


def _full(t):
    return t.full_tensor() if is_dtensor(t) else t


def train_loop(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
               lr: float = 3e-4, seed: int = 0, ckpt_dir=None,
               ckpt_every: int = 50, log_every: int = 10,
               device="cuda", mesh=None, init=None) -> TrainResult:
    """The driver's loop (``main``'s, the reference's), on ``device``
    alone or, given ``mesh`` (a ``DeviceMesh`` over the process group
    with the reference's axis names), sharded over it; the result's
    params and AdamW moments are then DTensors.  ``init``: parameters to
    start from (a plain tree, every rank's alike) instead of
    ``init_params(cfg, seed)``."""
    check_sharded(cfg, mesh)
    if mesh is not None:
        device = resolve_device(mesh.device_type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    main_rank = mesh is None or torch.distributed.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    params = (init_params(cfg, seed, device) if init is None
              else tree_map(lambda t: t.to(device), init))
    opt_state = adamw_init(params)
    sched = cosine_schedule(lr, lr * 0.1, steps,
                            warmup=max(steps // 20, 1))
    step_fn = make_train_step(cfg, lr_schedule=sched)
    if mesh is not None:
        pspecs = param_specs(params, mesh, cfg)
        params = shard_tree(params, pspecs, mesh)
        ospecs = opt_specs(opt_state, pspecs)
        opt_state = AdamState(opt_state.step,
                              shard_tree(opt_state.mu, ospecs.mu, mesh),
                              shard_tree(opt_state.nu, ospecs.nu, mesh))

    data = SyntheticTokenStream(cfg, DataConfig(seq, batch, seed=seed),
                                device)
    start = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            (params, saved), extra = restore_checkpoint(
                ckpt_dir, last, (params, _as_saved(opt_state)))
            opt_state = AdamState(int(saved.step), saved.mu, saved.nu)
            data.restore(extra["data"])
            start = last + 1
            say(f"resumed from step {last}")

    metrics, ends, replicated = [], [], {}
    t_start = time.time()
    for step in range(start, steps):
        batch_t = data.next_batch()
        if mesh is not None:
            batch_t = shard_tree(batch_t, data_specs(batch_t, mesh), mesh)
        counting = (count_replicated() if mesh is not None and step == start
                    else contextlib.nullcontext())
        on_mesh = contextlib.nullcontext() if mesh is None else use_mesh(mesh)
        with on_mesh, counting as counts:
            params, opt_state, m = step_fn(params, opt_state, batch_t, step)
        if counts is not None:
            replicated = dict(counts)
        m = tree_map(_full, m)
        metrics.append(m)
        if step % log_every == 0 or step == steps - 1:
            say(f"step {step:5d} loss {float(m['loss']):.4f} "
                f"gnorm {float(m['grad_norm']):.3f} "
                f"({(time.time()-t_start)/max(step-start+1,1)*1e3:.0f}"
                f" ms/step)", flush=True)
        ends.append(time.time() - t_start)
        if ckpt_dir and step and step % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step, (params, _as_saved(opt_state)),
                            extra={"data": data.state()})
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps - 1, (params, _as_saved(opt_state)),
                        extra={"data": data.state()})
    if replicated and main_rank:
        print(f"operators run whole on the mesh (first step): "
              f"{replicated}", file=sys.stderr)
    say("done")
    return TrainResult(params, opt_state, start, metrics, ends, replicated)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-size variant of the arch (same family)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = (None if args.mesh == "host"
            else make_run_mesh(multi_pod=args.mesh == "multipod"))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      lr=args.lr, seed=args.seed, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=args.log_every,
                      device=resolve_device(args.device) if mesh is None
                      else None, mesh=mesh)


if __name__ == "__main__":
    main()
