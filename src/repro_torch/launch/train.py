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

``--mesh host`` is the one device; ``pod`` and ``multipod`` raise (the
multi-device port is ROADMAP A12.5).  The device defaults to ``cuda``,
which raises without a GPU.  Prints the reference's lines: "step N loss
... gnorm ... (ms/step)" every ``--log-every`` steps and at the last,
"resumed from step N", "done".
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs.registry import get_config
from ..core.device import resolve_device
from ..models.steps import make_train_step
from ..models.transformer import init_params
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..train.data import DataConfig, SyntheticTokenStream
from ..train.optim import AdamState, adamw_init, cosine_schedule


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt_state: AdamState
    start: int              # the first step this run took
    metrics: list           # each step's metrics (0-d tensors)
    step_end_s: list        # seconds from the first step's start to each
                            # step's end (after its log line, if any)


def _as_saved(opt: AdamState) -> AdamState:
    """The reference's ``AdamState``: its step a 0-d int32 array."""
    return AdamState(torch.tensor(int(opt.step), dtype=torch.int32),
                     opt.mu, opt.nu)


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

    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh}: multi-device "
                                  f"training is not ported yet (ROADMAP "
                                  f"A12.5)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    params = init_params(cfg, args.seed, device)
    opt_state = adamw_init(params)
    sched = cosine_schedule(args.lr, args.lr * 0.1, args.steps,
                            warmup=max(args.steps // 20, 1))
    step_fn = make_train_step(cfg, lr_schedule=sched)

    data = SyntheticTokenStream(cfg, DataConfig(args.seq, args.batch,
                                                seed=args.seed), device)
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            (params, saved), extra = restore_checkpoint(
                args.ckpt_dir, last, (params, _as_saved(opt_state)))
            opt_state = AdamState(int(saved.step), saved.mu, saved.nu)
            data.restore(extra["data"])
            start = last + 1
            print(f"resumed from step {last}")

    metrics, ends = [], []
    t_start = time.time()
    for step in range(start, args.steps):
        batch = data.next_batch()
        params, opt_state, m = step_fn(params, opt_state, batch, step)
        metrics.append(m)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"({(time.time()-t_start)/max(step-start+1,1)*1e3:.0f}"
                  f" ms/step)", flush=True)
        ends.append(time.time() - t_start)
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step,
                            (params, _as_saved(opt_state)),
                            extra={"data": data.state()})
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps - 1,
                        (params, _as_saved(opt_state)),
                        extra={"data": data.state()})
    print("done")
    return TrainResult(params, opt_state, start, metrics, ends)


if __name__ == "__main__":
    main()
