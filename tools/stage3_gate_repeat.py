"""Repeat ``chip_smoke.py``'s Stage III update-1 gate N times on one CUDA
card (ROADMAP C5): one calibrated fleet and one fused Stage I / II
trainer, then per repeat a fresh kernel trainer taking one Stage III
update over the executor and a plain-backend twin replaying its measured
times, both from that trainer's state (draws seeded 1..N); a second
kernel trainer and a second plain twin replay the same times, to tell a
non-deterministic path from a numerics gap.  Prints one JSON line a
repeat (the gradient gap over the tree's max, the worst leaf, the
replays' gaps) and a ``SUMMARY`` line, with the card's name and power
limit::

    python3 tools/stage3_gate_repeat.py 30
"""
import json
import os
import subprocess
import sys
import time

root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [root, os.path.join(root, "src")]
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.nn import tree_leaves  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def grads_gap(a, b):
    """(max leaf gap over the tree's max, the worst leaf as (index,
    shape, max |g|, gap))."""
    pairs = list(zip(tree_leaves(a.last_update["grads"]),
                     tree_leaves(b.last_update["grads"])))
    tree = max(1.0, max(float(gp.abs().max()) for _, gp in pairs))
    rows = [(i, tuple(gp.shape), float(gp.abs().max()),
             float((gk - gp).abs().max())) for i, (gk, gp) in enumerate(pairs)]
    worst = max(rows, key=lambda r: r[3])
    return worst[3] / tree, worst


def main(n: int) -> None:
    dev = torch.device("cuda")
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    gname, fleet = cs.TRAIN_REQUEST
    g, fm = cs.get_workload(gname), cs.get_device_model(fleet)
    ex = cs.WCExecutor(g, n_virtual=fm.n)
    cal = cs.calibrate_fleet(fm, cs.executor_measure(
        fm.n, repeats=cs.STAGE3_REPEATS))
    base = cs.DopplerTrainer(g, cal.fleet, seed=0, device=dev)
    base.stage1_imitation_fused(cs.STAGE3_S1)
    base.stage2_fused(cs.STAGE3_S2, batch_size=cs.TRAIN_K,
                      updates_per_dispatch=cs.FUSED_DISPATCH)
    engine = cs.ExecutorRewardEngine(ex)

    def fresh(plain: bool):
        kw = (dict(encoder_backend="torch", oracle_backend="torch")
              if plain else {})
        t = cs.DopplerTrainer(g, cal.fleet, seed=0, device=dev, **kw)
        cs._copy_state(base, t)
        t.best_time, t.best_assignment = np.inf, None
        return t

    rows, t0 = [], time.time()
    for i in range(n):
        draws = [cs._draw_tables(np.random.default_rng(1 + i), g.n,
                                 cs.STAGE3_K, fm.n)]
        kern = fresh(False)
        kern.stage3_system_batched(1, engine, batch_size=cs.STAGE3_K,
                                   repeats=cs.STAGE3_REPEATS, draws=draws)
        measured = -np.asarray(kern.last_update["rewards"])
        replays = []
        for plain in (True, False, True):
            t = fresh(plain)
            t.stage3_system_batched(
                1, cs.CallableEngine(lambda A: measured, batched=True),
                batch_size=cs.STAGE3_K, draws=draws)
            replays.append(t)
        gap, worst = grads_gap(kern, replays[0])
        r = {"i": i, "kernel_vs_plain": gap, "worst_leaf": worst,
             "kernel_vs_kernel": grads_gap(kern, replays[1])[0],
             "plain_vs_plain": grads_gap(replays[0], replays[2])[0],
             "measured_ms": [float(x * 1e3) for x in measured]}
        rows.append(r)
        print(json.dumps(r), flush=True)
    print("SUMMARY", json.dumps({
        "card": cs.CARD, "n": n,
        "max_kernel_vs_plain": max(r["kernel_vs_plain"] for r in rows),
        "min_kernel_vs_plain": min(r["kernel_vs_plain"] for r in rows),
        "over_bar": sum(r["kernel_vs_plain"] > cs.TRAIN_GRAD_TOL
                        for r in rows),
        "max_kernel_vs_kernel": max(r["kernel_vs_kernel"] for r in rows),
        "max_plain_vs_plain": max(r["plain_vs_plain"] for r in rows),
        "seconds": time.time() - t0}))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 30)
