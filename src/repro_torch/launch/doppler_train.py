"""DOPPLER policy-training CLI, the paper's three-stage pipeline
(counterpart of ``repro/launch/doppler_train.py``), on one device.

  PYTHONPATH=src python -m repro_torch.launch.doppler_train \\
      --graph ffnn --devices p100x4 \\
      --stage1 100 --stage2 100 --stage3 20 \\
      --engine batched --system sim --ckpt-dir runs/ffnn

  # Stage II on the fused engine (each update one CUDA graph replay),
  # Stage III batched against the work-conserving executor on the card's
  # streams, the Stage II twin calibrated from executor probes first:
  PYTHONPATH=src python -m repro_torch.launch.doppler_train \\
      --graph ffnn --devices p100x4 --stage1 60 --stage2 60 --stage3 10 \\
      --engine fused --system executor --calibrate --stage3-batch 8

``--device`` (default cuda) is where the policy, the oracle and the
executor run; ``--device cpu`` runs everything on the host.  Stage II
reward engines (``--engine``): 'serial' is the per-episode loop and
'batched' the population path, both on the numpy simulator; 'oracle' the
WC oracle on the device (``sim_torch.TorchWCEngine``: one ``wc_trips``
launch a reward batch on the card), the reference's ``--engine jax``
(its ``JaxOracleEngine``), renamed since the port has no JAX; 'fused'
the device-resident train step.  Stage III (``--system``): 'sim' scores
against a noisier twin, 'executor' against the measured wall-clock of
``core/executor.py`` (``--stage3-batch K`` takes one batch-averaged
gradient per K measurements; 1 keeps the serial paper protocol).
``--calibrate`` fits the twin's fleet to executor probe measurements
before Stage II.  A checkpoint is saved after every stage
(``--ckpt-dir``) and ``--resume`` restores params, optimizer, reward
statistics and the generator for exact continuation.  ``--events`` runs
Stage II under the fault-tolerance supervisor; ``--hierarchy`` trains on
a coarsened graph; ``--trace`` writes a Perfetto schedule of the best
assignment.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.calibrate import calibrate_fleet, executor_measure
from ..core.device import resolve_device
from ..core.devices import get_device_model
from ..core.engine import ExecutorRewardEngine, SimRewardEngine, as_engine
from ..core.enumopt import enumerative_assignment
from ..core.executor import WCExecutor
from ..core.heuristics import best_critical_path
from ..core.policy_io import load_policy, save_policy
from ..core.sim_torch import TorchWCEngine
from ..core.simulator import WCSimulator
from ..core.trace import utilization_ascii, write_chrome_trace
from ..core.training import DopplerTrainer
from ..graphs.workloads import get_workload


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DOPPLER three-stage training pipeline")
    ap.add_argument("--graph", required=True,
                    help="chainmm|ffnn|llama_block|llama_layer|model:<arch>")
    ap.add_argument("--devices", default="p100x4")
    ap.add_argument("--stage1", type=int, default=100,
                    help="Stage-I imitation episodes")
    ap.add_argument("--stage2", type=int, default=125,
                    help="Stage-II updates (episodes = updates x batch)")
    ap.add_argument("--stage2-batch", type=int, default=8)
    ap.add_argument("--engine", default="batched",
                    choices=["serial", "batched", "oracle", "fused"],
                    help="Stage-II reward engine ('oracle': the WC oracle "
                         "on --device, the reference's 'jax' choice)")
    ap.add_argument("--stage3", type=int, default=25,
                    help="Stage-III updates (episodes = updates x batch)")
    ap.add_argument("--stage3-batch", type=int, default=8,
                    help="real measurements per Stage-III gradient "
                         "(1 = the serial paper protocol)")
    ap.add_argument("--system", default="sim", choices=["sim", "executor"],
                    help="Stage-III reward source")
    ap.add_argument("--repeats", type=int, default=1,
                    help="interleaved executor repeats per measurement")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the Stage-II twin's DeviceModel from "
                         "executor probe measurements first")
    ap.add_argument("--noise", type=float, default=0.03,
                    help="Stage-II sim noise sigma")
    ap.add_argument("--flops-scale", type=float, default=1e-4,
                    help="executor payload scale")
    ap.add_argument("--bytes-scale", type=float, default=1e-3)
    ap.add_argument("--lr0", type=float, default=3e-3)
    ap.add_argument("--lr1", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--sel-mode", default="learned",
                    choices=["learned", "cp"])
    ap.add_argument("--plc-mode", default="learned",
                    choices=["learned", "etf"])
    ap.add_argument("--hierarchy", type=int, default=0, metavar="SEGMENTS",
                    help="hierarchical coarsen->place->refine with this "
                         "target segment count (0 = flat placement); use "
                         "for full-model graphs (model:<arch>:full)")
    ap.add_argument("--refine-rounds", type=int, default=2,
                    help="bounded boundary-refinement rounds after "
                         "hierarchical placement")
    ap.add_argument("--refine-top-k", type=int, default=16,
                    help="boundary vertices re-placed per refinement round")
    ap.add_argument("--hier-max-ratio", type=float, default=16.0,
                    help="per-level contraction bound of the multi-level "
                         "V-cycle; graphs within one ratio of SEGMENTS "
                         "coarsen in a single level")
    ap.add_argument("--hier-max-levels", type=int, default=16,
                    help="hard cap on V-cycle depth")
    ap.add_argument("--events", nargs="*", default=None,
                    metavar="STEP:EVENT",
                    help="dynamic-fleet schedule for Stage II, e.g. "
                         "'40:loss:2' '60:straggler:1:0.5' "
                         "'80:link:0:0.25' — runs Stage II under the "
                         "fault-tolerance supervisor: device losses roll "
                         "back to the last snapshot, re-form the fleet "
                         "and re-place within --replace-budget; non-fatal "
                         "events re-place inline (requires --system sim)")
    ap.add_argument("--replace-budget", type=float, default=5.0,
                    metavar="SECONDS",
                    help="wall-clock budget for each re-placement")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the policy, the oracle and the "
                         "executor (cuda or cpu)")
    return ap


def _save_stage(args, trainer, stage: str):
    if args.ckpt_dir:
        path = save_policy(args.ckpt_dir, trainer)
        print(f"[{stage}] checkpoint saved: {path}")


def main(argv=None) -> dict:
    """Run the pipeline; -> the trainer, the executor (or None), the CP
    makespan, the evaluated mean and std and the evaluated assignment."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # the executor's devices: the card (one stream a logical device), or
    # the host run serially
    ex_devices = None if device.type == "cuda" else [device]

    g = get_workload(args.graph)
    dev = get_device_model(args.devices)

    # ------------------------------------------------- real system + twin
    executor = None
    if args.system == "executor":
        executor = WCExecutor(g, devices=ex_devices,
                              flops_scale=args.flops_scale,
                              bytes_scale=args.bytes_scale, n_virtual=dev.n)
    dev_twin = dev
    if args.calibrate:
        cal = calibrate_fleet(
            dev, executor_measure(dev.n, repeats=max(args.repeats, 3),
                                  flops_scale=args.flops_scale,
                                  bytes_scale=args.bytes_scale,
                                  devices=ex_devices))
        dev_twin = cal.fleet
        print(f"calibrated {dev.name} from {cal.n_measurements} executor "
              f"measurements: overhead={cal.exec_overhead} "
              f"rel_residual={cal.rel_residual:.3f}")

    hier_cfg = None
    if args.hierarchy:
        from ..core.hierarchy import HierarchyConfig
        hier_cfg = HierarchyConfig(n_segments=args.hierarchy,
                                   refine_rounds=args.refine_rounds,
                                   refine_top_k=args.refine_top_k,
                                   max_ratio=args.hier_max_ratio,
                                   max_levels=args.hier_max_levels)

    total = (args.stage1 + args.stage2 * args.stage2_batch
             + args.stage3 * args.stage3_batch)
    trainer = DopplerTrainer(g, dev_twin, seed=args.seed,
                             total_episodes=max(total, 1),
                             lr0=args.lr0, lr1=args.lr1,
                             sel_mode=args.sel_mode, plc_mode=args.plc_mode,
                             hierarchy=hier_cfg, device=device)
    if args.resume and args.ckpt_dir:
        load_policy(args.ckpt_dir, trainer)
        print(f"resumed at episode {trainer.episode}")

    # policy graph: the segment graph when hierarchical, else the flat one.
    # Stage II trains against it; Stage III and the final evaluation score
    # flat assignments (through ExpandingEngine when hierarchical).
    pg = trainer.g
    if hier_cfg is not None:
        sizes = " -> ".join(
            str(p.seg_graph.n) for p in trainer.hier.partition.levels)
        print(f"hierarchy: {g.n}-vertex graph -> {sizes} segments "
              f"({trainer.hier.n_levels} level(s), "
              f"refine {args.refine_rounds}x{args.refine_top_k})")
        for st in trainer.hier.partition.level_stats:
            print(f"  level {st['level']}: {st['n_in']} -> {st['n_out']} "
                  f"(target {st['target']}) in {st['seconds']:.2f}s")
    sim = WCSimulator(pg, dev_twin, choose="fifo", noise_sigma=args.noise)
    if args.system == "executor":
        stage3_engine = ExecutorRewardEngine(executor, repeats=args.repeats)
        real_eval = stage3_engine
    else:
        real_eval = SimRewardEngine(
            WCSimulator(g, dev, choose="fifo", noise_sigma=0.08))
        stage3_engine = real_eval
    if hier_cfg is not None:
        from ..core.hierarchy import ExpandingEngine
        stage3_engine = ExpandingEngine(trainer.hier, stage3_engine)

    # flat CRITICAL-PATH baseline, the reference's protocol: scored on the
    # noisy Stage-II twin at seed=0 through the batch engine, fewer trials
    # on large graphs (one CP run is O(n * devices) python); a flat
    # trainer's `sim` already is the flat noisy twin
    flat_sim = sim if hier_cfg is None else WCSimulator(
        g, dev_twin, choose="fifo", noise_sigma=args.noise)
    flat_eval = WCSimulator(g, dev_twin, choose="fifo", noise_sigma=0.0)
    cp_trials = 30 if g.n <= 1500 else 5
    cp_a, cp_t = best_critical_path(
        g, dev_twin, lambda a: flat_sim.batch_engine.exec_time(a, seed=0),
        n_trials=cp_trials)
    enum_txt = ""
    if g.n <= 1500:
        enum_t = flat_sim.batch_engine.exec_time(
            enumerative_assignment(g, dev_twin), seed=0)
        enum_txt = f" EnumOpt={enum_t*1e3:.2f}ms"
    print(f"{args.graph} on {args.devices}: CP={cp_t*1e3:.2f}ms{enum_txt}")

    # ------------------------------------------------------------ Stage I
    if args.stage1:
        if args.engine == "fused":
            nll = trainer.stage1_imitation_fused(args.stage1)
        else:
            nll = trainer.stage1_imitation(args.stage1)
        print(f"stage I : imitation NLL {nll[0]:.3f} -> {nll[-1]:.3f}")
        _save_stage(args, trainer, "stage1")

    # ----------------------------------------------------------- Stage II
    if args.stage2:
        log = max(args.stage2 // 5, 1)
        if args.events:
            if args.system == "executor":
                raise SystemExit("--events requires --system sim: the "
                                 "executor's virtual fleet cannot shrink")
            from ..core.devices import parse_event
            from ..train.fault_tolerance import (SupervisorConfig,
                                                 supervise_stage2)
            sched = {}
            for spec in args.events:
                step_s, _, rest = spec.partition(":")
                sched[int(step_s)] = parse_event(rest)
            out = supervise_stage2(
                trainer, args.stage2, events=sched,
                cfg=SupervisorConfig(ckpt_every=max(args.stage2 // 10, 1),
                                     replace_budget_s=args.replace_budget),
                batch_size=args.stage2_batch)
            for line in out["log"]:
                print(f"[supervisor] {line}")
            print(f"stage II : {out['steps']} supervised updates, "
                  f"{out['recoveries']} recoveries, "
                  f"{len(out['replacements'])} re-placements; fleet now "
                  f"{trainer.dev.name} ({trainer.dev.n} devices)")
            if trainer.dev is not dev_twin:
                # the fleet changed mid-run: every downstream engine and
                # the CP baseline must score the SURVIVING fleet
                dev_twin = trainer.dev
                flat_sim = WCSimulator(g, dev_twin, choose="fifo",
                                       noise_sigma=args.noise)
                flat_eval = WCSimulator(g, dev_twin, choose="fifo",
                                        noise_sigma=0.0)
                real_eval = SimRewardEngine(
                    WCSimulator(g, dev_twin, choose="fifo",
                                noise_sigma=0.08))
                stage3_engine = real_eval
                if hier_cfg is not None:
                    from ..core.hierarchy import ExpandingEngine
                    stage3_engine = ExpandingEngine(trainer.hier,
                                                    stage3_engine)
                cp_a, cp_t = best_critical_path(
                    g, dev_twin,
                    lambda a: flat_sim.batch_engine.exec_time(a, seed=0),
                    n_trials=min(cp_trials, 10))
                print(f"post-event CP baseline on {dev_twin.name}: "
                      f"{cp_t*1e3:.2f}ms")
        elif args.engine == "serial":
            trainer.stage2_sim(args.stage2 * args.stage2_batch, sim,
                               log_every=log * args.stage2_batch)
        elif args.engine == "batched":
            trainer.stage2_sim_batched(args.stage2, sim,
                                       batch_size=args.stage2_batch,
                                       log_every=log)
        elif args.engine == "oracle":
            trainer.train_rl(TorchWCEngine(pg, dev_twin,
                                           backend=trainer.oracle_backend,
                                           device=device),
                             args.stage2, batch_size=args.stage2_batch,
                             stage="sim_oracle", log_every=log)
        else:                                                # fused
            trainer.stage2_fused(args.stage2, batch_size=args.stage2_batch,
                                 log_every=log)
        _save_stage(args, trainer, "stage2")

    # ---------------------------------------------------------- Stage III
    if args.stage3:
        log = max(args.stage3 // 5, 1)
        if args.stage3_batch == 1:
            trainer.stage3_system(
                args.stage3,
                lambda a: stage3_engine.exec_time(a, trainer.episode),
                log_every=log)
        else:
            trainer.stage3_system_batched(args.stage3, stage3_engine,
                                          batch_size=args.stage3_batch,
                                          log_every=log)
        _save_stage(args, trainer, "stage3")

    # --------------------------------------------------------------- eval
    if hier_cfg is not None:
        # flat placement: best-of(policy greedy, best sample, segment-CP)
        # expanded, then bounded boundary refinement on the flat graph
        # (refined against the noise-free twin; reported on real_eval)
        a = trainer.place(engine=flat_eval).assignment
        mean, std = eval_mean_std_engine(real_eval, a)
    else:
        mean, std, a = trainer.evaluate(real_eval)
    print(f"DOPPLER best: {mean*1e3:.2f} +- {std*1e3:.2f} ms "
          f"({100*(1 - mean/cp_t):+.1f}% vs CP)")
    if args.trace or g.n <= 2000:
        res = WCSimulator(g, dev_twin, choose="fifo",
                          noise_sigma=args.noise).run(a, record=True)
        print(utilization_ascii(res))
        if args.trace:
            write_chrome_trace(args.trace, res, g)
            print(f"perfetto trace: {args.trace}")
    return {"trainer": trainer, "executor": executor, "cp": cp_t,
            "best": (mean, std), "assignment": a}


def eval_mean_std_engine(engine, assignment, n_runs: int = 10):
    """mean/std of repeated flat-assignment evaluations via the engine."""
    ts = as_engine(engine).evaluate_repeats(assignment, n_runs)
    return float(np.mean(ts)), float(np.std(ts))


if __name__ == "__main__":
    main()
