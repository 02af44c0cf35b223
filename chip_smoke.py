#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DOPPLER on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases (any failure exits non-zero, and no result line is printed):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build: compiles every kernel in ``src/repro_torch/csrc`` with nvcc for
   sm_90a, all sources in parallel.
3. kernels vs their plain versions on the card: ``gnn_mp`` (max relative
   error <= 1e-5) at the main path's shapes and on a ~10^6-edge random
   graph; ``wc_oracle`` bit-exact on run_out and e1 (rho where alive) at
   the main path's shape B=257, R=72, K=8 and random shapes with drained,
   all-dropped and tied rows.  Times each kernel, its plain version and
   (gnn_mp) the one-call library yardstick ``index_add_`` with CUDA events.
4. main path: three placement requests through ``DopplerTrainer(...,
   device="cuda")`` at the policy's published width (d_hidden 64, d_z 32,
   d_y 32, 2 GNN layers, random weights from a seed): greedy plus 256
   samples at eps 0.2, scored in one ``wc_oracle`` batch.  Kernel launch
   counts are reset just before and read just after; each kernel must have
   launched.  Then: the population's makespans with the kernel equal the
   plain oracle's on the card; on the small request they also equal the
   CPU oracle's and the card's encodings agree with the CPU's.
5. profile: one more ``llama_layer`` request under ``torch.profiler``
   (device time per kernel, the device's busy share of the request).
6. prints the ``kernels`` JSON line and, last, the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.assign import build_graph_data, encode  # noqa: E402
from repro_torch.core.device import sync  # noqa: E402
from repro_torch.core.devices import get_device_model  # noqa: E402
from repro_torch.core.heuristics import critical_path_assignment  # noqa: E402
from repro_torch.core.nn import tree_map  # noqa: E402
from repro_torch.core.sim_torch import TorchWCEngine  # noqa: E402
from repro_torch.core.training import DopplerTrainer  # noqa: E402
from repro_torch.graphs.workloads import get_workload  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gnn_mp import ops as gnn_ops  # noqa: E402
from repro_torch.kernels.gnn_mp.ref import (build_csr,  # noqa: E402
                                            segment_sum_ref)
from repro_torch.kernels.wc_oracle import ops as wc_ops  # noqa: E402
from repro_torch.kernels.wc_oracle.ref import wc_step_ref  # noqa: E402

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12            # outside the tensor cores
K_POP = 256
EPS = 0.2
REQUESTS = [("llama_layer", "v100x8"), ("llama_block", "mixed_gen4"),
            ("ffnn", "p100x4")]
GNN_REL_TOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- gnn_mp
def check_gnn_mp(dev) -> dict:
    """Kernel vs plain at the main path's aggregations (llama_layer's two
    edge directions, d = 64) and on a random 2^20-edge graph."""
    g = get_workload("llama_layer")
    edges = torch.as_tensor(g.edge_array(), dtype=torch.long, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    n, d = g.n, 64
    cases = [(edges[:, 1], n), (edges[:, 0], n),
             (torch.randint(0, 2**17, (2**20,), generator=gen, device=dev),
              2**17)]
    max_abs = max_rel = 0.0
    for idx, segs in cases:
        msg = torch.randn(idx.shape[0], d, generator=gen, device=dev)
        csr = build_csr(idx, segs)
        got = gnn_ops.segment_sum(msg, idx, segs, backend="cuda", csr=csr)
        ref = segment_sum_ref(msg, idx, segs, csr)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        print(f"gnn_mp m={idx.shape[0]} n={segs} d={d}: max_abs_err={err} "
              f"max_rel_err={rel}")
        check(rel <= GNN_REL_TOL, f"gnn_mp relative error {rel} > "
                                  f"{GNN_REL_TOL}")
        max_abs, max_rel = max(max_abs, err), max(max_rel, rel)

    # timing at the main path's shape (incoming direction)
    idx = edges[:, 1]
    m = idx.shape[0]
    msg = torch.randn(m, d, generator=gen, device=dev)
    csr = build_csr(idx, n)
    ms = time_ms(lambda: gnn_ops.segment_sum(msg, idx, n, backend="cuda",
                                             csr=csr))
    plain_ms = time_ms(lambda: segment_sum_ref(msg, idx, n, csr))
    library_ms = time_ms(lambda: torch.zeros(n, d, device=dev).index_add_(
        0, idx, msg))
    nbytes = 4 * (m * d + m + (n + 1) + n * d)    # msg, perm, row_ptr, out
    b_ms, b_by = bound_ms(nbytes, m * d)
    return {"name": "gnn_mp", "route": "cuda",
            "source": "src/repro_torch/csrc/gnn_mp.cu",
            "replaces": "src/repro/kernels/gnn_mp/kernel.py:31",
            "launches": 0, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            "shape": {"m": m, "n": n, "d": d}}


# ---------------------------------------------------------- wc_oracle
def _wc_state(rng, B, R, K, dev):
    """Random tables honoring the kernel contract (exact-integer keys,
    identical rows on duplicate targets), with idle slots, dropped rows,
    a drained all-dropped episode and a fully tied episode."""
    run = rng.integers(0, 50, size=(B, R, 6)).astype(np.float32)
    run[..., 0] = np.where(rng.random((B, R)) < 0.4, np.inf,
                           run[..., 0] + 1.0)
    tgt = rng.integers(0, R, size=(B, K))
    base = rng.integers(0, 50, size=(B, R, 6)).astype(np.float32)
    rows = np.take_along_axis(base, tgt[:, :, None], axis=1)
    ridx = np.where(rng.random((B, K)) < 0.3, -1, tgt).astype(np.int32)
    run[0, :, 0] = np.inf                         # drained ...
    ridx[0] = -1                                  # ... and all dropped
    if B > 1:
        run[1, :, :4] = 3.0                       # every row tied
        ridx[1] = -1
    return [torch.from_numpy(x).to(dev) for x in (run, rows, ridx)]


def check_wc_oracle(dev) -> dict:
    rng = np.random.default_rng(0)
    shapes = [(257, 72, 8), (3, 20, 5), (2, 2, 1), (16, 257, 129),
              (1000, 300, 40)]
    shapes += [(int(rng.integers(1, 600)), int(rng.integers(1, 400)),
                int(rng.integers(1, 150))) for _ in range(6)]
    for B, R, K in shapes:
        run, rows, ridx = _wc_state(rng, B, R, K, dev)
        out_k, rho_k, e1_k = wc_ops.wc_step(run, rows, ridx, backend="cuda")
        out_r, rho_r, e1_r = wc_step_ref(run, rows, ridx)
        torch.cuda.synchronize()
        alive = torch.isfinite(e1_r)
        check(torch.equal(out_k, out_r), f"wc_oracle run_out {B, R, K}")
        check(torch.equal(e1_k, e1_r), f"wc_oracle e1 {B, R, K}")
        check(torch.equal(rho_k[alive], rho_r[alive]),
              f"wc_oracle rho {B, R, K}")
    print(f"wc_oracle bit-exact on {len(shapes)} shapes "
          f"(B, R, K) = {shapes}")

    B, R, K = 257, 72, 8
    run, rows, ridx = _wc_state(rng, B, R, K, dev)
    ms = time_ms(lambda: wc_ops.wc_step(run, rows, ridx, backend="cuda"))
    plain_ms = time_ms(lambda: wc_step_ref(run, rows, ridx))
    # each input read once, each output written once; compares/selects:
    # K target tests per row, then ~14 per row for the four chained mins
    nbytes = 4 * B * (2 * R * 6 + K * 6 + K + 2)
    b_ms, b_by = bound_ms(nbytes, B * R * (K + 14))
    return {"name": "wc_oracle", "route": "cuda",
            "source": "src/repro_torch/csrc/wc_oracle.cu",
            "replaces": "src/repro/kernels/wc_oracle/kernel.py:41",
            "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": {"B": B, "R": R, "K": K}}


# ------------------------------------------------------------ main path
def main_path(dev):
    trainers = []
    for gname, fleet in REQUESTS:
        trainers.append(DopplerTrainer(get_workload(gname),
                                       get_device_model(fleet), seed=0,
                                       device=dev))
    for tr in trainers:                   # first-use set-up (cuBLAS, ...)
        encode(tr.params, tr.gd, tr.encoder_backend)
    sync(dev)
    gnn_ops.launches = wc_ops.launches = 0
    answers, per_request = [], []
    for tr in trainers:
        g0, w0 = gnn_ops.launches, wc_ops.launches
        answers.append(tr.place(n_samples=K_POP, eps=EPS))
        per_request.append((gnn_ops.launches - g0, wc_ops.launches - w0))
    launches = {"gnn_mp": gnn_ops.launches, "wc_oracle": wc_ops.launches}
    return trainers, answers, per_request, launches


def check_main_path(trainers, answers, per_request, dev) -> None:
    for (gname, fleet), tr, pl, (lg, lw) in zip(REQUESTS, trainers, answers,
                                                per_request):
        g = tr.g
        check(tr.encoder_backend == tr.oracle_backend == "cuda",
              "backends default to cuda on the card")
        check(pl.population.shape == (K_POP, g.n), "population shape")
        cands = np.concatenate([pl.greedy[None], pl.population])
        check(bool(((cands >= 0) & (cands < tr.dev.n)).all()),
              "assignments in range")
        check(bool(np.isfinite(pl.makespans).all())
              and pl.makespans.shape == (K_POP + 1,), "finite makespans")
        check(pl.makespan == pl.makespans.min()
              and np.array_equal(pl.assignment,
                                 cands[int(pl.makespans.argmin())]),
              "place returns the scored best")
        plain = TorchWCEngine(g, tr.dev, backend="torch", device=dev)
        check(np.array_equal(plain.run_batch(cands), pl.makespans),
              f"{gname}: kernel oracle == plain oracle on the card")
        cp = critical_path_assignment(g, tr.dev, seed=0)
        cp_ms = tr.default_engine().exec_time(cp)
        sec = pl.seconds
        print(f"request {gname} x {fleet}: n={g.n} m={g.m} nd={tr.dev.n} "
              f"K_pop={K_POP} greedy_ms={pl.makespans[0] * 1e3:.6f} "
              f"best_sampled_ms={pl.makespans[1:].min() * 1e3:.6f} "
              f"cp_ms={cp_ms * 1e3:.6f} encode_s={sec['encode']:.6f} "
              f"rollout_s={sec['rollout']:.6f} "
              f"oracle_s={sec['oracle']:.6f} "
              f"launches gnn_mp={lg} wc_oracle={lw}")

    # small input against the CPU reference: same params, same inputs
    tr, pl = trainers[-1], answers[-1]
    cands = np.concatenate([pl.greedy[None], pl.population])
    cpu_ms = TorchWCEngine(tr.g, tr.dev, backend="torch",
                           device="cpu").run_batch(cands)
    check(np.array_equal(cpu_ms, pl.makespans),
          "ffnn: card oracle == CPU oracle")
    gd_cpu = build_graph_data(tr.g, tr.dev, tr.comm_factor, "cpu")
    params_cpu = tree_map(lambda x: x.cpu(), tr.params)
    for a, b in zip(encode(tr.params, tr.gd, "cuda"),
                    encode(params_cpu, gd_cpu, "torch")):
        err = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                     1.0)
        check(err <= 1e-4, f"ffnn: card encodings vs CPU, rel err {err}")
    print("ffnn x p100x4: card oracle == CPU oracle on all "
          f"{len(cands)} candidates; encodings agree with the CPU")


def profile_request(tr, untraced_s: float) -> dict:
    """One more ``llama_layer`` request under ``torch.profiler``: device
    time per kernel name and the device's busy share of the request.
    Tracing slows the host side only, so the share is also given against
    the untraced request's wall time from the main path."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.place(n_samples=K_POP, eps=EPS)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    rows = []
    for avg in prof.key_averages():
        if str(avg.device_type).endswith("CUDA"):
            us = getattr(avg, "self_device_time_total", None)
            if us is None:
                us = avg.self_cuda_time_total
            rows.append((us, avg.count, avg.key))
    busy_s = sum(r[0] for r in rows) * 1e-6
    rows.sort(reverse=True)
    print(f"profile llama_layer request: traced_s={traced_s:.6f} "
          f"untraced_s={untraced_s:.6f} device_busy_s={busy_s:.6f} "
          f"busy_share_traced={busy_s / traced_s:.6f} "
          f"busy_share_untraced={busy_s / untraced_s:.6f} "
          f"device_launches={sum(r[1] for r in rows)}")
    for us, count, key in rows[:8]:
        print(f"  {us * 1e-3:10.3f} ms  {count:6d} x  {key[:90]}")
    device_ms = {}
    for name, tag in (("gnn_mp", "segment_sum_csr"), ("wc_oracle",
                                                       "wc_step(")):
        hit = [(us, c) for us, c, key in rows if tag in key]
        device_ms[name] = (sum(h[0] for h in hit) * 1e-3
                           / max(sum(h[1] for h in hit), 1)) if hit else None
    return device_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = [check_gnn_mp(dev), check_wc_oracle(dev)]
    trainers, answers, per_request, launches = main_path(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} launched on the main path")
    check_main_path(trainers, answers, per_request, dev)
    device_ms = profile_request(trainers[0], sum(answers[0].seconds.values()))
    for k in kernels:
        k["device_ms"] = device_ms[k["name"]]

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
