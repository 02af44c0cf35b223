"""Copy of ``src/repro/core/calibrate.py`` (the port imports nothing of ``repro``).

Sim-to-real calibration: fit a `DeviceModel` to measured executor runs.

Stage II trains against the WC digital twin, Stage III against the real
system; the closer the twin's `DeviceModel` is to the hardware, the less
Stage III has to un-learn (the paper's §5 motivation for the two-reward
split).  This module fits the fleet parameters — per-device kernel-launch
overheads ``o_d``, per-device compute rates ``r_d``, and directed link
bandwidths ``bw_ij`` — by least squares over *measured makespans of probe
assignments*, where the measurement oracle is anything with the
``measure(graph, assignments) -> (K,) seconds`` shape (the plan-compiled
``WCExecutor`` in production, a ground-truth simulator in tests).

The probes are chosen so the WC makespan is *linear* in the unknowns:

* **Device probes** — chain graphs with every vertex assigned to one
  device ``d``.  A single compute resource never idles while work
  remains, and a chain has no cross-device edges, so the makespan is
  exactly ``N*o_d + (sum flops)/r_d`` — one linear equation per probe
  graph in ``(o_d, 1/r_d)``.  Probe graphs span overhead-dominated
  (tiny flops) to compute-dominated (large flops) regimes, giving a
  well-conditioned least-squares fit per device.
* **Link probes** — chain graphs alternating between devices ``i`` and
  ``j``: every edge crosses, strictly serialized, so the makespan is
  ``exec terms + n_ij*(lat_ij + b/bw_ij) + n_ji*(lat_ji + b/bw_ji)``
  with ``n_ij = ceil((N-1)/2)`` for the chain starting on ``i``.
  Differencing two byte sizes cancels the exec and latency terms
  entirely; the two chain phases (start-i / start-j) give an invertible
  2x2 system in ``(1/bw_ij, 1/bw_ji)`` — asymmetric links are recovered
  per direction.

Every probe family is evaluated in ONE ``measure`` call (the executor's
``execute_batch`` amortizes warmup and interleaves repeats), so a full
calibration of an ``nd``-device fleet costs ``n_device_probes +
n_byte_sizes`` measurement batches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .devices import DeviceModel
from .graph import DataflowGraph

MeasureFn = Callable[[DataflowGraph, np.ndarray], np.ndarray]


# ---------------------------------------------------------------------------
# Probe graphs
# ---------------------------------------------------------------------------
def probe_chain(n_compute: int, flops: float, nbytes: float,
                name: str = "probe_chain") -> DataflowGraph:
    """1 input -> `n_compute` serial matmuls, uniform flops/out_bytes."""
    g = DataflowGraph(name)
    prev = g.add_vertex("input", out_bytes=nbytes)
    for i in range(n_compute):
        v = g.add_vertex("matmul", flops=flops, out_bytes=nbytes, meta_op=i)
        g.add_edge(prev, v)
        prev = v
    return g.freeze()


# ---------------------------------------------------------------------------
# Result container
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CalibrationResult:
    fleet: DeviceModel                  # calibrated copy of the base fleet
    exec_overhead: np.ndarray           # (nd,) fitted per-device overhead
    flops_per_sec: np.ndarray           # (nd,) fitted per-device rate
    link_bw: np.ndarray                 # (nd, nd) fitted bandwidths
    residuals: dict                     # per-family relative residuals
    n_measurements: int                 # total probe episodes measured

    @property
    def rel_residual(self) -> float:
        """Overall relative RMS residual of the fit."""
        return float(self.residuals.get("overall", np.nan))


def _rel_rms(pred: np.ndarray, meas: np.ndarray) -> float:
    meas = np.maximum(np.asarray(meas, dtype=float), 1e-30)
    return float(np.sqrt(np.mean(((pred - meas) / meas) ** 2)))


# ---------------------------------------------------------------------------
# Fit
# ---------------------------------------------------------------------------
def calibrate_fleet(base: DeviceModel, measure: MeasureFn, *,
                    chain_len: int = 16,
                    flops_probes: tuple[float, ...] = (0.05, 2.0, 50.0),
                    probe_bytes: tuple[float, float] | None = None,
                    fit_links: bool = True,
                    name: str | None = None) -> CalibrationResult:
    """Fit per-device overheads/rates (and link bandwidths) of `base`.

    ``measure(graph, assignments)`` must return one makespan (seconds)
    per assignment row — e.g. ``executor_measure(...)`` for hardware or
    ``simulator_measure(truth_fleet)`` for tests.  ``flops_probes`` are
    per-vertex flop counts in units of ``o_typ * r_typ`` (the flop count
    whose compute time equals one typical launch overhead), spanning
    overhead- to compute-dominated probes; ``probe_bytes`` are the two
    payload sizes differenced by the link fit (default: sized to the
    slowest probed link at ~10x its latency).
    """
    nd = base.n
    N = int(chain_len)
    if N < 3 or N % 2:
        raise ValueError("chain_len must be even and >= 4")
    o_typ = float(np.median(base.exec_overhead_vec))
    r_typ = float(np.median(base.flops_per_sec))
    all_on = np.empty((nd, N + 1), dtype=np.int64)
    for d in range(nd):
        all_on[d, :] = d

    # ---- device probes: T(d, probe) = N*o_d + (N*f_probe)/r_d
    flops_list = [max(p * o_typ * r_typ, 1.0) for p in flops_probes]
    design = np.array([[N, N * f] for f in flops_list])        # (P, 2)
    T_dev = np.empty((len(flops_list), nd))
    n_meas = 0
    dev_graphs = []
    for pi, f in enumerate(flops_list):
        g = probe_chain(N, f, nbytes=1024.0, name=f"probe_dev_{pi}")
        dev_graphs.append(g)
        T_dev[pi] = np.asarray(measure(g, all_on), dtype=float)
        n_meas += nd
    # per-device least squares: design @ [o_d, 1/r_d] = T[:, d]
    sol, *_ = np.linalg.lstsq(design, T_dev, rcond=None)       # (2, nd)
    overhead = np.maximum(sol[0], 0.0)
    inv_rate = np.maximum(sol[1], 1e-18)
    flops_per_sec = 1.0 / inv_rate
    pred_dev = design @ np.vstack([overhead, inv_rate])
    res = {"device": _rel_rms(pred_dev.ravel(), T_dev.ravel())}

    # ---- link probes: alternating chains, two byte sizes, differenced
    link_bw = np.asarray(base.link_bw, dtype=float).copy()
    if fit_links and nd > 1:
        if probe_bytes is None:
            bw_floor = np.min(base.link_bw[~np.eye(nd, dtype=bool)])
            lat_typ = float(np.median(
                base.link_latency[~np.eye(nd, dtype=bool)]))
            b1 = max(10.0 * lat_typ * bw_floor, 4096.0)
            probe_bytes = (b1, 4.0 * b1)
        b_lo, b_hi = probe_bytes
        if b_hi <= b_lo:
            raise ValueError("probe_bytes must be increasing")
        pairs = [(i, j) for i in range(nd) for j in range(i + 1, nd)]
        # (2 phases per pair) x (2 byte sizes), each byte size one batch
        n1, n2 = (N - 1 + 1) // 2, (N - 1) // 2       # ceil, floor — n1>n2
        assigns = np.empty((2 * len(pairs), N + 1), dtype=np.int64)
        for pi, (i, j) in enumerate(pairs):
            # vertex 0 is the input (resident everywhere; its slot is
            # irrelevant) — the phase is defined by the FIRST COMPUTE
            # vertex (index 1), so odd indices carry the phase device
            alt_i = [i if k % 2 == 1 else j for k in range(N + 1)]
            alt_j = [j if k % 2 == 1 else i for k in range(N + 1)]
            assigns[2 * pi] = alt_i
            assigns[2 * pi + 1] = alt_j
        T_link = {}
        for b in (b_lo, b_hi):
            g = probe_chain(N, flops_list[0], nbytes=b,
                            name=f"probe_link_{int(b)}")
            T_link[b] = np.asarray(measure(g, assigns), dtype=float)
            n_meas += len(assigns)
        dT = T_link[b_hi] - T_link[b_lo]              # exec+latency cancel
        db = b_hi - b_lo
        M = np.array([[n1, n2], [n2, n1]], dtype=float) * db
        Minv = np.linalg.inv(M)
        link_res = []
        for pi, (i, j) in enumerate(pairs):
            rows = slice(2 * pi, 2 * pi + 2)
            rhs = dT[rows]
            inv_bw = Minv @ rhs                       # [1/bw_ij, 1/bw_ji]
            inv_bw = np.maximum(inv_bw, 1e-18)        # free links -> huge bw
            link_bw[i, j] = 1.0 / inv_bw[0]
            link_bw[j, i] = 1.0 / inv_bw[1]
            # residual relative to the measured makespans (the differenced
            # rhs is ~0 on hosts whose inter-device copies are free, which
            # would make an rhs-relative residual meaningless)
            link_res.append(np.sqrt(np.mean(
                ((M @ inv_bw - rhs) / np.maximum(T_link[b_hi][rows],
                                                 1e-30)) ** 2)))
        np.fill_diagonal(link_bw, np.inf)
        res["link"] = float(np.sqrt(np.mean(np.square(link_res))))

    fleet = dataclasses.replace(
        base, flops_per_sec=flops_per_sec, exec_overhead=overhead,
        link_bw=link_bw, link_latency=np.asarray(base.link_latency).copy(),
        name=name or f"{base.name}_calibrated")

    # ---- closed-loop residual: the calibrated twin re-predicts the
    # device probes through the actual WC simulator
    from .simulator import WCSimulator
    preds, meas = [], []
    for pi, g in enumerate(dev_graphs):
        sim = WCSimulator(g, fleet, choose="fifo", noise_sigma=0.0)
        preds.append(sim.run_batch(all_on)[:, 0])
        meas.append(T_dev[pi])
    res["overall"] = _rel_rms(np.concatenate(preds), np.concatenate(meas))

    return CalibrationResult(fleet=fleet, exec_overhead=overhead,
                             flops_per_sec=flops_per_sec, link_bw=link_bw,
                             residuals=res, n_measurements=n_meas)


# ---------------------------------------------------------------------------
# Measurement oracles
# ---------------------------------------------------------------------------
def executor_measure(n_devices: int, *, repeats: int = 3,
                     flops_scale: float = 1.0, bytes_scale: float = 1.0,
                     devices=None) -> MeasureFn:
    """Measure probes on the real plan-compiled executor: one
    `execute_batch` per probe family, median over interleaved repeats.
    ``devices``: the executor's (default: the card; one CUDA stream per
    logical device)."""
    from .executor import WCExecutor

    def measure(graph: DataflowGraph, assignments: np.ndarray) -> np.ndarray:
        ex = WCExecutor(graph, devices=devices, flops_scale=flops_scale,
                        bytes_scale=bytes_scale, n_virtual=n_devices)
        ts = ex.execute_batch(assignments, repeats=repeats)
        return np.median(ts, axis=1)

    return measure


def simulator_measure(truth: DeviceModel, *, noise_sigma: float = 0.0,
                      repeats: int = 5, choose: str = "fifo") -> MeasureFn:
    """Ground-truth measurement oracle for tests/benchmarks: the WC
    simulator over a (possibly hidden) `truth` fleet, median over seeds
    when noisy."""
    from .simulator import WCSimulator

    def measure(graph: DataflowGraph, assignments: np.ndarray) -> np.ndarray:
        sim = WCSimulator(graph, truth, choose=choose,
                          noise_sigma=noise_sigma)
        if noise_sigma <= 0:
            return sim.run_batch(assignments)[:, 0]
        ts = sim.run_batch(assignments, seeds=list(range(repeats)))
        return np.median(ts, axis=1)

    return measure
