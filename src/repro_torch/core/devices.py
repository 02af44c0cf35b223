"""Copy of ``src/repro/core/devices.py`` (the port imports nothing of ``repro``).

Hardware device models for the WC engine (simulator + real executor).

The paper's engine ran on P100/V100 NVLink boxes; per DESIGN.md §3 the
device model is parameterized so the same DOPPLER machinery targets TPU
pods: a TPU v5e preset models ICI neighbor links on a 2D torus with
hop-count latency (the TPU-idiomatic equivalent of NVLink P2P).

Heterogeneous fleets: every per-device quantity (compute rate, kernel
launch overhead, memory capacity) may vary per device, and the link
matrices may be asymmetric (bw[i, j] != bw[j, i] — e.g. an oversubscribed
DCN return path between pods).  Both WC engines (the serial reference
loop and the compiled batch engine) read costs through the same
expressions, so non-uniform fleets stay bit-identical across engines.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DeviceModel:
    """n devices with per-device compute rate and pairwise link model.

    Attributes:
      flops_per_sec: (n,) effective FLOP/s per device.
      link_bw: (n, n) bytes/sec for a direct transfer d1->d2 (0 diag);
        may be asymmetric.
      link_latency: (n, n) seconds of fixed setup per transfer.
      exec_overhead: per-kernel launch overhead (seconds) — a scalar, or
        an (n,) array for fleets with per-device launch costs.
      mem_bytes: optional (n,) per-device memory capacity; None = ignore
        memory (the homogeneous-preset default).
      name: preset name.
    """
    flops_per_sec: np.ndarray
    link_bw: np.ndarray
    link_latency: np.ndarray
    exec_overhead: float | np.ndarray = 5e-6
    name: str = "custom"
    mem_bytes: np.ndarray | None = None

    def __post_init__(self):
        self.flops_per_sec = np.asarray(self.flops_per_sec, dtype=np.float64)
        self.link_bw = np.asarray(self.link_bw, dtype=np.float64)
        self.link_latency = np.asarray(self.link_latency, dtype=np.float64)
        if np.ndim(self.exec_overhead):
            self.exec_overhead = np.asarray(self.exec_overhead,
                                            dtype=np.float64)
        else:
            self.exec_overhead = float(self.exec_overhead)
        if self.mem_bytes is not None:
            self.mem_bytes = np.asarray(self.mem_bytes, dtype=np.float64)

    @property
    def n(self) -> int:
        return len(self.flops_per_sec)

    @property
    def exec_overhead_vec(self) -> np.ndarray:
        """(n,) launch overhead — scalar overheads broadcast."""
        if np.ndim(self.exec_overhead):
            return self.exec_overhead
        return np.full(self.n, self.exec_overhead)

    @property
    def heterogeneous(self) -> bool:
        """True when any per-device rate/overhead differs or any link pair
        is asymmetric."""
        return bool(
            np.ptp(self.flops_per_sec) > 0
            or np.ptp(self.exec_overhead_vec) > 0
            or not np.array_equal(self.link_bw, self.link_bw.T)
            or not np.array_equal(self.link_latency, self.link_latency.T))

    def exec_time(self, flops: float, device: int) -> float:
        ov = (self.exec_overhead[device] if np.ndim(self.exec_overhead)
              else self.exec_overhead)
        return ov + flops / self.flops_per_sec[device]

    def transfer_time(self, nbytes: float, src: int, dst: int) -> float:
        if src == dst:
            return 0.0
        return self.link_latency[src, dst] + nbytes / self.link_bw[src, dst]

    def transfer_time_matrix(self, nbytes: float) -> np.ndarray:
        """(n, n) transfer seconds for `nbytes` between each pair."""
        with np.errstate(divide="ignore"):
            t = self.link_latency + nbytes / self.link_bw
        np.fill_diagonal(t, 0.0)
        return t

    def replace(self, **kw) -> "DeviceModel":
        """Copy with fields replaced — how calibration (core/calibrate.py)
        and fleet perturbations derive fitted/what-if fleets."""
        return dataclasses.replace(self, **kw)

    def fingerprint(self) -> str:
        """Stable content hash of the hardware model — with
        ``graph.topo_hash`` it keys the serving cache: same graph
        structure + same fleet means a cached placement replays."""
        import hashlib
        h = hashlib.sha256()
        mem = self.mem_bytes if self.mem_bytes is not None else np.zeros(0)
        for arr in (self.flops_per_sec, self.link_bw, self.link_latency,
                    self.exec_overhead_vec, mem):
            a = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def memory_ok(self, bytes_per_device: np.ndarray) -> bool:
        """Does a per-device residency profile fit?  Always True when the
        fleet has no modeled capacity."""
        if self.mem_bytes is None:
            return True
        return bool((np.asarray(bytes_per_device) <= self.mem_bytes).all())


def p100_box(n: int = 4) -> DeviceModel:
    """4x Tesla P100 (paper's main testbed): ~9.5 TF fp32 effective ~4.7,
    full NVLink mesh ~40 GB/s per direction per pair."""
    flops = np.full(n, 4.7e12)
    bw = np.full((n, n), 40e9)
    np.fill_diagonal(bw, np.inf)
    lat = np.full((n, n), 10e-6)
    np.fill_diagonal(lat, 0.0)
    return DeviceModel(flops, bw, lat, name=f"p100x{n}")


def v100_two_groups(n: int = 8) -> DeviceModel:
    """8x V100 in two NVLink-full groups of 4 (paper App. H.2/J):
    intra-group ~100 GB/s; across groups only 4 links shared -> ~25 GB/s."""
    assert n == 8
    flops = np.full(n, 14e12)
    bw = np.empty((n, n))
    for i in range(n):
        for j in range(n):
            same = (i // 4) == (j // 4)
            bw[i, j] = 100e9 if same else 25e9
    np.fill_diagonal(bw, np.inf)
    lat = np.where(np.equal.outer(np.arange(n) // 4, np.arange(n) // 4),
                   8e-6, 20e-6).astype(float)
    np.fill_diagonal(lat, 0.0)
    return DeviceModel(flops, bw, lat, name="v100x8_2groups")


def tpu_v5e_slice(rows: int = 2, cols: int = 2,
                  bf16_flops: float = 197e12,
                  link_bw_per_dir: float = 50e9) -> DeviceModel:
    """TPU v5e 2D-torus slice. P2P bandwidth between chips is modeled as the
    single-link ICI rate; latency grows with torus hop count (Manhattan
    distance with wraparound). This is the DESIGN.md §3 TPU adaptation of
    the paper's NVLink topology model."""
    n = rows * cols
    flops = np.full(n, bf16_flops)
    bw = np.full((n, n), link_bw_per_dir)
    np.fill_diagonal(bw, np.inf)
    lat = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            ri, ci, rj, cj = i // cols, i % cols, j // cols, j % cols
            dr = min(abs(ri - rj), rows - abs(ri - rj))
            dc = min(abs(ci - cj), cols - abs(ci - cj))
            hops = max(1, dr + dc)
            lat[i, j] = 1e-6 * hops
    return DeviceModel(flops, bw, lat, name=f"tpu_v5e_{rows}x{cols}")


def uniform_box(n: int, flops: float = 1e12, bw: float = 50e9,
                latency: float = 5e-6) -> DeviceModel:
    """Homogeneous fully-connected box — handy for tests."""
    f = np.full(n, flops)
    b = np.full((n, n), bw)
    np.fill_diagonal(b, np.inf)
    l = np.full((n, n), latency)
    np.fill_diagonal(l, 0.0)
    return DeviceModel(f, b, l, name=f"uniform{n}")


# ------------------------------------------------------ heterogeneous fleets
def scale_fleet(base: DeviceModel, speed=None, mem=None,
                name: str | None = None) -> DeviceModel:
    """Per-device speed/memory multipliers applied to an existing fleet.

    speed: scalar or (n,) multipliers on flops_per_sec.
    mem:   scalar or (n,) multipliers on mem_bytes (requires the base to
           model memory, or pass absolute bytes via `DeviceModel` directly).
    """
    flops = base.flops_per_sec * (np.ones(base.n) if speed is None
                                  else np.asarray(speed, dtype=np.float64))
    mem_bytes = base.mem_bytes
    if mem is not None:
        if mem_bytes is None:
            raise ValueError(f"{base.name}: no mem_bytes to scale")
        mem_bytes = mem_bytes * np.asarray(mem, dtype=np.float64)
    elif mem_bytes is not None:
        mem_bytes = mem_bytes.copy()
    overhead = (base.exec_overhead.copy()
                if isinstance(base.exec_overhead, np.ndarray)
                else base.exec_overhead)
    return DeviceModel(flops, base.link_bw.copy(), base.link_latency.copy(),
                       exec_overhead=overhead,
                       mem_bytes=mem_bytes,
                       name=name or f"{base.name}_scaled")


def mixed_generation_box(n_fast: int = 2, n_slow: int = 2) -> DeviceModel:
    """Mixed-generation GPU box: `n_fast` V100-class (14 TF, 32 GB,
    NVLink'd together at ~100 GB/s) + `n_slow` P100-class (4.7 TF, 16 GB,
    NVLink'd at ~40 GB/s).  Cross-generation transfers go over PCIe and
    are asymmetric: 12 GB/s fast->slow vs 10 GB/s slow->fast (the older
    cards' read path is slower)."""
    n = n_fast + n_slow
    fast = np.arange(n) < n_fast
    flops = np.where(fast, 14e12, 4.7e12)
    mem = np.where(fast, 32e9, 16e9)
    bw = np.empty((n, n))
    lat = np.empty((n, n))
    for i in range(n):
        for j in range(n):
            if fast[i] and fast[j]:
                bw[i, j], lat[i, j] = 100e9, 8e-6
            elif not fast[i] and not fast[j]:
                bw[i, j], lat[i, j] = 40e9, 10e-6
            elif fast[i]:                       # fast -> slow
                bw[i, j], lat[i, j] = 12e9, 15e-6
            else:                               # slow -> fast
                bw[i, j], lat[i, j] = 10e9, 15e-6
    np.fill_diagonal(bw, np.inf)
    np.fill_diagonal(lat, 0.0)
    overhead = np.where(fast, 4e-6, 6e-6)       # older launch path is slower
    return DeviceModel(flops, bw, lat, exec_overhead=overhead,
                       mem_bytes=mem, name=f"mixed_v100x{n_fast}_p100x{n_slow}")


def two_pod_fleet(rows: int = 2, cols: int = 2,
                  dcn_bw_out: float = 6.25e9, dcn_bw_back: float = 5.0e9,
                  dcn_latency: float = 25e-6) -> DeviceModel:
    """Two TPU v5e pods (each a rows x cols torus) joined by DCN.

    Intra-pod links are the ICI model of :func:`tpu_v5e_slice`; inter-pod
    transfers cross the data-center network, with an asymmetric return
    path (`dcn_bw_back` < `dcn_bw_out`, modeling an oversubscribed
    pod-1 -> pod-0 direction)."""
    pod = tpu_v5e_slice(rows, cols)
    k = pod.n
    n = 2 * k
    flops = np.concatenate([pod.flops_per_sec, pod.flops_per_sec])
    bw = np.empty((n, n))
    lat = np.empty((n, n))
    bw[:k, :k] = bw[k:, k:] = pod.link_bw
    lat[:k, :k] = lat[k:, k:] = pod.link_latency
    bw[:k, k:] = dcn_bw_out
    bw[k:, :k] = dcn_bw_back
    lat[:k, k:] = lat[k:, :k] = dcn_latency
    np.fill_diagonal(bw, np.inf)
    np.fill_diagonal(lat, 0.0)
    return DeviceModel(flops, bw, lat, exec_overhead=pod.exec_overhead,
                       mem_bytes=np.full(n, 16e9),
                       name=f"two_pod_v5e_{rows}x{cols}")


def straggler_box(n: int = 8, straggler: int = 0,
                  slowdown: float = 0.5,
                  mem_bytes: float = 16e9) -> DeviceModel:
    """Uniform box with one device running at `slowdown` x the fleet rate —
    the classic mixed-bin / thermally-throttled straggler scenario.

    Capacity is routed through the constructor (NOT patched onto the
    instance afterwards) so ``__post_init__`` normalization applies and
    ``fingerprint()`` covers it from the first call — derived fleets
    (``FleetEvent.apply``, ``scale_fleet``) see a stable, capacity-aware
    hash."""
    base = uniform_box(n)
    speed = np.ones(n)
    speed[straggler] = slowdown
    return DeviceModel(base.flops_per_sec * speed, base.link_bw,
                       base.link_latency, exec_overhead=base.exec_overhead,
                       mem_bytes=np.full(n, float(mem_bytes)),
                       name=f"straggler{n}")


PRESETS = {
    "p100x4": lambda: p100_box(4),
    "v100x8": v100_two_groups,
    "tpu_v5e_2x2": lambda: tpu_v5e_slice(2, 2),
    "tpu_v5e_4x4": lambda: tpu_v5e_slice(4, 4),
    "tpu_v5e_16x16": lambda: tpu_v5e_slice(16, 16),
    # heterogeneous fleets (per-device speed/memory, asymmetric links)
    "mixed_gen4": lambda: mixed_generation_box(2, 2),
    "mixed_gen6": lambda: mixed_generation_box(4, 2),
    "two_pod_2x2": lambda: two_pod_fleet(2, 2),
    "straggler8": lambda: straggler_box(8),
}

# The heterogeneous subset — what benchmarks/zoo_sweep.py sweeps over.
HETERO_FLEETS = ("mixed_gen4", "two_pod_2x2", "straggler8")


def get_device_model(name: str) -> DeviceModel:
    if name not in PRESETS:
        raise KeyError(f"unknown device preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


# ------------------------------------------------------------- fleet events
EVENT_KINDS = ("device_loss", "straggler_onset", "straggler_recovery",
               "link_degradation")


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One fleet-churn event: applying it to a :class:`DeviceModel` yields
    the derived (degraded/recovered) fleet plus a survivor map.

    kind:    'device_loss'        — device ``device`` disappears; the fleet
                                    shrinks by one and every other device
                                    is re-indexed.
             'straggler_onset'    — ``device`` slows to ``factor`` x its
                                    compute rate (thermal throttle, noisy
                                    neighbor, failing HBM ...).
             'straggler_recovery' — the inverse: ``device`` speeds back up
                                    by ``1/factor`` (same ``factor`` as the
                                    onset restores the original rate).
             'link_degradation'   — the ``device -> dst`` link bandwidth
                                    drops to ``factor`` x; ``dst=-1``
                                    degrades every link touching
                                    ``device`` (both directions) — a
                                    flapping NIC / oversubscribed switch.
    device:  the affected device index (source side for link events).
    dst:     link destination for 'link_degradation' (-1 = all links of
             ``device``); ignored otherwise.
    factor:  multiplier (< 1 degrades).

    ``apply`` always constructs the derived fleet through the
    ``DeviceModel`` constructor (never by mutating arrays on a live
    instance), so ``__post_init__`` invariants hold and ``fingerprint()``
    of the derived fleet is stable and distinct from the base fleet's —
    the (topo_hash, fingerprint) serving-cache key stays correct across
    fleet churn.
    """
    kind: str
    device: int = 0
    dst: int = -1
    factor: float = 0.5

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown fleet-event kind {self.kind!r}; "
                             f"have {EVENT_KINDS}")
        if not (self.factor > 0):
            raise ValueError(f"factor must be positive, got {self.factor}")

    def apply(self, fleet: DeviceModel) -> tuple[DeviceModel, np.ndarray]:
        """-> (derived fleet, survivor map).

        The survivor map is ``(fleet.n,)`` int64: old device index -> new
        device index, with ``-1`` marking a lost device.  Non-loss events
        return the identity map."""
        n = fleet.n
        if not (0 <= self.device < n):
            raise ValueError(f"event device {self.device} out of range for "
                             f"{fleet.name} (n={n})")
        smap = np.arange(n, dtype=np.int64)
        if self.kind == "device_loss":
            if n <= 1:
                raise ValueError("cannot lose the last device")
            keep = np.arange(n) != self.device
            smap = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int64)
            mem = (fleet.mem_bytes[keep]
                   if fleet.mem_bytes is not None else None)
            ov = (fleet.exec_overhead[keep]
                  if isinstance(fleet.exec_overhead, np.ndarray)
                  else fleet.exec_overhead)
            out = DeviceModel(fleet.flops_per_sec[keep],
                              fleet.link_bw[np.ix_(keep, keep)],
                              fleet.link_latency[np.ix_(keep, keep)],
                              exec_overhead=ov, mem_bytes=mem,
                              name=f"{fleet.name}-loss{self.device}")
            return out, smap
        if self.kind in ("straggler_onset", "straggler_recovery"):
            mult = (self.factor if self.kind == "straggler_onset"
                    else 1.0 / self.factor)
            flops = fleet.flops_per_sec.copy()
            flops[self.device] *= mult
            suffix = ("slow" if self.kind == "straggler_onset" else "rec")
            return fleet.replace(
                flops_per_sec=flops,
                name=f"{fleet.name}-{suffix}{self.device}"), smap
        # link_degradation
        bw = fleet.link_bw.copy()
        if self.dst < 0:
            bw[self.device, :] *= self.factor
            bw[:, self.device] *= self.factor
        else:
            if not (0 <= self.dst < n):
                raise ValueError(f"event dst {self.dst} out of range for "
                                 f"{fleet.name} (n={n})")
            bw[self.device, self.dst] *= self.factor
        np.fill_diagonal(bw, np.inf)
        return fleet.replace(
            link_bw=bw, name=f"{fleet.name}-link{self.device}"), smap

    # ------------------------------------------------------ constructors
    @classmethod
    def device_loss(cls, device: int) -> "FleetEvent":
        return cls("device_loss", device=device)

    @classmethod
    def straggler_onset(cls, device: int, factor: float = 0.5) -> "FleetEvent":
        return cls("straggler_onset", device=device, factor=factor)

    @classmethod
    def straggler_recovery(cls, device: int,
                           factor: float = 0.5) -> "FleetEvent":
        return cls("straggler_recovery", device=device, factor=factor)

    @classmethod
    def link_degradation(cls, device: int, dst: int = -1,
                         factor: float = 0.25) -> "FleetEvent":
        return cls("link_degradation", device=device, dst=dst, factor=factor)


def parse_event(spec: str) -> FleetEvent:
    """'kind:device[:factor[:dst]]' -> :class:`FleetEvent`.

    Examples: ``device_loss:2``, ``straggler_onset:1:0.4``,
    ``link_degradation:0:0.25:3`` (dst 3), ``link_degradation:0:0.25``
    (all links of device 0).  ``straggler:d[:f]`` is accepted as an
    alias for ``straggler_onset``."""
    parts = spec.strip().split(":")
    kind = {"straggler": "straggler_onset",
            "loss": "device_loss",
            "link": "link_degradation"}.get(parts[0], parts[0])
    if len(parts) < 2:
        raise ValueError(f"event spec {spec!r} needs 'kind:device'")
    device = int(parts[1])
    kw = {}
    if len(parts) > 2:
        kw["factor"] = float(parts[2])
    if len(parts) > 3:
        kw["dst"] = int(parts[3])
    return FleetEvent(kind, device=device, **kw)
