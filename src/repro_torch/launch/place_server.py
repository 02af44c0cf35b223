"""Zero-shot placement serving (counterpart of
``repro/launch/place_server.py``): a pretrained cross-graph dual policy
behind a fingerprint-keyed LRU cache, on one device.

``training.pretrain`` learns ONE dual-policy parameter set across graph x
fleet tasks; a :class:`PlacementServer` answers "place this graph on this
fleet" requests with it:

* **cache hit**: the (graph topo-hash, fleet fingerprint) pair was served
  before; the stored placement is returned.  ``topo_hash`` ignores
  labels, so a relabeled graph is the same key.
* **cache miss**: a zero-shot greedy rollout of the policy on the
  server's device (``core.zero_shot.greedy_place``: one encode, two
  ``gnn_mp`` pair launches at two GNN layers) plus ``cp_seeds``
  CRITICAL-PATH candidates, scored by the noise-free numpy
  ``WCSimulator``'s batched engine as the reference scores them; the best
  is served.  CP is in the pool, so the served makespan is <= CP's.
* **fine-tune** (optional): with a positive ``fine_tune_budget_s`` the
  miss also warm-starts a :class:`DopplerTrainer` on the server's device
  from the pretrained params and runs batched REINFORCE updates until the
  budget is spent, serving the best assignment seen anywhere.

    PYTHONPATH=src python -m repro_torch.launch.place_server \\
        --workload model:olmo_1b --fleet mixed_gen4 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from ..core.device import resolve_device, sync
from ..core.devices import DeviceModel, get_device_model
from ..core.features import COMM_FACTOR_DEFAULT
from ..core.graph import DataflowGraph, topo_hash
from ..core.heuristics import critical_path_assignment
from ..core.simulator import WCSimulator
from ..core.zero_shot import greedy_place
from ..models.convert import params_from_numpy


@dataclasses.dataclass
class PlaceRequest:
    graph: DataflowGraph
    dev: DeviceModel
    fine_tune_budget_s: float = 0.0


@dataclasses.dataclass
class PlaceResult:
    assignment: np.ndarray
    makespan: float          # noise-free WC-sim makespan (seconds)
    source: str              # 'policy' | 'cp' | 'fine_tuned'
    cache_hit: bool
    latency_s: float         # server-side wall clock for this request
    # a miss's wall seconds by phase (greedy, cp, scoring, fine_tune);
    # empty on a hit
    seconds: dict = dataclasses.field(default_factory=dict)
    fine_tune_updates: int = 0


class PlacementServer:
    """Batch placement API over one pretrained parameter set.

    ``params`` is a ``training.pretrain()["params"]`` tree, torch or numpy
    leaves (a reference result through ``zero_shot.to_numpy_params``),
    moved once to ``device`` as float32.  ``meta`` is the matching
    ``["meta"]``; only fine-tuning needs it (the trainer rebuilds the
    policy's widths)."""

    def __init__(self, params, meta: dict | None = None,
                 cache_size: int = 256,
                 comm_factor: float = COMM_FACTOR_DEFAULT,
                 cp_seeds: int = 2, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = params_from_numpy(params, self.device, torch.float32)
        self.meta = dict(meta or {})
        self.comm_factor = comm_factor
        self.cp_seeds = cp_seeds
        self.cache_size = cache_size
        self._cache: collections.OrderedDict[tuple, PlaceResult] = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @classmethod
    def from_checkpoint(cls, ckpt_dir, device: str | torch.device = "cuda",
                        **kwargs) -> "PlacementServer":
        from ..core.policy_io import load_pretrained
        pre = load_pretrained(ckpt_dir, device=device)
        return cls(pre["params"], meta=pre["meta"], device=device, **kwargs)

    # ------------------------------------------------------------- cache
    def cache_key(self, g: DataflowGraph, dev: DeviceModel) -> tuple:
        return (topo_hash(g), dev.fingerprint())

    # ------------------------------------------------------------- serve
    def place(self, g: DataflowGraph, dev: DeviceModel,
              fine_tune_budget_s: float = 0.0) -> PlaceResult:
        t0 = time.perf_counter()
        key = self.cache_key(g, dev)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return dataclasses.replace(
                hit, cache_hit=True, latency_s=time.perf_counter() - t0,
                seconds={})
        self.misses += 1

        # candidate pool: the zero-shot greedy rollout + CP seeds (CP in
        # the pool makes "served <= CP" structural)
        cands = [greedy_place(self.params, g, dev, self.comm_factor,
                              self.device)]
        sync(self.device)
        t1 = time.perf_counter()
        sources = ["policy"]
        for s in range(self.cp_seeds):
            cands.append(critical_path_assignment(g, dev, seed=s))
            sources.append("cp")
        t2 = time.perf_counter()
        sim = WCSimulator(g, dev, choose="fifo", noise_sigma=0.0)
        ms = sim.run_batch(np.stack(cands), engine="batched")[:, 0]
        best = int(np.argmin(ms))
        t3 = time.perf_counter()
        res = PlaceResult(assignment=np.asarray(cands[best]),
                          makespan=float(ms[best]), source=sources[best],
                          cache_hit=False, latency_s=0.0,
                          seconds={"greedy": t1 - t0, "cp": t2 - t1,
                                   "scoring": t3 - t2})
        if fine_tune_budget_s > 0.0:
            res = self._fine_tune(g, dev, sim, res, fine_tune_budget_s)
            res.seconds["fine_tune"] = time.perf_counter() - t3

        self._cache[key] = res
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return dataclasses.replace(res, latency_s=time.perf_counter() - t0)

    def place_batch(self, requests) -> list[PlaceResult]:
        """Serve a batch of :class:`PlaceRequest` (or (graph, dev)
        tuples).  Requests are independent; duplicates within the batch
        hit the cache populated by their first occurrence."""
        out = []
        for r in requests:
            if not isinstance(r, PlaceRequest):
                r = PlaceRequest(*r)
            out.append(self.place(r.graph, r.dev, r.fine_tune_budget_s))
        return out

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "cached": len(self._cache)}

    # --------------------------------------------------------- fine-tune
    def _fine_tune(self, g, dev, sim, seed_res: PlaceResult,
                   budget_s: float) -> PlaceResult:
        """Few-update Stage II under a wall-clock budget on the server's
        device, warm-started from the pretrained params (the reference's
        hyper-parameters: K 8, lr 3e-3 -> 1e-5 over 512 episodes); the
        updates run until the budget is spent (``fine_tune_updates``)."""
        from ..core.engine import SimRewardEngine
        from ..core.training import DopplerTrainer
        t0 = time.perf_counter()
        batch = 8
        tr = DopplerTrainer(
            g, dev, seed=0,
            d_hidden=int(self.meta.get("d_hidden", 64)),
            gnn_layers=int(self.meta.get("gnn_layers", 2)),
            lr0=3e-3, lr1=1e-5, total_episodes=max(batch * 64, 1),
            comm_factor=self.comm_factor, device=self.device)
        tr.params = self.params
        eng = SimRewardEngine(sim, sim_engine="batched")
        updates = 0
        while time.perf_counter() - t0 < budget_s:
            tr._batched_rl_update(eng, batch, "serve_ft")
            updates += 1
        res = dataclasses.replace(seed_res, seconds=dict(seed_res.seconds),
                                  fine_tune_updates=updates)
        if tr.best_time < seed_res.makespan:
            return dataclasses.replace(
                res, assignment=np.asarray(tr.best_assignment),
                makespan=float(tr.best_time), source="fine_tuned")
        return res


# ----------------------------------------------------------------- CLI
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=None,
                    help="pretrained checkpoint dir (policy_io."
                         "save_pretrained); omitted = a quick in-process "
                         "pretrain on a reduced zoo (gemma_2b and "
                         "phi4_mini_3p8b layers, one synthetic graph)")
    ap.add_argument("--workload", default="model:olmo_1b",
                    help="chainmm|ffnn|llama_block|llama_layer|"
                         "model:<arch>[:full]")
    ap.add_argument("--fleet", default="mixed_gen4")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--fine-tune-budget", type=float, default=0.0)
    ap.add_argument("--repeat", type=int, default=2,
                    help="repeat the request to demonstrate the cache")
    ap.add_argument("--device", default="cuda",
                    help="torch device the policy runs on (cuda or cpu)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..graphs.workloads import get_workload
    if args.ckpt:
        server = PlacementServer.from_checkpoint(args.ckpt,
                                                 device=args.device)
    else:
        from ..core.training import pretrain, zoo_pretrain_tasks
        tasks = zoo_pretrain_tasks(archs=("gemma_2b", "phi4_mini_3p8b"),
                                   seq=16, n_synthetic=1)
        pre = pretrain(tasks, rounds=1, batch_size=4, imitation_episodes=1,
                       device=args.device)
        server = PlacementServer(pre["params"], meta=pre["meta"],
                                 device=args.device)

    kwargs = {"seq": args.seq} if args.workload.startswith("model:") else {}
    g = get_workload(args.workload, **kwargs)
    dev = get_device_model(args.fleet)
    for i in range(max(args.repeat, 1)):
        r = server.place(g, dev, fine_tune_budget_s=args.fine_tune_budget)
        print(f"[{i}] {args.workload} on {args.fleet}: "
              f"makespan={r.makespan*1e3:.2f}ms source={r.source} "
              f"cache_hit={r.cache_hit} latency={r.latency_s*1e3:.1f}ms")
    print(f"server stats: {server.stats()}")


if __name__ == "__main__":
    main()
