"""The model zoo of the port (``graphs/model_zoo.py``, ``graphs/
workloads.py``) against the reference's live import (never
``tests/goldens/``), on the same configs:

* parity of every registry config's layer (``model:<arch>``) and
  training-step unit (``train_step_spec``) at seq 64 (seq 256:
  ``test_torch_zoo_parity.py``).  Exact: the input vertices' labels,
  shapes and bytes (by label), the number of outputs, the matmul flops
  (and, for the dense configs, their closed form).  Within 0.5%: total
  flops and the critical-path bound on ``v100x8`` and ``mixed_gen4``.
  Within 15%: vertex and edge counts after fusion and the non-input bytes.
  The per-kind table is printed (``python tests/test_torch_model_zoo.py
  [seq]`` prints it for every config);
* the reference's zoo tests on the port (``tests/test_model_zoo.py``):
  the registry round trip and aliases, the parameter labels, the fleet
  checks on imported graphs, the byte-budgeted cache; and its hierarchy
  tests of ``model:olmo_1b:full`` (``tests/test_hierarchy.py``);
* both packages' WC oracles refuse the same over-bound graph.
"""
import collections
import functools
import sys

import numpy as np
import pytest

from repro.configs.registry import ARCH_IDS
from repro.core.devices import get_device_model as jax_fleet
from repro.core.graph import DataflowGraph as JaxGraph
from repro.core.sim_jax import SimGraph as JaxSimGraph
from repro.graphs import model_zoo as jax_zoo
from repro.graphs.jaxpr_import import jaxpr_to_graph
from repro.graphs.workloads import list_workloads as jax_list_workloads
from repro_torch.configs.registry import get_config
from repro_torch.core.devices import (HETERO_FLEETS, DeviceModel,
                                      get_device_model, mixed_generation_box)
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.heuristics import (critical_path_assignment,
                                         random_assignment,
                                         round_robin_assignment)
from repro_torch.core.sim_torch import SimGraph
from repro_torch.core.simulator import WCSimulator
from repro_torch.graphs import model_zoo
from repro_torch.graphs.fx_import import fx_to_graph
from repro_torch.graphs.partition import coarsen
from repro_torch.graphs.workloads import get_workload, list_workloads

SEQ = 64
FLEETS = ("v100x8", "mixed_gen4")
DENSE = ("gemma_2b", "phi4_mini_3p8b", "olmo_1b", "qwen1p5_110b",
         "musicgen_large", "paligemma_3b")


# ---------------------------------------------------------------- parity
@functools.lru_cache(maxsize=None)
def graphs(arch: str, which: str, seq: int):
    """(port, reference) graphs of one config: the layer or the unit."""
    if which == "layer":
        return (model_zoo.import_model(arch, seq=seq),
                jax_zoo.import_model(arch, seq=seq))
    fn, args, labels = model_zoo.train_step_spec(get_config(arch), seq=seq)
    port = fx_to_graph(fn, *args, name=f"model:{arch}:unit",
                       arg_labels=labels)
    fn, args, labels = jax_zoo.train_step_spec(jax_zoo.get_config(arch),
                                               seq=seq)
    return port, jaxpr_to_graph(fn, *args, name=f"model:{arch}:unit",
                                arg_labels=labels)


def matmul_flops(g) -> float:
    fl = g.flops_array()
    return float(sum(f for f, v in zip(fl, g.vertices)
                     if v.kind == "matmul"))


def closed_form(cfg, seq: int) -> float:
    """Matmul flops of one dense layer: the projections and the FFN, and
    the scores and values of causal attention computed in full (past 512
    positions they sit in the loop over query chunks, a ``scan``)."""
    d, n_ffn = cfg.d_model, 3 if cfg.act in ("swiglu", "geglu") else 2
    proj = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    attn = 4.0 * cfg.n_heads * seq * seq * cfg.head_dim if seq <= 512 else 0
    return 2.0 * seq * (proj + n_ffn * d * cfg.d_ff) + attn


def inputs_of(g) -> dict:
    return {v.label: (tuple(v.out_shape), v.out_bytes) for v in g.vertices
            if v.kind == "input"}


def kind_table(g) -> dict:
    """{kind: (vertices, flops)} of a graph."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for v in g.vertices:
        out[v.kind][0] += 1
        out[v.kind][1] += v.flops
    return {k: tuple(v) for k, v in sorted(out.items())}


def print_table(arch, which, seq, port, ref):
    print(f"{arch} {which} seq {seq}: n {port.n} / {ref.n}, "
          f"m {port.m} / {ref.m}")
    kp, kr = kind_table(port), kind_table(ref)
    for k in sorted(set(kp) | set(kr)):
        (np_, fp), (nr, fr) = kp.get(k, (0, 0.0)), kr.get(k, (0, 0.0))
        print(f"  {k:18s} {np_:5d} / {nr:5d}   {fp:.6e} / {fr:.6e}")


def assert_parity(arch: str, which: str, seq: int) -> None:
    port, ref = graphs(arch, which, seq)
    print_table(arch, which, seq, port, ref)
    assert inputs_of(port) == inputs_of(ref)
    assert len(port.outputs) == len(ref.outputs)
    mm = matmul_flops(port)
    assert mm == matmul_flops(ref)
    if arch in DENSE:
        assert mm == closed_form(get_config(arch), seq) * (
            1 if which == "layer" else 3)
    assert port.total_flops() == pytest.approx(ref.total_flops(), rel=5e-3)
    for fleet in FLEETS:
        rate = get_device_model(fleet).flops_per_sec
        assert port.critical_path_lower_bound(rate) == pytest.approx(
            ref.critical_path_lower_bound(jax_fleet(fleet).flops_per_sec),
            rel=5e-3)
    assert port.n == pytest.approx(ref.n, rel=0.15)
    assert port.m == pytest.approx(ref.m, rel=0.15)
    body = lambda g: float(g.out_bytes_array()[~g.input_mask()].sum())
    assert body(port) == pytest.approx(body(ref), rel=0.15)


@pytest.mark.parametrize("which", ["layer", "unit"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zoo_parity_seq64(arch, which):
    assert_parity(arch, which, SEQ)


@pytest.mark.parametrize("which", ["layer", "unit"])
def test_zoo_parity_past_one_chunk(which):
    """Past 512 positions the model's attention is the loop over query
    chunks: one ``scan`` vertex forward (and one backward), as the
    reference's."""
    assert_parity("olmo_1b", which, 1024)
    port, ref = graphs("olmo_1b", which, 1024)
    scans = lambda g: sum(v.label == "scan" for v in g.vertices)
    assert scans(port) == scans(ref) == (1 if which == "layer" else 2)


# ------------------------------------------------- the reference's tests
@pytest.fixture(scope="module")
def zoo():
    return model_zoo.import_all(seq=SEQ)


def test_all_registry_models_import_acyclic(zoo):
    assert len(zoo) == len(ARCH_IDS) >= 8
    for arch, g in zoo.items():
        assert g.name == f"model:{arch}"
        assert g.n > 20, (arch, g.n)
        assert sorted(g.topo_order) == list(range(g.n))
        assert g.total_flops() > 0
        assert all(v.label for v in g.vertices), arch
        for v in g.vertices:
            if v.kind != "input":
                assert v.flops > 0 or v.out_bytes > 0


def test_workload_registry_roundtrip(zoo):
    g = get_workload("model:gemma_2b", seq=SEQ)
    assert g.name == "model:gemma_2b"
    assert g is zoo["gemma_2b"]          # cached, frozen => shared
    assert get_workload("model:gemma-2b", seq=SEQ) is g
    assert model_zoo.canonical_arch("qwen1.5-110b") == "qwen1p5_110b"
    assert list_workloads() == jax_list_workloads()
    assert "model:gemma_2b" in list_workloads()
    assert "model:olmo_1b:full" in list_workloads()
    with pytest.raises(KeyError):
        get_workload("model:nonexistent_42b")
    with pytest.raises(KeyError):
        get_workload("nonexistent")
    with pytest.raises(TypeError):
        get_workload("model:olmo_1b", microbatches=2)


def test_param_labels_name_blocks(zoo):
    g = zoo["zamba2_1p2b"]
    labels = [v.label for v in g.vertices if v.kind == "input"]
    assert any(l.startswith("block0.mamba") for l in labels)
    assert any(l.startswith("shared_attn") for l in labels)
    assert "x" in labels and "positions" in labels
    # the reference's labels, matched by label (JAX flattens dicts in
    # sorted key order, PyTorch in insertion order)
    ref = jax_zoo.import_model("zamba2_1p2b", seq=SEQ)
    assert sorted(labels) == sorted(v.label for v in ref.vertices
                                    if v.kind == "input")


def test_per_device_overhead_serial_batched_identical(zoo):
    g = zoo["olmo_1b"]
    dev = mixed_generation_box(2, 2)     # vector exec_overhead
    assert isinstance(dev.exec_overhead, np.ndarray)
    sim = WCSimulator(g, dev, choose="fifo")
    a = critical_path_assignment(g, dev, seed=0)
    assert sim.run_batch([a], engine="serial")[0, 0] == \
        sim.run_batch([a], engine="batched")[0, 0]


def test_cp_lower_bound_below_wc_makespan_hetero(zoo):
    for arch in ("gemma_2b", "qwen3_moe_235b_a22b", "zamba2_1p2b"):
        g = zoo[arch]
        ref = jax_zoo.import_model(arch, seq=SEQ)
        for fleet in HETERO_FLEETS:
            dev = get_device_model(fleet)
            lb = g.critical_path_lower_bound(dev.flops_per_sec)
            assert lb == pytest.approx(ref.critical_path_lower_bound(
                jax_fleet(fleet).flops_per_sec), rel=5e-3)
            sim = WCSimulator(g, dev)
            for a in (critical_path_assignment(g, dev, seed=0),
                      round_robin_assignment(g, dev.n)):
                assert lb <= sim.exec_time(a) * (1 + 1e-12), (arch, fleet)


def test_serial_batched_parity_asymmetric_links(zoo):
    g = zoo["phi4_mini_3p8b"]
    dev = get_device_model("two_pod_2x2")
    rng = np.random.default_rng(0)
    assigns = [critical_path_assignment(g, dev, seed=1),
               random_assignment(g, dev.n, seed=2),
               rng.integers(0, dev.n, size=g.n)]
    for choose in ("fifo", "dfs", "random"):
        for sigma in (0.0, 0.1):
            sim = WCSimulator(g, dev, choose=choose, noise_sigma=sigma)
            ser = sim.run_batch(assigns, seeds=[7, 8], engine="serial")
            bat = sim.run_batch(assigns, seeds=[7, 8], engine="batched")
            np.testing.assert_array_equal(ser, bat,
                                          err_msg=f"{choose} sigma={sigma}")


def test_memory_accounting_and_aware_placement(zoo):
    g = zoo["gemma_2b"]
    dev = get_device_model("mixed_gen4")
    a = critical_path_assignment(g, dev, seed=0)
    bpd = g.bytes_per_device(a, dev.n)
    assert bpd.shape == (dev.n,)
    assert bpd.sum() == pytest.approx(g.out_bytes_array().sum())
    assert dev.memory_ok(bpd)
    total = g.out_bytes_array().sum()
    ref = jax_zoo.import_model("gemma_2b", seq=SEQ)
    assert total == pytest.approx(ref.out_bytes_array().sum(), rel=0.15)
    tight = DeviceModel(dev.flops_per_sec, dev.link_bw, dev.link_latency,
                        exec_overhead=dev.exec_overhead,
                        mem_bytes=np.full(dev.n, total * 0.6))
    a2 = critical_path_assignment(g, tight, seed=0)
    assert tight.memory_ok(g.bytes_per_device(a2, tight.n))


def test_full_import_cache_byte_budget(monkeypatch, capsys):
    """The full-graph cache is budgeted in bytes, not entries: exceeding
    REPRO_ZOO_CACHE_BYTES evicts LRU-first (logged), oversized graphs
    pass through uncached, and hits return the identical object."""
    mz = model_zoo
    mz._import_model_full.cache_clear()
    g1 = mz.import_model_full("olmo_1b", seq=64, microbatches=1, n_layers=4)
    budget = int(g1.nbytes_estimate() * 2.3)
    monkeypatch.setenv("REPRO_ZOO_CACHE_BYTES", str(budget))
    try:
        assert mz.import_model_full("olmo_1b", seq=64, microbatches=1,
                                    n_layers=4) is g1          # hit
        mz.import_model_full("olmo_1b", seq=64, microbatches=2,
                             n_layers=4)                       # evicts g1
        info = mz._import_model_full.cache_info()
        assert info["evictions"] >= 1
        assert info["bytes"] <= info["max_bytes"]
        assert "cache evict" in capsys.readouterr().err
        g1b = mz.import_model_full("olmo_1b", seq=64, microbatches=1,
                                   n_layers=4)
        assert g1b is not g1 and g1b.n == g1.n                 # refetched
        monkeypatch.setenv("REPRO_ZOO_CACHE_BYTES", "1000")
        mz._import_model_full.cache_clear()
        mz.import_model_full("olmo_1b", seq=64, microbatches=1, n_layers=4)
        assert mz._import_model_full.cache_info()["entries"] == 0
    finally:
        mz._import_model_full.cache_clear()


# ---------------------------------------------------------- full models
def test_full_model_import_scale_and_fast_path():
    """tests/test_hierarchy.py's, and the vertex count within 15% of the
    reference's."""
    g = get_workload("model:olmo_1b:full", seq=64)
    ref = jax_zoo.import_model_full("olmo_1b", seq=64)
    assert g.n >= 5000
    assert g.n == pytest.approx(ref.n, rel=0.15)
    assert g.replication.n_rep == ref.replication.n_rep == 32
    part = coarsen(g, 64)
    assert 32 <= part.n_segments <= 160
    g1 = get_workload("model:olmo_1b:full", seq=64, microbatches=1)
    assert g.n < 2 * g1.n
    assert matmul_flops(g) == 2 * 16 * 3 * closed_form(
        get_config("olmo_1b"), 64)


def test_tile_graph_fwd_bwd_phases_acyclic():
    g = get_workload("model:olmo_1b:full", seq=64, microbatches=1)
    rep = g.replication
    assert rep.phase is not None
    for (u, v) in rep.unit.edges:
        assert not (rep.phase[u] == 1 and rep.phase[v] == 0)
    part = coarsen(g, 48)
    seg_phase = {}
    for v in range(g.n):
        s = int(part.vertex_segment[v])
        p = int(rep.phase[rep.unit_vid[v]])
        assert seg_phase.setdefault(s, p) == p, "segment spans chain phases"


# ---------------------------------------------------------------- oracle
def _hub(graph_cls, width):
    g = graph_cls(f"hub{width}")
    x = g.add_vertex("matmul", flops=1e9, out_bytes=1e6)
    g.add_edge(g.add_vertex("input", out_bytes=1e6), x)
    for _ in range(width):
        g.add_edge(x, g.add_vertex("matmul", flops=1e9, out_bytes=1e6))
    return g.freeze()


def test_both_oracles_refuse_the_same_over_bound_graph():
    """One product feeding 4,096: the trip bound passes the f32 queue
    keys' 2^24, and both packages send the graph to the numpy engines."""
    msgs = []
    for build, cls, dev in ((lambda g, d: SimGraph.build(g, d, "cpu"),
                             DataflowGraph, get_device_model("v100x8")),
                            (JaxSimGraph.build, JaxGraph,
                             jax_fleet("v100x8"))):
        with pytest.raises(ValueError) as e:
            build(_hub(cls, 4096), dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].endswith("; use the numpy engines")
    SimGraph.build(_hub(DataflowGraph, 64), get_device_model("v100x8"),
                   "cpu")


if __name__ == "__main__":              # the per-kind tables for PERF.md
    seq = int(sys.argv[1]) if len(sys.argv) > 1 else SEQ
    for arch in ARCH_IDS:
        for which in ("layer", "unit"):
            print_table(arch, which, seq, *graphs(arch, which, seq))
