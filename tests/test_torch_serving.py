"""Zero-shot serving in the port (``core/zero_shot.py``,
``launch/place_server.py``) against the reference's numpy serving path
(``repro/core/zero_shot.py``, ``repro/launch/place_server.py``), on the
same params:

* ``encode_graph`` within 1e-5 of the reference's numpy encoder (its own
  bar against the jit encoder, ``tests/test_serving.py``);
* ``greedy_place`` (the port's ``rollout_batch`` greedy) decision for
  decision equal to the reference's numpy ``greedy_place``;
* the server's results (assignment, makespan, source) equal to the
  reference server's, and the reference's behaviour tests of the cache;
* a reference ``save_pretrained`` checkpoint served through the port's
  ``from_checkpoint``, and the held-out CP bound after a port pretrain.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import make_chain, make_diamond, random_dag
from repro.core.devices import get_device_model as jax_fleet
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.policies import init_policies as jax_init_policies
from repro.core.policy_io import save_pretrained as jax_save_pretrained
from repro.core.zero_shot import encode_graph as jax_encode_graph
from repro.core.zero_shot import greedy_place as jax_greedy_place
from repro.core.zero_shot import to_numpy_params as jax_to_numpy_params
from repro.graphs import workloads as jax_workloads
from repro.launch.place_server import PlacementServer as JaxPlacementServer
from repro_torch.core import training
from repro_torch.core.devices import get_device_model, uniform_box
from repro_torch.core.heuristics import critical_path_assignment
from repro_torch.core.nn import tree_leaves
from repro_torch.core.simulator import WCSimulator
from repro_torch.core.zero_shot import (encode_graph, greedy_place,
                                        to_numpy_params)
from repro_torch.launch.place_server import (PlacementServer, PlaceRequest,
                                             PlaceResult)
from repro_torch.models.convert import params_from_numpy
from test_torch_pretrain import one_thread_a_process  # noqa: F401
from test_torch_train import port_graph

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jax_to_numpy_params(jax_init_policies(jax.random.PRNGKey(3)))


def _cell(name: str):
    """(reference graph, reference fleet, port graph, port fleet)."""
    gname, fleet = name.split("|")
    if gname == "diamond":
        gj = make_diamond()
    elif gname == "random24":
        gj = random_dag(np.random.default_rng(0), 24)
    else:
        gj = jax_workloads.get_workload(gname)
    if fleet == "dev4":
        return gj, jax_uniform_box(4), port_graph(gj), uniform_box(4)
    return gj, jax_fleet(fleet), port_graph(gj), get_device_model(fleet)


CELLS = ["diamond|dev4", "random24|straggler8", "llama_block|mixed_gen4",
         "ffnn|two_pod_2x2"]


@pytest.mark.parametrize("cell", ["diamond|dev4", "random24|straggler8"])
def test_encode_graph_matches_reference(jparams, cell):
    gj, _, g, _ = _cell(cell)
    got = encode_graph(jparams, g, **CPU)
    want = jax_encode_graph(jparams, gj)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_greedy_place_matches_reference(jparams, cell):
    gj, devj, g, dev = _cell(cell)
    got = greedy_place(jparams, g, dev, **CPU)
    assert got.shape == (g.n,) and (got >= 0).all() and (got < dev.n).all()
    assert np.array_equal(got, jax_greedy_place(jparams, gj, devj))


def test_to_numpy_params_and_params_on(jparams):
    """The zero-shot path's converters are ``models.convert``'s: numpy
    leaves to float32 tensors and back bit-equal, a tensor already on the
    device in float32 kept as it is."""
    tp = params_from_numpy(jparams, "cpu", torch.float32)
    assert all(x.dtype == torch.float32 for x in tree_leaves(tp))
    back = to_numpy_params(tp)
    assert all(a.dtype == np.float32 and np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)))
    assert params_from_numpy(tp, "cpu", torch.float32)["gnn"]["embed"][
        "layers"][0]["w"] is tp["gnn"]["embed"]["layers"][0]["w"]
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(to_numpy_params(back)),
        jax.tree_util.tree_leaves(jparams)))


@pytest.mark.parametrize("cell", CELLS)
def test_server_result_matches_reference(jparams, cell):
    gj, devj, g, dev = _cell(cell)
    got = PlacementServer(jparams, **CPU).place(g, dev)
    want = JaxPlacementServer(jparams).place(gj, devj)
    assert np.array_equal(got.assignment, want.assignment)
    assert (got.makespan, got.source, got.cache_hit) == (
        want.makespan, want.source, want.cache_hit)
    assert set(got.seconds) == {"greedy", "cp", "scoring"}


# ------------------------------------- the reference's behaviour tests
def test_server_miss_then_hit_and_cp_bound(jparams):
    g, dev4 = port_graph(make_diamond()), uniform_box(4)
    srv = PlacementServer(jparams, **CPU)
    r1 = srv.place(g, dev4)
    assert isinstance(r1, PlaceResult) and not r1.cache_hit
    r2 = srv.place(g, dev4)
    assert r2.cache_hit and r2.seconds == {}
    np.testing.assert_array_equal(r1.assignment, r2.assignment)
    assert srv.stats() == {"hits": 1, "misses": 1, "cached": 1}
    sim = WCSimulator(g, dev4, choose="fifo", noise_sigma=0.0)
    cp = min(sim.run(critical_path_assignment(g, dev4, seed=s)).makespan
             for s in range(2))
    assert r1.makespan <= cp * (1 + 1e-9)


def test_server_cache_keys_and_lru_eviction(jparams):
    dev4 = uniform_box(4)
    srv = PlacementServer(jparams, cache_size=1, **CPU)
    g1, g2 = port_graph(make_chain(4)), port_graph(make_chain(6))
    srv.place(g1, dev4)
    srv.place(g2, dev4)            # evicts g1 (capacity 1)
    assert not srv.place(g1, dev4).cache_hit
    # same topo-hash but a different fleet is a different key
    srv2 = PlacementServer(jparams, **CPU)
    srv2.place(g1, dev4)
    assert not srv2.place(g1, uniform_box(2)).cache_hit
    # a relabeled graph is the same key
    g3 = port_graph(make_chain(4))
    for v in g3.vertices:
        v.label = f"renamed_{v.vid}"
    assert srv2.place(g3, dev4).cache_hit


def test_server_place_batch(jparams):
    srv = PlacementServer(jparams, **CPU)
    g, dev4 = port_graph(make_diamond(4)), uniform_box(4)
    out = srv.place_batch([(g, dev4), PlaceRequest(g, dev4)])
    assert [r.cache_hit for r in out] == [False, True]


def test_server_fine_tune_serves_at_most_the_zero_shot(jparams):
    gj, _, g, dev = _cell("random24|straggler8")
    zero = PlacementServer(jparams, **CPU).place(g, dev)
    srv = PlacementServer(jparams, meta={"d_hidden": 64, "gnn_layers": 2},
                          **CPU)
    ft = srv.place(g, dev, fine_tune_budget_s=0.5)
    assert ft.fine_tune_updates >= 1
    assert ft.makespan <= zero.makespan
    assert ft.source in ("policy", "cp", "fine_tuned")
    assert set(ft.seconds) == {"greedy", "cp", "scoring", "fine_tune"}
    sim = WCSimulator(g, dev, choose="fifo", noise_sigma=0.0)
    assert sim.run(ft.assignment).makespan == pytest.approx(ft.makespan)


def test_reference_checkpoint_serves_through_from_checkpoint(jparams,
                                                             tmp_path):
    meta = {"d_hidden": 64, "d_z": 32, "d_y": 32, "gnn_layers": 2}
    jax_save_pretrained(tmp_path, {"params": jparams, "meta": meta,
                                   "per_task": {}})
    srv = PlacementServer.from_checkpoint(tmp_path, **CPU)
    assert srv.meta == meta
    gj, devj, g, dev = _cell("llama_block|mixed_gen4")
    got = srv.place(g, dev)
    want = JaxPlacementServer.from_checkpoint(tmp_path).place(gj, devj)
    assert np.array_equal(got.assignment, want.assignment)
    assert (got.makespan, got.source) == (want.makespan, want.source)


def test_pretrained_zero_shot_bounded_vs_cp_on_held_out():
    """The serving gate in miniature (the reference's
    ``test_pretrained_zero_shot_bounded_vs_cp_on_held_out``): on graphs x
    fleets the pretraining never saw, the served placement is at or
    below CP's makespan and re-scores to the served makespan."""
    tasks = [training.PretrainTask("chain|u4", port_graph(make_chain(5)),
                                   uniform_box(4)),
             training.PretrainTask("diamond|mixed",
                                   port_graph(make_diamond(4)),
                                   get_device_model("mixed_gen4"))]
    pre = training.pretrain(tasks, rounds=1, batch_size=2,
                            imitation_episodes=1, d_hidden=16, d_z=8, d_y=8,
                            **CPU)
    srv = PlacementServer(pre["params"], meta=pre["meta"], **CPU)
    held_out = [(port_graph(random_dag(np.random.default_rng(7), 20)),
                 get_device_model("two_pod_2x2")),
                (port_graph(make_diamond(6)), get_device_model("straggler8"))]
    for g, dev in held_out:
        r = srv.place(g, dev)
        sim = WCSimulator(g, dev, choose="fifo", noise_sigma=0.0)
        cp = min(sim.run(critical_path_assignment(g, dev, seed=s)).makespan
                 for s in range(2))
        assert r.makespan <= cp * (1 + 1e-9)
        assert sim.run(r.assignment).makespan == pytest.approx(r.makespan)


def test_cuda_server_without_gpu_raises(monkeypatch, jparams):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PlacementServer(jparams)
    with pytest.raises(RuntimeError):
        greedy_place(jparams, port_graph(make_diamond()), uniform_box(4))

