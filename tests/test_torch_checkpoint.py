"""Checkpoints of the port (``train/checkpoint.py``, ``core/policy_io.py``)
against the reference's format and loader:

* the hand-written msgpack codec packs the format's types to
  ``msgpack``'s bytes, round-trips them and raises on any other type,
  and ``arrays.msgpack`` is byte-identical to the reference's for the
  same leaves;
* a checkpoint ``repro`` writes mid-Stage-II loads bit-equal in the port
  and the port continues along the reference's trajectory on six-table
  draws of the checkpoint's key (``tests/test_torch_stage2.py``'s
  bars); a port checkpoint loads in ``repro`` with the key kept;
* port -> port resume is exact on ``stage2_sim_batched`` and on the
  fused engine (``stage2_fused(capture=False)``, an engine already
  built before the load), as ``tests/test_engine.py`` holds the
  reference's;
* a hierarchical, mismatched, incomplete or other-device checkpoint
  raises and leaves the trainer untouched; pretrained policies
  round-trip.
"""
import json

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.core import policies as jax_policies
from repro.core import policy_io as jax_policy_io
from repro.core.engine import SimRewardEngine
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro.core.zero_shot import to_numpy_params
from repro.train import checkpoint as jax_checkpoint
from repro_torch.core import policy_io, training
from repro_torch.core.devices import get_device_model
from repro_torch.core.nn import tree_leaves, tree_map
from repro_torch.core.simulator import WCSimulator
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import _msgpack, checkpoint
from test_torch_stage2 import EPS02, step_pair
from test_torch_train import (assert_params_close, port_graph,
                              reference_graph, trainer_pair)

GRAPH, FLEET, K = "diamond", "mixed_gen4", 4


# ------------------------------------------------------------- the codec
CODEC_CASES = {
    "fixint": [0, 1, 127], "uint8": [128, 255], "uint16": [256, 65535],
    "uint32": [65536, 2 ** 32 - 1], "uint64": [2 ** 32, 2 ** 64 - 1],
    "fixstr": ["", "arr_00000", "é" * 15], "str8": ["a" * 32, "a" * 255],
    "str16": ["a" * 256, "a" * 65535], "bin8": [b"", b"x" * 255],
    "bin16": [b"x" * 256, b"x" * 65535], "bin32": [b"x" * 65536],
    "fixarray": [[], [300, 64], list(range(15))],
    "array16": [list(range(16)), [7] * 300],
    "fixmap": [{}, {"key": "arr_00000", "dtype": "int32", "shape": [],
                    "data": b"\x01\x00\x00\x00"}],
    "map16": [{f"k{i}": i for i in range(16)}],
}


@pytest.mark.parametrize("kind", sorted(CODEC_CASES))
def test_codec_packs_msgpack_bytes_and_round_trips(kind):
    for obj in CODEC_CASES[kind]:
        raw = _msgpack.pack(obj)
        assert raw == msgpack.packb(obj)
        (back,) = _msgpack.unpack_stream(raw)
        if isinstance(obj, bytes):
            back = bytes(back)
        assert back == obj
    stream = b"".join(_msgpack.pack(o) for o in CODEC_CASES[kind])
    assert len(_msgpack.unpack_stream(stream)) == len(CODEC_CASES[kind])


@pytest.mark.parametrize("obj", [-1, 1.5, None, True, 2 ** 64, {1: [2.0]},
                                 "a" * 65536], ids=repr)
def test_codec_raises_on_types_outside_the_format(obj):
    with pytest.raises((TypeError, ValueError)):
        _msgpack.pack(obj)


@pytest.mark.parametrize("raw", [b"\xc0", b"\xc3", b"\xca\0\0\0\0",
                                 b"\xd0\x01", b"\xdb\0\0\0\0",
                                 b"\xdd\0\0\0\0", b"\xdf\0\0\0\0",
                                 b"\xa3ab", b"\x92\x01", b"\xcd\x01"],
                         ids=lambda r: r.hex())
def test_codec_raises_on_bytes_outside_the_format(raw):
    with pytest.raises(ValueError):
        _msgpack.unpack_stream(raw)


def _mixed_leaves():
    rng = np.random.default_rng(0)
    return {"f32": rng.standard_normal((300, 64)).astype(np.float32),
            "i32": np.int32(7) * np.ones((), np.int32),
            "flags": rng.random(5) < 0.5,
            "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
            "f64": rng.standard_normal(3),
            "empty": np.zeros((0, 4), np.float32),
            "seq": [np.float32(2.5) * np.ones(1, np.float32)]}


@pytest.mark.parametrize("what", ["mixed", "trainer"])
def test_arrays_msgpack_byte_identical_to_reference(tmp_path, what):
    if what == "mixed":
        leaves = _mixed_leaves()
        jax_checkpoint.save_checkpoint(tmp_path / "ref", 3, leaves)
        tree = tree_map(lambda x: torch.from_numpy(np.asarray(x)), leaves)
    else:
        jt, pt = trainer_pair(GRAPH, FLEET, **EPS02)
        jax_checkpoint.save_checkpoint(tmp_path / "ref", 3,
                                       (jt.params, jt.opt_state))
        tree = (pt.params, pt.opt_state._replace(
            step=torch.tensor(0, dtype=torch.int32)))
    checkpoint.save_checkpoint(tmp_path / "port", 3, tree)
    ref, port = (tmp_path / d / "step_000000003" for d in ("ref", "port"))
    assert (port / "arrays.msgpack").read_bytes() == \
        (ref / "arrays.msgpack").read_bytes()
    mr, mp = (json.loads((d / "manifest.json").read_text())
              for d in (ref, port))
    assert mp["index"] == mr["index"] and mp["n_arrays"] == mr["n_arrays"]
    assert mp["complete"] and not (tmp_path / "port" /
                                   ".tmp_step_000000003").exists()
    back, _ = checkpoint.restore_checkpoint(tmp_path / "ref", 3, tree)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------- across the two packages
def _sim_pair(jt, pt):
    return (JaxWCSimulator(jt.g, jt.dev, noise_sigma=0.05),
            WCSimulator(pt.g, pt.dev, noise_sigma=0.05))


def _port_trainer(seed, **kw):
    return training.DopplerTrainer(
        port_graph(reference_graph(GRAPH)), get_device_model(FLEET),
        seed=seed, d_hidden=16, device="cpu", **{**EPS02, **kw})


def _assert_state_equal(pt, jt):
    """Params, moments, step, counters, statistics and best bit-equal."""
    for got, want in ((pt.params, jt.params), (pt.opt_state.mu,
                                               jt.opt_state.mu),
                      (pt.opt_state.nu, jt.opt_state.nu)):
        a = tree_leaves(got)
        b = jax.tree_util.tree_leaves(want)
        assert len(a) == len(b)
        assert all(np.array_equal(x.numpy(), np.asarray(y))
                   for x, y in zip(a, b))
    assert pt.opt_state.step == int(jt.opt_state.step)
    assert pt.episode == jt.episode
    assert (pt._r_sum, pt._r_sqsum, pt._r_count) == (jt._r_sum, jt._r_sqsum,
                                                     jt._r_count)
    assert pt.best_time == jt.best_time
    assert np.array_equal(pt.best_assignment, jt.best_assignment)


def test_reference_checkpoint_loads_and_continues(tmp_path):
    """``repro`` saves after 2 ``stage2_sim_batched`` updates at K 4 (eps
    0.2 schedule); a port trainer of another seed loads it bit-equal and
    takes 2 more updates on six-table draws of the checkpoint's key,
    each held against the reference's continuation."""
    jt, twin = trainer_pair(GRAPH, FLEET, **EPS02)
    jsim, sim = _sim_pair(jt, twin)
    jt.stage2_sim_batched(2, sim=jsim, batch_size=K)
    jax_policy_io.save_policy(tmp_path, jt)
    pt = _port_trainer(seed=7)
    assert policy_io.load_policy(tmp_path, pt) is pt
    _assert_state_equal(pt, jt)
    assert np.array_equal(pt.key, np.asarray(jt.key))
    assert pt.key.dtype == np.uint32
    for _ in range(2):
        step_pair(jt, pt,
                  lambda: jt.stage2_sim_batched(1, sim=jsim, batch_size=K),
                  lambda d: pt.stage2_sim_batched(1, sim=sim, batch_size=K,
                                                  draws=d),
                  K=K, reward=SimRewardEngine(jsim))
    assert pt.episode == jt.episode == 4 * K
    assert_params_close(pt, jt)


def test_port_checkpoint_loads_in_reference(tmp_path):
    """repro -> port -> repro: the port trains on from a reference
    checkpoint, saves, and the reference loads its state bit-equal with
    the key it first wrote; AdamW's step is a 0-d int32 leaf."""
    jt, _ = trainer_pair(GRAPH, FLEET, **EPS02)
    jax_policy_io.save_policy(tmp_path / "ref", jt)
    pt = _port_trainer(seed=3)
    policy_io.load_policy(tmp_path / "ref", pt)
    _, sim = _sim_pair(jt, pt)
    pt.stage2_sim_batched(2, sim=sim, batch_size=K)
    path = policy_io.save_policy(tmp_path / "port", pt)
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["index"][-1 - 2 * len(tree_leaves(pt.params))] == {
        "key": f"arr_{len(tree_leaves(pt.params)):05d}", "shape": [],
        "dtype": "int32"}
    assert manifest["extra"]["torch_generator"]["device"] == "cpu"
    jt2, _ = trainer_pair(GRAPH, FLEET, **EPS02)
    jt2.key = jax.random.PRNGKey(99)
    jax_policy_io.load_policy(tmp_path / "port", jt2)
    _assert_state_equal(pt, jt2)
    assert np.array_equal(np.asarray(jt2.key), np.asarray(jt.key))
    # a port trainer that never held a key writes None: the reference
    # keeps its own
    fresh = _port_trainer(seed=4)
    policy_io.save_policy(tmp_path / "fresh", fresh)
    jax_policy_io.load_policy(tmp_path / "fresh", jt2)
    assert np.array_equal(np.asarray(jt2.key), np.asarray(jt.key))
    assert jt2.episode == 0


# ---------------------------------------------------------- port -> port
@pytest.fixture
def one_thread():
    """Resume is exact on deterministic kernels: torch's CPU kernels that
    split a sum across threads are not (two identical fused runs of a
    larger graph differ in the last bits), so these tests run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_resumed(a, b):
    for x, y in zip(tree_leaves((a.params, a.opt_state.mu, a.opt_state.nu)),
                    tree_leaves((b.params, b.opt_state.mu, b.opt_state.nu))):
        assert torch.equal(x, y)
    assert a.opt_state.step == b.opt_state.step and a.episode == b.episode
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert np.array_equal(a.greedy_assignment(), b.greedy_assignment())
    assert (a._r_sum, a._r_sqsum, a._r_count) == (b._r_sum, b._r_sqsum,
                                                  b._r_count)


def test_port_resume_batched_path(tmp_path, one_thread):
    """Save mid-Stage-II, reload into a trainer of another seed: the
    generator's draws, trajectories, params and greedy assignment
    continue exactly."""
    a = _port_trainer(seed=3)
    sim = WCSimulator(a.g, a.dev, choose="fifo", noise_sigma=0.05)
    a.stage2_sim_batched(2, sim, batch_size=K)
    policy_io.save_policy(tmp_path, a)
    want = a.stage2_sim_batched(2, sim, batch_size=K)
    b = _port_trainer(seed=999)
    policy_io.load_policy(tmp_path, b)
    assert b.episode == 2 * K
    assert b.stage2_sim_batched(2, sim, batch_size=K) == want
    _assert_resumed(a, b)


def test_port_resume_fused_path(tmp_path, one_thread):
    """The fused engine: trainer B builds its engine (one update) before
    it loads, so the load must reach the engine's static buffers."""
    a = _port_trainer(seed=4)
    a.stage2_fused(2, batch_size=K, updates_per_dispatch=2, capture=False)
    policy_io.save_policy(tmp_path, a)
    want = a.stage2_fused(2, batch_size=K, updates_per_dispatch=2,
                          capture=False)
    b = _port_trainer(seed=123)
    b.stage2_fused(1, batch_size=K, updates_per_dispatch=2, capture=False)
    policy_io.load_policy(tmp_path, b)
    assert b.stage2_fused(2, batch_size=K, updates_per_dispatch=2,
                          capture=False) == want
    _assert_resumed(a, b)
    assert a.best_time == b.best_time


# ------------------------------------------------------ what must raise
def _doctor(path, fn):
    m = path / "manifest.json"
    manifest = json.loads(m.read_text())
    fn(manifest)
    m.write_text(json.dumps(manifest))


@pytest.mark.parametrize("fault", ["hierarchical", "shape", "count",
                                   "incomplete", "generator"])
def test_bad_checkpoint_raises_and_leaves_trainer_untouched(tmp_path,
                                                            fault):
    src = _port_trainer(seed=5)
    src.stage2_sim_batched(1, WCSimulator(src.g, src.dev), batch_size=K)
    path = policy_io.save_policy(tmp_path, src)
    kw = {"shape": dict(d_hidden=8), "count": dict(gnn_layers=3)}
    dst = training.DopplerTrainer(src.g, src.dev, seed=6, device="cpu",
                                  **{"d_hidden": 16, **kw.get(fault, {})})
    if fault == "hierarchical":
        _doctor(path, lambda m: m["extra"].update(
            hierarchy={"n_segments": 4}))
    elif fault == "incomplete":
        _doctor(path, lambda m: m.update(complete=False))
    elif fault == "generator":
        _doctor(path, lambda m: m["extra"]["torch_generator"].update(
            device="cuda"))
    before = ([x.clone() for x in tree_leaves(dst.params)],
              dst.generator.get_state(), dst.episode, dst.opt_state.step)
    err = OSError if fault == "incomplete" else ValueError
    with pytest.raises(err) as info:
        policy_io.load_policy(tmp_path, dst)
    if fault == "generator":
        assert "cuda" in str(info.value) and "cpu" in str(info.value)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(dst.params), before[0]))
    assert torch.equal(dst.generator.get_state(), before[1])
    assert (dst.episode, dst.opt_state.step) == before[2:]
    assert dst.key is None and dst._r_count == 0


def test_latest_step_keep_and_atomic_publish(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    for step in (1, 5, 9, 12):
        checkpoint.save_checkpoint(tmp_path, step, tree, keep=3)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_000000005", "step_000000009", "step_000000012"]
    (tmp_path / ".tmp_step_000000020").mkdir()       # a crashed save
    (tmp_path / "step_000000030").mkdir()            # no manifest yet
    assert checkpoint.latest_step(tmp_path) == 12
    assert checkpoint.latest_step(tmp_path / "none") is None
    back, extra = checkpoint.restore_checkpoint(tmp_path, 9, tree)
    assert torch.equal(back["w"], tree["w"]) and extra == {}
    with pytest.raises(FileNotFoundError):
        policy_io.load_policy(tmp_path / "none", _port_trainer(seed=0))


# ------------------------------------------------------------- pretrained
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pretrained_round_trip(tmp_path, writer):
    """``save_pretrained`` / ``load_pretrained`` without a trainer, and
    across the two packages in either direction."""
    meta = {"d_hidden": 16, "d_z": 8, "d_y": 8, "gnn_layers": 3}
    jparams = jax_policies.init_policies(
        jax.random.PRNGKey(2), d_hidden=16, d_z=8, d_y=8, gnn_layers=3)
    params = params_from_numpy(to_numpy_params(jparams))
    per_task = {"diamond": 1.25}
    if writer == "port":
        policy_io.save_pretrained(tmp_path, {"params": params, "meta": meta,
                                             "per_task": per_task})
        back = jax_policy_io.load_pretrained(tmp_path)
        got = [np.asarray(x) for x in jax.tree_util.tree_leaves(
            back["params"])]
    else:
        jax_policy_io.save_pretrained(tmp_path, {
            "params": jparams, "meta": meta, "per_task": per_task})
        back = policy_io.load_pretrained(tmp_path, device="cpu")
        got = [x.numpy() for x in tree_leaves(back["params"])]
    assert back["meta"] == meta and back["per_task"] == per_task
    want = [x.numpy() for x in tree_leaves(params)]
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    again = policy_io.load_pretrained(tmp_path, device="cpu")
    assert all(torch.equal(a, torch.from_numpy(b)) for a, b in
               zip(tree_leaves(again["params"]), want))
