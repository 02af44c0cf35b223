"""The port's data-parallel fused Stage II (``build_fused_stage2(...,
n_devices=2)``, ``DopplerTrainer.stage2_fused(n_devices=2)``) against the
reference's sharded engine on the CPU.

The reference runs on two XLA host devices in a subprocess
(``--xla_force_host_platform_device_count=2``, as
``tests/test_train_fused.py::test_shard_map_matches_pmap_two_devices``);
the port over two gloo ranks, one process each, on the same draws: the
reference trainer's key chain turned into the global batch's tables
(``key_chain_draws``), of which each rank takes its episodes.
``make_diamond(8)`` x ``uniform_box(4)``, K 8 (4 a rank), 2 updates of
one a dispatch, eps 0, the monolithic engine and the chunked one (chunks
of 2 for sampling and gradients).  Bars:

* makespans, validity flags, best assignments and the sampled actions
  bit-identical to the reference's, and every rank's result identical;
* each update held against the reference's own functions on the port's
  pre-step state (``assert_step_matches_reference``): the loss 1e-5
  relative, the gradient, the mean of the two shards' gradients of the
  reference's ``fused_pg_loss``, within 5e-6 of max(1, max|g|), the
  params within lr / 100 of the reference's AdamW step; the advantages
  within 1e-6 of the reference's sharded arithmetic (the batch moments
  the mean of the shards'); the losses and params after each update
  against the reference's sharded run at those bars and at the
  fused-vs-loop bar (5e-3);
* the port's N = 2 against its own N = 1 on the same draws: makespans
  bit-equal, params within 5e-3 (the batch std's two formulas differ in
  the last bits).
"""
import os
import pickle
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_diamond
from repro.core import training as jax_training
from repro.core import train_fused as jax_fused
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.zero_shot import to_numpy_params
from repro_torch.core import training
from repro_torch.core.devices import uniform_box
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train.optim import AdamState
from test_torch_fused_stage import EPS0, key_chain_draws, same_params
from test_torch_train import (assert_loss_close, assert_params_close,
                              assert_step_matches_reference, port_graph)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
K, N, UPDATES, WIDTH = 8, 2, 2, 8
MODES = {"monolithic": dict(chunk_size=0),
         "chunked": dict(chunk_size=2, grad_chunk_size=2)}

REFERENCE = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           + os.environ.get("XLA_FLAGS", "")).strip()
sys.path[:0] = [{src!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
from conftest import make_diamond
from repro.core.devices import uniform_box
from repro.core.sim_jax import SimGraph
from repro.core.train_fused import (FusedStage2Config, RewardStats,
                                    build_fused_stage2)
from repro.core.training import DopplerTrainer
assert jax.local_device_count() == 2
g, dev = make_diamond({width}), uniform_box(4)
out = {{}}
for name, kw in {modes!r}.items():
    tr = DopplerTrainer(g, dev, seed=0, d_hidden=16, **{eps!r})
    fn = build_fused_stage2(FusedStage2Config(batch_size={k}, updates=1,
                                              **kw),
                            tr.gd, SimGraph.build(g, dev), tr.lr_sched,
                            tr.eps_sched, n_devices=2)
    state = (tr.params, tr.opt_state, RewardStats.make(0.0, 0.0, 0), tr.key,
             jnp.int32(0))
    runs = []
    for _ in range({updates}):
        o = fn(*state)
        state = (o["params"], o["opt_state"], o["rstats"], o["key"],
                 o["episode"])
        runs.append({{k: jax.tree_util.tree_map(np.asarray, o[k]) for k in
                     ("makespans", "oracle_ok", "best_assignments",
                      "losses", "params", "rstats")}})
    out[name] = runs
pickle.dump(out, open(sys.argv[1], "wb"))
print("REFERENCE_OK")
"""

RANK = """
import sys, pickle
sys.path.insert(0, {src!r})
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.core import training
from repro_torch.core.devices import uniform_box
from repro_torch.models.convert import params_from_numpy, params_to_numpy
rank, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + inp + ".store",
                        rank=rank, world_size={n})
data = pickle.load(open(inp, "rb"))
res = {{}}
for name, kw in {modes!r}.items():
    tr = training.DopplerTrainer(data["graph"], uniform_box(4), seed=0,
                                 d_hidden=16, device="cpu", **{eps!r})
    tr.params = params_from_numpy(data["params"])
    steps = []
    for i in range({updates}):
        before = (params_to_numpy(tr.params), tr.opt_state.step,
                  params_to_numpy(tr.opt_state.mu),
                  params_to_numpy(tr.opt_state.nu), tr.episode)
        ms = tr.stage2_fused(1, batch_size={k}, updates_per_dispatch=1,
                             n_devices={n}, draws=data["draws"][i:i + 1],
                             **kw)
        lu = tr.last_update
        steps.append({{"before": before, "makespans": ms,
                      "actions": lu["actions"].numpy(),
                      "advantages": lu["advantages"], "loss": lu["loss"],
                      "grads": params_to_numpy(lu["grads"]),
                      "params": params_to_numpy(tr.params),
                      "step": tr.opt_state.step,
                      "mu": params_to_numpy(tr.opt_state.mu),
                      "nu": params_to_numpy(tr.opt_state.nu),
                      "rstats": (tr._r_sum, tr._r_sqsum, tr._r_count),
                      "best": (tr.best_time, tr.best_assignment),
                      "episode": tr.episode}})
    res[name] = steps
pickle.dump(res, open(out, "wb"))
dist.destroy_process_group()
"""


def _tree_equal(a, b) -> bool:
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded run (a subprocess on two host devices) and
    the port's two gloo ranks, started together; the reference trainer
    in this process, for the draws, the schedules and the per-step
    checks."""
    tmp = tmp_path_factory.mktemp("dp")
    jt = jax_training.DopplerTrainer(make_diamond(WIDTH), jax_uniform_box(4),
                                     seed=0, d_hidden=16, **EPS0)
    draws = key_chain_draws(jt, UPDATES, K)
    inp = str(tmp / "inputs.pkl")
    with open(inp, "wb") as f:
        pickle.dump({"graph": port_graph(make_diamond(WIDTH)),
                     "params": to_numpy_params(jt.params),
                     "draws": draws}, f)
    fmt = dict(src=SRC, tests=os.path.join(ROOT, "tests"), width=WIDTH,
               modes=MODES, eps=EPS0, k=K, n=N, updates=UPDATES)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    ref_out = str(tmp / "reference.pkl")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(**fmt)),
         ref_out], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)]
    rank_outs = [str(tmp / f"rank{r}.pkl") for r in range(N)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", RANK.format(**fmt), str(r), inp,
         rank_outs[r]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(N)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    with open(ref_out, "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for path in rank_outs:
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
    return types.SimpleNamespace(jt=jt, draws=draws, ref=ref, ranks=ranks)


def test_every_rank_returns_the_same_result(runs):
    a, b = runs.ranks
    assert a.keys() == b.keys() == MODES.keys()
    for name in MODES:
        for x, y in zip(a[name], b[name]):
            assert x.keys() == y.keys()
            for key in x:
                assert _tree_equal(x[key], y[key]), (name, key)


@pytest.mark.parametrize("mode", list(MODES))
def test_makespans_and_actions_match_reference(runs, mode):
    """Bit for bit: the makespans and flags (episode-major, the ranks'
    blocks in order), each update's best assignment, and the actions the
    reference samples on the same keys and params."""
    jt = runs.jt
    key = jt.key
    best = np.inf
    for i, (got, want) in enumerate(zip(runs.ranks[0][mode],
                                        runs.ref[mode])):
        assert want["oracle_ok"].all()
        assert got["makespans"] == want["makespans"][0].tolist()
        if want["makespans"].min() < best:
            best = float(want["makespans"].min())
            assert np.array_equal(got["best"][1],
                                  want["best_assignments"][0])
        assert got["best"][0] == best
        key, sub = jax.random.split(key)
        params = params_from_numpy(got["before"][0])
        rec = jax_fused.sample_episodes(
            _as_reference(params, jt), jt.gd, jax.random.split(sub, K),
            jnp.float32(jt.eps_sched(jnp.int32(i * K))))
        assert np.array_equal(got["actions"], np.asarray(rec["actions"]))


def _as_reference(tree, jt):
    from test_torch_train import as_reference_tree
    return as_reference_tree(tree, jt.params)


def _reference_advantages(ms, rstats):
    """The reference's sharded advantages (every episode valid): the
    batch's mean and mean square the means of the shards'."""
    rs = -np.asarray(ms, np.float32)
    shards = rs.reshape(N, K // N)
    mean_b = np.float32(np.mean([s.mean() for s in shards], dtype=np.float32))
    sq_b = np.float32(np.mean([(s * s).mean() for s in shards],
                              dtype=np.float32))
    std_b = np.sqrt(np.float32(max(sq_b - mean_b * mean_b, 0.0)))
    stats = jax_fused.RewardStats.make(*rstats)
    mean, std = (np.asarray(x) for x in stats.baseline())
    advs = rs - (mean if rstats[2] > 0 else mean_b)
    return advs / (np.maximum(std, std_b) + np.float32(1e-9))


@pytest.mark.parametrize("mode", list(MODES))
def test_each_update_matches_reference_step(runs, mode):
    """Loss, gradient (the mean of the shards' reference gradients) and
    AdamW step on the port's pre-step state; the advantages; the losses,
    reward statistics and params of the reference's sharded run."""
    jt = runs.jt
    loss_and_grad = jax.jit(jax.value_and_grad(jax_fused.fused_pg_loss))
    ew = jnp.float32(jt.entropy_weight)
    key = jt.key
    rstats = (0.0, 0.0, 0)
    for i, (got, want) in enumerate(zip(runs.ranks[0][mode],
                                        runs.ref[mode])):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, K)
        eps = jnp.float32(jt.eps_sched(jnp.int32(i * K)))
        np.testing.assert_allclose(
            got["advantages"], _reference_advantages(got["makespans"],
                                                     rstats),
            rtol=1e-6, atol=1e-7)
        advs = jnp.asarray(got["advantages"])

        def ref_loss_and_grad(p):
            parts = []
            for r in range(N):
                sl = slice(r * K // N, (r + 1) * K // N)
                rec = jax_fused.sample_episodes(p, jt.gd, keys[sl], eps)
                parts.append(loss_and_grad(p, jt.gd, rec, advs[sl], ew))
            return jax.tree_util.tree_map(lambda *x: sum(x) / N, *parts)

        params0, step0, mu0, nu0, episode0 = got["before"]
        pt = types.SimpleNamespace(
            params=params_from_numpy(got["params"]),
            opt_state=AdamState(got["step"], params_from_numpy(got["mu"]),
                                params_from_numpy(got["nu"])),
            last_update={"loss": got["loss"],
                         "grads": params_from_numpy(got["grads"])})
        before = (params_from_numpy(params0),
                  AdamState(step0, params_from_numpy(mu0),
                            params_from_numpy(nu0)), episode0)
        assert_step_matches_reference(pt, jt, before, ref_loss_and_grad)
        assert_loss_close(got["loss"], want["losses"][0])
        r = want["rstats"]
        assert got["rstats"][2] == int(r.r_count) == (i + 1) * K
        assert got["rstats"][0] == pytest.approx(float(r.r_sum), rel=1e-6)
        assert got["rstats"][1] == pytest.approx(float(r.r_sqsum), rel=1e-6)
        assert_params_close(pt, types.SimpleNamespace(params=want["params"]))
        rstats = got["rstats"]
        assert got["episode"] == (i + 1) * K


@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_match_one_device(runs, mode):
    """The port's N = 2 against its own single-device engine on the same
    draws: the same sampled population, makespans bit-equal."""
    pt = training.DopplerTrainer(port_graph(make_diamond(WIDTH)),
                                 uniform_box(4), seed=0, d_hidden=16,
                                 device="cpu", **EPS0)
    pt.params = params_from_numpy(to_numpy_params(runs.jt.params))
    for i, got in enumerate(runs.ranks[0][mode]):
        ms = pt.stage2_fused(1, batch_size=K, updates_per_dispatch=1,
                             draws=runs.draws[i:i + 1], **MODES[mode])
        assert ms == got["makespans"]
        assert np.array_equal(pt.last_update["actions"].numpy(),
                              got["actions"])
    same_params(pt, types.SimpleNamespace(
        params=params_from_numpy(got["params"])))
