"""Pretraining, transfer and ``FleetTrainer`` of the port against the JAX
reference (``repro/core/training.py``'s functions around the trainer).

* ``pretrain`` on the reference's micro tasks (``tests/test_serving.py``)
  with the reference's initial params and, for each task's updates, the
  draw tables of that task's trainer's key chain (``reference_draws``):
  every sampled batch of assignments and every reward batch exact, the
  per-task ``best_time`` exact, ``meta`` equal, and every update of the
  shared params and AdamW moments held against the reference's step on
  the port's pre-update state.
* the synthetic half of ``zoo_pretrain_tasks``: the same names, edges,
  flops and bytes as the reference's; its model half: the reference's
  names, fleets and order.
* ``transfer`` and the reference's behaviour tests of ``FleetTrainer``;
  ``fleet_exec_time`` bit-equal to the reference's; one ``train`` on
  injected draws equal to the reference's history, best time and
  assignment.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_chain, make_diamond, random_dag
from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.core import training as jax_training
from repro.core.devices import get_device_model as jax_fleet
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.engine import SimRewardEngine as JaxSimRewardEngine
from repro.core.policies import init_policies as jax_init_policies
from repro.core.zero_shot import to_numpy_params
from repro.train import optim as jax_optim
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core import training
from repro_torch.core.devices import get_device_model, uniform_box
from repro_torch.core.engine import SimRewardEngine
from repro_torch.core.nn import tree_leaves
from repro_torch.core.simulator import WCSimulator
from repro_torch.models.convert import params_from_numpy
from test_torch_stage2 import EPS02, reference_draws
from test_torch_train import (GRAD_TOL, assert_grads_close,
                              assert_params_close, as_reference_tree,
                              assert_step_matches_reference, port_graph)

MICRO = dict(rounds=2, batch_size=2, imitation_episodes=1, d_hidden=16,
             d_z=8, d_y=8, gnn_layers=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread_a_process():
    """These trainers run thousands of tiny ops, which torch's intra-op
    threads only slow down, and under a parallel test run each process's
    threads would contend for the others' cores; so one thread (also
    imported, and so applied, by the other pretraining, serving,
    supervisor and CLI test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def micro_tasks(port: bool):
    """The reference's micro pretraining tasks (``tests/test_serving.py``),
    as reference or port tasks."""
    cells = [("chain|u4", make_chain(5), "u4"),
             ("diamond|mixed", make_diamond(4), "mixed_gen4")]
    if port:
        return [training.PretrainTask(
            name, port_graph(g), uniform_box(4) if fleet == "u4"
            else get_device_model(fleet)) for name, g, fleet in cells]
    return [jax_training.PretrainTask(
        name, g, jax_uniform_box(4) if fleet == "u4" else jax_fleet(fleet))
        for name, g, fleet in cells]


def trainer_chain_draws(seed: int, K: int, n: int, nd: int,
                        skip: int, updates: int) -> list:
    """The six draw tables of each of ``updates`` batched updates of a
    reference trainer built with ``seed``, after ``skip`` calls of its
    ``_next_key`` (Stage I episodes take one each)."""
    key = jax.random.split(jax.random.PRNGKey(seed))[0]
    for _ in range(skip):
        key, _ = jax.random.split(key)
    out = []
    for _ in range(updates):
        key, sub = jax.random.split(key)
        out.append(reference_draws(jax.random.split(sub, K), n, nd))
    return out


class _Recorder:
    """Records each ``_batched_rl_update`` of a trainer class (the trainer,
    its rewards and optimizer state after it, and on the port's side,
    ``check(trainer, before)``) and each reward batch of its engines."""

    def __init__(self, monkeypatch, module, trainer_cls, engine_cls,
                 check=None):
        self.updates, self.batches = [], []
        rec, orig = self, trainer_cls._batched_rl_update

        def update(tr, *a, **k):
            before = (tr.params, tr.opt_state, tr.episode)
            ts = orig(tr, *a, **k)
            rec.updates.append((tr, np.array(ts), tr.opt_state))
            if check is not None:
                check(tr, before)
            return ts

        class Engine(engine_cls):
            def exec_times(self, assignments, episode=0):
                rec.batches.append(np.array(assignments))
                return super().exec_times(assignments, episode)

        monkeypatch.setattr(trainer_cls, "_batched_rl_update", update)
        monkeypatch.setattr(module, "SimRewardEngine", Engine)


def test_pretrain_matches_reference(monkeypatch):
    """Every Stage II update of the port is held against the reference's
    functions on the port's pre-update state (``assert_step_matches_
    reference``: loss 1e-5, gradient 5e-6, the AdamW step within lr /
    100), as ``tests/test_torch_stage2.py`` holds a trainer's; at
    pretraining's lr (3e-3) a gradient near zero that takes the other
    sign moves a parameter by 2 lr, so whole-trajectory params carry no
    tighter bar than that."""
    seed = 0
    jrec = _Recorder(monkeypatch, jax_training, jax_training.DopplerTrainer,
                     JaxSimRewardEngine)
    want = jax_training.pretrain(micro_tasks(False), seed=seed, **MICRO)

    def check(pt, before):
        jt = jrec.updates[len(prec.updates) - 1][0]
        acts = np.asarray(pt.last_update["actions"])
        advs = np.asarray(pt.last_update["advantages"])
        keys = jax.random.split(jax.random.PRNGKey(0), len(acts))
        assert_step_matches_reference(
            pt, jt, before, lambda p: jax_training._pg_loss_and_grad_batch(
                p, jt.gd, keys, jnp.asarray(acts), jnp.asarray(advs),
                jnp.float32(jt.entropy_weight),
                sel_learned=True, plc_learned=True,
                encoder_backend=jt.encoder_backend))
        # the moments: the reference's AdamW on the port's pre-step state
        params0, state0, episode0 = before

        def ref(tree):
            return as_reference_tree(tree, jt.params)
        _, want_state = jax_optim.adamw_update(
            ref(pt.last_update["grads"]), jax_optim.AdamState(
                jnp.int32(state0.step), ref(state0.mu), ref(state0.nu)),
            ref(params0), jt.lr_sched(episode0))
        assert_grads_close(pt.opt_state.mu, want_state.mu, GRAD_TOL,
                           scaled=True)
        assert_grads_close(pt.opt_state.nu, want_state.nu, GRAD_TOL,
                           scaled=True)

    prec = _Recorder(monkeypatch, training, training.DopplerTrainer,
                     SimRewardEngine, check)
    jinit = to_numpy_params(jax_init_policies(
        jax.random.PRNGKey(seed), d_hidden=16, d_z=8, d_y=8, gnn_layers=2))
    monkeypatch.setattr(training, "init_policies",
                        lambda *a, **k: params_from_numpy(jinit))
    tasks = micro_tasks(True)
    chains = [trainer_chain_draws(seed + i, MICRO["batch_size"], t.graph.n,
                                  t.dev.n, MICRO["imitation_episodes"],
                                  MICRO["rounds"])
              for i, t in enumerate(tasks)]
    got = training.pretrain(tasks, seed=seed, device="cpu", draws=chains,
                            **MICRO)

    assert set(got) == {"params", "meta", "per_task"}
    assert got["meta"] == want["meta"]
    assert got["per_task"] == want["per_task"]
    assert len(prec.batches) == len(jrec.batches) == 4
    for a, b in zip(prec.batches, jrec.batches):
        assert np.array_equal(a, b)
    for (pt, ts, opt), (jt, jts, jopt) in zip(prec.updates, jrec.updates):
        assert np.array_equal(ts, jts)              # bit-identical rewards
        assert int(opt.step) == int(jopt.step)
    for (pt, _, _), (jt, _, _) in zip(prec.updates[-2:],
                                      jrec.updates[-2:]):
        assert pt.history == [training.EpisodeRecord(**vars(h))
                              for h in jt.history]
        assert (pt._r_sum, pt._r_sqsum, pt._r_count) == (
            jt._r_sum, jt._r_sqsum, jt._r_count)
        assert np.array_equal(pt.best_assignment, jt.best_assignment)


def test_pretrain_returns_shared_params_and_stats():
    pre = training.pretrain(micro_tasks(True), device="cpu",
                            **dict(MICRO, rounds=1))
    assert set(pre) == {"params", "meta", "per_task"}
    assert pre["meta"]["tasks"] == ["chain|u4", "diamond|mixed"]
    assert all(np.isfinite(v["best_time"]) and v["best_time"] > 0
               for v in pre["per_task"].values())
    assert all(x.device.type == "cpu" for x in tree_leaves(pre["params"]))
    with pytest.raises(ValueError):
        training.pretrain([], device="cpu")


@pytest.mark.parametrize("n_synthetic,seed", [(4, 0), (3, 5)])
def test_zoo_pretrain_tasks_synthetic_half_matches_reference(n_synthetic,
                                                             seed):
    got = training.zoo_pretrain_tasks(holdout=ARCH_IDS,
                                      n_synthetic=n_synthetic, seed=seed)
    want = jax_training.zoo_pretrain_tasks(holdout=JAX_ARCH_IDS,
                                           n_synthetic=n_synthetic,
                                           seed=seed)
    assert [t.name for t in got] == [t.name for t in want]
    for p, j in zip(got, want):
        assert np.array_equal(p.graph.edge_array(), j.graph.edge_array())
        assert np.array_equal(p.graph.flops_array(), j.graph.flops_array())
        assert np.array_equal(p.graph.out_bytes_array(),
                              j.graph.out_bytes_array())
        assert p.dev.fingerprint() == j.dev.fingerprint()
        assert p.noise_sigma == j.noise_sigma == 0.0


def test_zoo_pretrain_tasks_model_half_waits_for_the_importer():
    """The importer has landed: ``archs`` empty means every architecture,
    as in the reference (``archs or ARCH_IDS``), each its ``model:<arch>``
    layer at ``seq``; ``holdout`` drops an architecture end to end."""
    tasks = training.zoo_pretrain_tasks(archs=(), n_synthetic=0, seq=16)
    assert [t.name.split("|")[0] for t in tasks] == list(ARCH_IDS)
    assert [t.graph.name for t in tasks] == [f"model:{a}" for a in ARCH_IDS]
    tasks = training.zoo_pretrain_tasks(archs=("gemma_2b", "olmo_1b"),
                                        holdout=("olmo_1b",), seq=16)
    assert [t.name.split("|")[0] for t in tasks][:1] == ["gemma_2b"]
    tasks = training.zoo_pretrain_tasks(archs=("olmo_1b",),
                                        holdout=("olmo_1b",), n_synthetic=2)
    assert sum(t.name.startswith("synth") for t in tasks) == 2


@pytest.mark.parametrize("archs,holdout", [(None, ("gemma_2b",)),
                                           (("olmo_1b", "zamba2_1p2b"), ())])
def test_zoo_pretrain_tasks_model_half_matches_reference(archs, holdout):
    """The reference's names, fleets and order; each graph the port's
    import of the same layer (vertex count within the zoo parity's 15%)."""
    got = training.zoo_pretrain_tasks(archs=archs, holdout=holdout, seq=16,
                                      n_synthetic=2)
    want = jax_training.zoo_pretrain_tasks(archs=archs, holdout=holdout,
                                           seq=16, n_synthetic=2)
    assert [t.name for t in got] == [t.name for t in want]
    for p, j in zip(got, want):
        assert p.dev.fingerprint() == j.dev.fingerprint()
        assert p.graph.name == j.graph.name
        assert p.graph.n == pytest.approx(j.graph.n, rel=0.15)


# --------------------------------------------------------------- transfer
def test_transfer_api(diamond):
    """The reference's ``test_transfer_api``
    (``tests/test_core_policies.py``) on the port."""
    g = port_graph(diamond)
    dev4 = uniform_box(4)
    src = training.DopplerTrainer(g, dev4, seed=3, d_hidden=32,
                                  total_episodes=50, device="cpu")
    src.stage2_sim(5, WCSimulator(g, dev4))
    g2 = port_graph(random_dag(np.random.default_rng(0), 20))
    dst = training.transfer(src, g2, dev4, seed=4, d_hidden=32,
                            total_episodes=50, device="cpu")
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(tree_leaves(dst.params), tree_leaves(src.params)))
    assert int(dst.opt_state.step) == 0
    assert all(float(m.abs().max()) == 0.0
               for m in tree_leaves(dst.opt_state.mu))
    dst.stage2_sim(5, WCSimulator(g2, dev4))
    assert dst.best_assignment is not None


# ------------------------------------------------------------------ fleet
def fleet_pair(n_replicas=3, **kw):
    """(reference, port) ``FleetTrainer`` on the diamond x 4 devices with
    the same params."""
    dj = make_diamond()
    jf = jax_training.FleetTrainer({"blk": dj}, jax_uniform_box(4),
                                   n_replicas=n_replicas, seed=0,
                                   d_hidden=16, **kw)
    pf = training.FleetTrainer({"blk": port_graph(dj)}, uniform_box(4),
                               n_replicas=n_replicas, seed=0, d_hidden=16,
                               device="cpu", **kw)
    pf.trainers["blk"].params = params_from_numpy(
        to_numpy_params(jf.trainers["blk"].params))
    return jf, pf


def test_fleet_exec_time_bit_equal_to_reference():
    jf, pf = fleet_pair(n_replicas=4, total_episodes=50)
    a = np.arange(jf.trainers["blk"].g.n) % 4
    for engine in ("batched", "serial"):
        got = pf.fleet_exec_time("blk", a, episode=7, sim_engine=engine)
        assert got == jf.fleet_exec_time("blk", a, episode=7,
                                         sim_engine=engine)
    # the reference's test_fleet_exec_time_batched_matches_serial
    assert got == pf.fleet_exec_time("blk", a, episode=7)


def test_fleet_train_matches_reference():
    """``train(10, batch_size=4)`` (updates of 4, 4, 2) on the draws of
    the reference trainer's key chain: the same history, best time and
    best assignment."""
    jf, pf = fleet_pair(**EPS02)
    n = jf.trainers["blk"].g.n
    # each update splits the next key of the chain, whatever its K
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    draws = []
    for K in (4, 4, 2):
        key, sub = jax.random.split(key)
        draws.append(reference_draws(jax.random.split(sub, K), n, 4))
    jf.train(10, batch_size=4)
    pf.train(10, batch_size=4, draws={"blk": draws})
    jt, pt = jf.trainers["blk"], pf.trainers["blk"]
    assert pt.history == [training.EpisodeRecord(**vars(h))
                          for h in jt.history]
    assert pt.best_time == jt.best_time
    assert np.array_equal(pf.assignments()["blk"], jf.assignments()["blk"])
    assert_params_close(pt, jt)


def test_fleet_trainer_runs_and_batches():
    """The reference's ``test_fleet_trainer`` and
    ``test_fleet_train_batched_matches_episode_budget``
    (``tests/test_core_policies.py``, ``tests/test_train_fused.py``)."""
    _, pf = fleet_pair(total_episodes=20)
    pf.train(4)
    assert pf.assignments()["blk"] is not None
    _, pf = fleet_pair(total_episodes=60)
    pf.train(10, batch_size=4)
    tr = pf.trainers["blk"]
    assert tr.episode == 10
    assert [h.stage for h in tr.history] == ["fleet"] * 3      # 4+4+2
    assert tr.best_assignment is not None
