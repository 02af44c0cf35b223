"""One placement request end to end on the CPU, port vs the JAX path.

The same carried-over parameters and the same injected draws go through
the port's ``DopplerTrainer.place`` (encode once, greedy + sampled
population, one oracle batch) and through the JAX path: the reference
``DopplerTrainer``'s greedy rollout, ``rollout_batch`` (eps=0) or
``train_fused.sample_episodes`` (eps=0.2) on the same keys, scored by
``JaxWCEngine``.  Greedy assignment, population, makespans and the
scored best must all be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.assign import rollout_batch as jax_rollout_batch
from repro.core.devices import get_device_model as jax_fleet
from repro.core.sim_jax import JaxWCEngine
from repro.core.train_fused import _episode_rng_tables, sample_episodes
from repro.core.training import DopplerTrainer as JaxTrainer
from repro.core.zero_shot import to_numpy_params
from repro.graphs import workloads as jax_workloads
from repro_torch.core.devices import get_device_model
from repro_torch.core.sim_torch import TorchWCEngine
from repro_torch.core.training import DopplerTrainer
from repro_torch.graphs import workloads
from repro_torch.models.convert import params_from_numpy

K = 8


def _pair(gname, args, fleet, d_hidden=16):
    gj = getattr(jax_workloads, gname)(*args)
    g = getattr(workloads, gname)(*args)
    jt = JaxTrainer(gj, jax_fleet(fleet), seed=0, d_hidden=d_hidden)
    pt = DopplerTrainer(g, get_device_model(fleet), seed=0,
                        d_hidden=d_hidden, device="cpu",
                        encoder_backend="torch", oracle_backend="torch")
    pt.params = params_from_numpy(to_numpy_params(jt.params))
    return gj, jt, pt


@pytest.mark.parametrize("gname,args,fleet,eps", [
    ("synthetic_layered", (3, 4), "p100x4", 0.0),
    ("synthetic_layered", (3, 4), "mixed_gen4", 0.2),
    ("chainmm", (), "p100x4", 0.2),
])
def test_placement_request_matches_jax_path(gname, args, fleet, eps):
    gj, jt, pt = _pair(gname, args, fleet)
    keys = jax.random.split(jax.random.PRNGKey(11), K)
    draws = [np.array(x) for x in _episode_rng_tables(keys, gj.n, pt.dev.n)]
    greedy_j = jt.greedy_assignment()
    if eps == 0.0:
        pop_j = jax_rollout_batch(jt.params, jt.gd, keys, jnp.float32(0.0))
    else:
        pop_j = sample_episodes(jt.params, jt.gd, keys, jnp.float32(eps))
    cands = np.concatenate([greedy_j[None],
                            np.asarray(pop_j["assignment"])])
    ms_j = JaxWCEngine(gj, jax_fleet(fleet)).run_batch(cands)
    best = int(ms_j.argmin())

    pl = pt.place(n_samples=K, eps=eps, draws=draws)
    assert np.array_equal(pl.greedy, greedy_j)
    assert np.array_equal(pl.population, np.asarray(pop_j["assignment"]))
    assert np.array_equal(pl.makespans, ms_j)
    assert np.array_equal(pl.assignment, cands[best])
    assert pl.makespan == float(ms_j[best])
    assert set(pl.seconds) == {"encode", "rollout", "oracle"}
    # the trainer keeps the best; evaluate scores it with the same oracle
    assert np.array_equal(pt.best_assignment, cands[best])
    assert pt.evaluate() == (pl.makespan, 0.0, pt.best_assignment)


def test_flat_place_scores_greedy_then_keeps_best():
    """n_samples=0 is the reference's flat place(): the greedy assignment
    scored; a later request pools the best so far."""
    g = workloads.chainmm()
    dev = get_device_model("p100x4")
    pt = DopplerTrainer(g, dev, seed=3, d_hidden=16, device="cpu")
    assert (pt.encoder_backend, pt.oracle_backend) == ("torch", "torch")
    first = pt.place()
    eng = TorchWCEngine(g, dev, backend="torch", device="cpu")
    assert np.array_equal(first.assignment, pt.greedy_assignment())
    assert first.makespan == eng.exec_time(first.assignment)
    assert first.population.shape == (0, g.n)
    second = pt.place(n_samples=4)            # draws from the generator
    assert second.population.shape == (4, g.n)
    assert second.makespan <= first.makespan
    assert second.makespan == min(first.makespan, second.makespans.min())
    a, actions = pt.sample_assignment()
    assert sorted(actions[:, 0].tolist()) == list(range(g.n))
    assert np.array_equal(a[actions[:, 0]], actions[:, 1])


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DopplerTrainer(workloads.chainmm(), get_device_model("p100x4"),
                       d_hidden=16, device="cuda")
    with pytest.raises(ValueError):
        DopplerTrainer(workloads.chainmm(), get_device_model("p100x4"),
                       d_hidden=16, device="cpu", oracle_backend="xla")
