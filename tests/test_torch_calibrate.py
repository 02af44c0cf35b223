"""The port's sim-to-real calibration (``repro_torch.core.calibrate``, a
copy of the numpy-only reference module) against the reference.

* ``calibrate_fleet(base, simulator_measure(truth))`` fits the same fleet
  as the reference, bit for bit, on ``tests/test_calibrate.py``'s cases
  (noise-free, noisy median-of-repeats, links skipped, the chain-length
  check), on the port's copied ``WCSimulator``.
* ``executor_measure`` runs end to end on the port's executor on the CPU.
* A calibrated fleet whose link bandwidths hit the fit's 1e-18 clamp (a
  host whose copies are free: the differenced link probes read 0) is
  scored by the oracle (``TorchWCEngine``, plain backend) as by the
  numpy ``WCSimulator`` on the fifo schedule, and bit for bit as by the
  JAX oracle: the fleet Stage II trains on before Stage III.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import calibrate as jax_calibrate
from repro.core import sim_jax
from repro.core.devices import DeviceModel as JaxDeviceModel
from repro.core.devices import scale_fleet as jax_scale_fleet
from repro.core.devices import uniform_box as jax_uniform_box
from repro.graphs import workloads as jax_workloads
from repro_torch.core import calibrate
from repro_torch.core.devices import DeviceModel, scale_fleet, uniform_box
from repro_torch.core.heuristics import critical_path_assignment
from repro_torch.core.sim_torch import TorchWCEngine
from repro_torch.core.simulator import WCSimulator
from test_torch_train import port_graph


def perturbed_truth(uniform, scale, nd: int = 4):
    """``tests/test_calibrate.py``'s hidden fleet, built with either
    package's constructors."""
    base = uniform(nd)
    truth = scale(base, speed=[1.0, 0.6, 1.5, 0.9][:nd], name="truth")
    truth.exec_overhead = np.array([4e-6, 9e-6, 5.5e-6, 7e-6][:nd])
    bw = truth.link_bw.copy()
    bw[0, 1], bw[1, 0] = 20e9, 35e9          # asymmetric pair
    bw[2, 3] = 10e9
    truth.link_bw = bw
    return base, truth


def assert_same_fit(got, want):
    for field in ("exec_overhead", "flops_per_sec", "link_bw"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), \
            field
    for field in dataclasses.fields(want.fleet):
        a = getattr(got.fleet, field.name)
        b = getattr(want.fleet, field.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), field.name
    assert got.residuals == want.residuals
    assert got.n_measurements == want.n_measurements
    assert got.rel_residual == want.rel_residual


CASES = {
    "noise_free": (dict(), dict()),
    "noisy": (dict(noise_sigma=0.01, repeats=9), dict()),
    "links_skipped": (dict(), dict(fit_links=False)),
    "short_chain_bytes": (dict(), dict(chain_len=8,
                                       probe_bytes=(1e5, 4e5))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_calibration_matches_reference_bit_for_bit(case):
    measure_kw, fit_kw = CASES[case]
    base_j, truth_j = perturbed_truth(jax_uniform_box, jax_scale_fleet)
    base, truth = perturbed_truth(uniform_box, scale_fleet)
    want = jax_calibrate.calibrate_fleet(
        base_j, jax_calibrate.simulator_measure(truth_j, **measure_kw),
        **fit_kw)
    got = calibrate.calibrate_fleet(
        base, calibrate.simulator_measure(truth, **measure_kw), **fit_kw)
    assert isinstance(got.fleet, DeviceModel)
    assert_same_fit(got, want)
    if case == "noise_free":
        assert got.rel_residual < 1e-6 and got.fleet.heterogeneous


def test_probe_chain_and_chain_len_check():
    g, gj = (calibrate.probe_chain(6, flops=1e6, nbytes=512.0),
             jax_calibrate.probe_chain(6, flops=1e6, nbytes=512.0))
    assert g.n == 7 and g.is_input(0)
    assert g.edges == gj.edges and [v.flops for v in g.vertices] == \
        [v.flops for v in gj.vertices]
    base, truth = perturbed_truth(uniform_box, scale_fleet)
    with pytest.raises(ValueError):
        calibrate.calibrate_fleet(base, calibrate.simulator_measure(truth),
                                  chain_len=7)


def test_executor_measure_runs_end_to_end():
    """The port's executor as the measurement oracle on the CPU: a usable
    (noisy) fit, positive overheads, finite rates, every residual."""
    cal = calibrate.calibrate_fleet(uniform_box(2), calibrate.executor_measure(
        2, repeats=3, flops_scale=1e-6, bytes_scale=1e-6, devices=["cpu"]),
        chain_len=8)
    assert (cal.exec_overhead >= 0).all()
    assert np.isfinite(cal.flops_per_sec).all()
    assert {"device", "link", "overall"} <= set(cal.residuals)
    assert cal.n_measurements == 2 * 3 + 2 * 2
    assert cal.fleet.name == "uniform2_calibrated" or \
        cal.fleet.name.endswith("_calibrated")


def _free_links(truth):
    """``truth`` with every link free: copies cost nothing."""
    return dataclasses.replace(
        truth, link_bw=np.full_like(truth.link_bw, np.inf),
        link_latency=np.zeros_like(truth.link_latency))


# graphs on which the float32 oracle's fifo tie-breaks (JAX and port
# alike) leave the float64 serial engine on a random row of the clamped
# fleet (1.2% on one row of llama_layer): the reference's gap, ROADMAP C3
CLAMP_F32_GAP = {"llama_layer"}


@pytest.mark.parametrize("gname", ["ffnn", "llama_block", "llama_layer"])
def test_clamped_calibrated_fleet_in_the_oracle(gname):
    base, truth = perturbed_truth(uniform_box, scale_fleet)
    cal = calibrate.calibrate_fleet(base, calibrate.simulator_measure(
        _free_links(truth)))
    off = ~np.eye(base.n, dtype=bool)
    assert (cal.link_bw[off] == 1.0 / 1e-18).all()    # the 1e-18 clamp
    gj = jax_workloads.get_workload(gname)
    g = port_graph(gj)
    rng = np.random.default_rng(0)
    A = np.concatenate([critical_path_assignment(g, cal.fleet, seed=0)[None],
                        rng.integers(0, base.n, size=(15, g.n))])
    got = TorchWCEngine(g, cal.fleet, backend="torch",
                        device="cpu").run_batch(A)
    fleet_j = JaxDeviceModel(**{f.name: getattr(cal.fleet, f.name)
                                for f in dataclasses.fields(cal.fleet)})
    want = sim_jax.JaxWCEngine(gj, fleet_j).run_batch(A)
    assert np.array_equal(got, np.asarray(want))
    sim = WCSimulator(g, cal.fleet, choose="fifo", noise_sigma=0.0)
    rel = np.abs(got - sim.run_batch(A)[:, 0]) / sim.run_batch(A)[:, 0]
    assert rel[0] <= 1e-4                               # CRITICAL PATH
    if gname in CLAMP_F32_GAP:
        assert rel.max() > 1e-4
    else:
        assert rel.max() <= 1e-4
