"""The port's entry points on the CPU: the three-stage training CLI
(``launch/doppler_train.py``) once per Stage II engine and with the
supervisor, the hierarchy, the executor, checkpoints and the trace;
its CP and EnumOpt line against the reference CLI's on the same
arguments; ``core/trace.py`` against the reference's on one schedule;
and ``launch/place_server.py``'s ``main``.
"""
import json

import numpy as np
import pytest

from conftest import make_diamond
from repro.core.devices import uniform_box as jax_uniform_box
from repro.core.simulator import WCSimulator as JaxWCSimulator
from repro.core.trace import schedule_to_events as jax_schedule_to_events
from repro.core.trace import utilization_ascii as jax_utilization_ascii
from repro.launch import doppler_train as jax_doppler_train
from repro_torch.core.devices import uniform_box
from repro_torch.core.heuristics import critical_path_assignment
from repro_torch.core.simulator import WCSimulator
from repro_torch.core.trace import (schedule_to_events, utilization_ascii,
                                    write_chrome_trace)
from repro_torch.graphs.workloads import get_workload
from repro_torch.launch import doppler_train, place_server
from test_torch_pretrain import one_thread_a_process  # noqa: F401
from test_torch_train import port_graph

BASE = ["--graph", "chainmm", "--devices", "p100x4", "--stage1", "2",
        "--stage2", "2", "--stage2-batch", "4", "--stage3", "1",
        "--stage3-batch", "2"]
CPU = ["--device", "cpu"]


def _run(capsys, argv) -> list[str]:
    doppler_train.main(argv + CPU)
    return capsys.readouterr().out.splitlines()


def _cp_line(lines) -> str:
    return next(l for l in lines if l.startswith("chainmm on p100x4: CP="))


@pytest.mark.parametrize("engine", ["serial", "batched", "oracle", "fused"])
def test_cli_runs_each_engine(capsys, engine):
    lines = _run(capsys, BASE + ["--engine", engine])
    assert lines[0].startswith("chainmm on p100x4: CP=")
    assert " EnumOpt=" in lines[0]
    assert any(l.startswith("stage I : imitation NLL") for l in lines)
    best = next(l for l in lines if l.startswith("DOPPLER best: "))
    assert "% vs CP)" in best
    assert lines[-1].startswith("makespan ")


def test_cli_cp_and_enumopt_line_equals_reference(capsys):
    argv = ["--graph", "chainmm", "--devices", "p100x4", "--stage1", "0",
            "--stage2", "0", "--stage3", "0"]
    jax_doppler_train.main(argv)
    want = _cp_line(capsys.readouterr().out.splitlines())
    assert _cp_line(_run(capsys, argv)) == want


def test_cli_checkpoints_resume_trace_and_executor(capsys, tmp_path):
    ck, trace = tmp_path / "ck", tmp_path / "trace.json"
    lines = _run(capsys, BASE + [
        "--engine", "batched", "--system", "executor", "--calibrate",
        "--ckpt-dir", str(ck), "--trace", str(trace)])
    assert lines[0].startswith("calibrated p100x4 from ")
    saved = [l for l in lines if "checkpoint saved" in l]
    assert [l.split("]")[0] for l in saved] == ["[stage1", "[stage2",
                                                "[stage3"]
    assert saved[-1].endswith("step_000000012")
    events = json.loads(trace.read_text())["traceEvents"]
    n = sum(e.get("pid") == 0 and e["ph"] == "X" for e in events)
    g = get_workload("chainmm")
    assert n == g.n - int(g.input_mask().sum())    # one a compute vertex
    lines = _run(capsys, BASE[:4] + [
        "--stage1", "0", "--stage2", "1", "--stage2-batch", "4",
        "--engine", "oracle", "--stage3", "0", "--ckpt-dir", str(ck),
        "--resume"])
    assert lines[0] == "resumed at episode 12"
    assert lines[-1].startswith("makespan ")
    assert any("step_000000016" in l for l in lines)


def test_cli_events_run_under_the_supervisor(capsys):
    lines = _run(capsys, BASE[:4] + [
        "--stage1", "1", "--stage2", "4", "--stage2-batch", "4",
        "--stage3", "0", "--events", "2:loss:1"])
    # the supervisor's event lines in order; a straggler line (a step over
    # 3x the median wall time, which a loaded host can produce) is skipped
    sup = [l for l in lines if l.startswith("[supervisor] ")
           and not l.startswith("[supervisor] straggler@")]
    assert sup[0].startswith("[supervisor] recover@2: ")
    assert sup[1].startswith("[supervisor] replace@2: kind=device_loss")
    assert any(l.startswith("stage II : 4 supervised updates, 1 recoveries, "
                            "1 re-placements; fleet now p100x4-loss1 "
                            "(3 devices)") for l in lines)
    assert any(l.startswith("post-event CP baseline on p100x4-loss1: ")
               for l in lines)
    assert sum(l.startswith("dev") for l in lines) == 3
    with pytest.raises(SystemExit):
        doppler_train.main(BASE[:4] + ["--stage1", "0", "--system",
                                       "executor", "--events", "1:loss:1"]
                           + CPU)


def test_cli_hierarchy(capsys):
    lines = _run(capsys, BASE[:4] + [
        "--stage1", "1", "--stage2", "1", "--stage2-batch", "4",
        "--stage3", "1", "--stage3-batch", "2", "--hierarchy", "16",
        "--engine", "fused"])
    assert lines[0].startswith("hierarchy: 72-vertex graph -> ")
    assert any(l.startswith("DOPPLER best: ") for l in lines)


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert doppler_train.build_parser().parse_args(
        ["--graph", "ffnn"]).device == "cuda"
    with pytest.raises(RuntimeError):
        doppler_train.main(["--graph", "chainmm"])


def test_trace_matches_reference():
    gj, devj = make_diamond(), jax_uniform_box(4)
    g, dev = port_graph(gj), uniform_box(4)
    a = critical_path_assignment(g, dev, seed=1)
    res = WCSimulator(g, dev, noise_sigma=0.05).run(a, seed=3, record=True)
    want = JaxWCSimulator(gj, devj, noise_sigma=0.05).run(a, seed=3,
                                                          record=True)
    assert schedule_to_events(res, g) == jax_schedule_to_events(want, gj)
    assert utilization_ascii(res) == jax_utilization_ascii(want)
    assert utilization_ascii(res, 20) == jax_utilization_ascii(want, 20)


def test_write_chrome_trace(tmp_path):
    g, dev = port_graph(make_diamond()), uniform_box(4)
    res = WCSimulator(g, dev).run(np.arange(g.n) % 4, record=True)
    write_chrome_trace(str(tmp_path / "t.json"), res, g)
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert doc["traceEvents"][2:] == schedule_to_events(res, g)


def test_place_server_main_on_the_cpu(capsys):
    place_server.main(["--workload", "llama_block", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[0] llama_block on mixed_gen4: makespan=")
    assert "cache_hit=False" in out[0] and "cache_hit=True" in out[1]
    assert out[-1] == "server stats: {'hits': 1, 'misses': 1, 'cached': 1}"
    with pytest.raises(NotImplementedError):
        place_server.main(["--workload", "model:olmo_1b", "--device", "cpu"])
