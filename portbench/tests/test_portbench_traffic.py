"""Each traffic driver and the plain reference through a whole run of its
cell, at a tiny size on the CPU (the program's plain PyTorch path), the
card's check skipped: the program comes out correct, the control does not."""
import json
import subprocess
import sys

import pytest
import torch
from conftest import CELLS, ROOT, TINY, cpu_run, metric_names

from portbench import harness


@pytest.mark.parametrize("cell", CELLS)
def test_program_run_is_correct(cell):
    r = cpu_run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["notes"]
    assert r["checks"]["wrong_words"] == {"value": 0, "limit": 0}
    assert set(r["metrics"]) == metric_names(cell, "end_to_end")
    assert list(r)[-2:] == ["checks", "notes"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = cpu_run(cell, mode="control")
    assert not r["correct"] and r["checks"]["wrong_words"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_what_it_can_read(cell):
    r = cpu_run(cell, seconds=0.3, trace=True)
    assert r["correct"]
    # no card here: the trace has no device operation, so only the host's metric
    assert set(r["metrics"]) == {m for m in metric_names(cell, "per_layer")
                                 if m.startswith("dispatch_ms")}


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    from portbench import driver as driver_lib
    spec = harness.Spec(cell, overrides=dict(TINY))
    mods = harness.load_module("traffic", spec.params["op"]), harness.load_module(
        "reference", spec.cfg["reference"])
    harness.import_program()

    def first_input(seed):
        drv = mods[0].prepare(driver_lib.Cell(spec.cfg, spec.params, seed, torch.device("cpu"),
                                              mods[1]))
        return drv.call(0).view(torch.int16).clone(), drv.cycle

    a, b, c = first_input(2**31 + 9), first_input(2**31 + 9), first_input(7)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    assert not torch.equal(a[0], c[0]) and sorted(a[1]) == sorted(c[1])


def test_reservoir_keeps_a_uniform_seeded_sample():
    counts = [0] * 10
    for seed in range(2000):
        r = harness.Reservoir(2, seed)
        for i in range(10):
            r.offer(i, None)
        for i, _ in r.kept:
            counts[i] += 1
    assert min(counts) > 300 and max(counts) < 500      # 400 expected each


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rr16-restore-1",
                        "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                            "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is visible to this process")
    assert p.returncode == 2 and p.stdout == "" and "no CUDA device" in p.stderr


def test_import_program_refuses_a_checkout_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(harness.SetupError):
        harness.import_program()


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro.core"]


def test_result_line_shape():
    r = cpu_run("rr16-restore-1")
    r.pop("notes")
    line = json.loads(json.dumps(r))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
