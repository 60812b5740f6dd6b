"""On the card: each cell through ``run.py`` as the benchmark's check runs
it, a short window, untraced and traced. Marked ``gpu``; run with
``python3 -m pytest -q -m gpu portbench/tests`` on a machine with a card."""
import json
import subprocess
import sys

import pytest
import torch
from conftest import CELLS, ROOT, metric_names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                        "--seed", str(2**31 + 101 + trace), "--seconds", "2",
                        "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["device"]["platform"] == "gpu"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert set(r["metrics"]) == metric_names(cell, "per_layer")
        for name, m in r["metrics"].items():
            if "roofline" in name:
                assert 0 < m["value"] <= 100
    else:
        assert set(r["metrics"]) == metric_names(cell, "end_to_end")
