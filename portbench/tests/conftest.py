"""The benchmark's own tests: run from the root of a checkout with
``python3 -m pytest -q portbench/tests`` (``-m gpu`` for those that need a
card). The program is imported from ``src/``; the tuner's cache is pointed
at a temporary file, so no test reads or writes the user's."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(autouse=True)
def _private_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("RAPIDRAID_TUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("RAPIDRAID_TUNE", raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: a cell's sizes in the CPU tests: blocks of 1024 words, small pools and batches
TINY = {"block_words": 1024, "pool_objects": 6, "batch": 4, "check_calls": 2}
CELLS = ("rr16-archive-16", "rr16-restore-1", "rr16-repair-16")


def metric_names(cell, kind):
    """The names of the ``kind`` metrics (``end_to_end`` or ``per_layer``) that
    ``cell`` reports, from the manifest."""
    import json
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {e["name"] for e in m[kind] if cell in e.get("workloads", [cell])}


def cpu_run(cell, seed=2**31 + 5, seconds=0.2, trace=False, mode="program"):
    """One run of ``cell`` at the tiny size on the CPU, the card's check skipped."""
    import time

    import torch

    from portbench import harness
    return harness.run_cell(cell, seed, seconds, trace, t_start=time.perf_counter(),
                            device=torch.device("cpu"), mode=mode, overrides=dict(TINY))
