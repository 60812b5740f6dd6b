"""The four-card cell ``rr16-archive-placed-4chip``: its traffic driver
(``traffic/archive_placed.py``) and its per-layer metric
(``metrics/hop_ms_per_call.py``). On the CPU the cell's four cards are the
one CPU device, at the tests' tiny size: the program comes out correct,
the control does not, the pool is the seed's and its replicas agree.
Marked ``gpu``: the cell through ``run.py`` on four cards, as the
benchmark's check runs it; skips with fewer than four."""
import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, TINY, cpu_run, metric_names

from portbench import harness

CELL = "rr16-archive-placed-4chip"


def prepared(seed):
    """The cell's driver at the tiny size on the CPU."""
    spec = harness.Spec(CELL, overrides=dict(TINY))
    harness.import_program()
    return harness.prepare(spec, seed, [torch.device("cpu")])


def test_program_run_is_correct():
    r = cpu_run(CELL)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["notes"]
    assert r["checks"]["wrong_words"] == {"value": 0, "limit": 0}
    assert set(r["metrics"]) == metric_names(CELL, "end_to_end")


def test_control_is_not_correct():
    r = cpu_run(CELL, mode="control")
    assert not r["correct"] and r["checks"]["wrong_words"]["value"] > 0


def test_traced_run_reports_dispatch_only():
    r = cpu_run(CELL, seconds=0.3, trace=True)
    assert r["correct"]
    # no card here: no device operation, so no peer copy and only the host's metric
    assert set(r["metrics"]) == {"dispatch_ms"}


def test_pool_is_the_seeds_and_its_replicas_agree():
    a, b, c = prepared(2**31 + 9), prepared(2**31 + 9), prepared(7)
    assert [len(blk) for blk in a.blocks] == [4, 7, 7, 4]
    assert a.cards == [torch.device("cpu")] * 4       # the four cards are one device here
    assert a.cycle == b.cycle and sorted(a.cycle) == sorted(c.cycle)
    for pa, pb, pc in zip(a.pools, b.pools, c.pools):
        assert torch.equal(pa.view(torch.int16), pb.view(torch.int16))
        assert not torch.equal(pa.view(torch.int16), pc.view(torch.int16))
    for j in range(a.cell.k):
        copies = [a.pools[c][:, a.blocks[c].index(j)] for c in range(4) if j in a.blocks[c]]
        assert len(copies) == 2            # two replicas, on two cards
        assert torch.equal(copies[0].view(torch.int16), copies[1].view(torch.int16))


def test_check_counts_rows_off_their_card_wrong():
    drv = prepared(2**31 + 5)
    out = drv.call(0)
    wrong, words = drv.check(0, out)
    assert wrong == 0 and words == drv.objects * drv.cell.n * drv.cell.words
    wrong, _ = drv.check(0, out[:3])
    assert wrong == drv.objects * drv.m * drv.cell.words


class Run:
    def __init__(self, trace):
        self.trace = trace


def breakdown(ops, calls=4):
    return {"calls": calls, "breakdown": {"device_ops": ops, "idle_gaps": []}}


def test_hop_ms_per_call_reads_peer_copies_only():
    read = harness.load_module("metrics", "hop_ms_per_call").read
    assert read(Run(None)) is None
    assert read(Run(breakdown([["chain_tick_kernel<16, 2>", 0.5]]))) is None
    ops = [["chain_tick_kernel<16, 2>", 0.5], ["Memcpy PtoP", 0.032],
           ["Memset (Device)", 0.001]]
    assert read(Run(breakdown(ops))) == pytest.approx(8.0)      # 32 card-ms over 4 calls


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_four_cards(trace):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL,
                        "--seed", str(2**31 + 201 + trace), "--seconds", "2",
                        "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["device"]["count"] == 4
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert set(r["metrics"]) == metric_names(CELL, "per_layer")
        assert r["metrics"]["hop_ms_per_call"]["value"] > 0
        for name, m in r["metrics"].items():
            if "roofline" in name:
                assert 0 < m["value"] <= 100
    else:
        assert set(r["metrics"]) == metric_names(CELL, "end_to_end")
