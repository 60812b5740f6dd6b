"""On four cards: a test-only cell of four cards, defined here and not in
``BENCHMARK.json``, through ``harness.run_cell``. Each card archives its own
objects through the program's unplaced ``pipelined_encode_many``; card 3
first sleeps on its stream for ``LATE_MS``, so its work ends long after the
others'. The call's time has to cover that late work, the peak has to be
the fullest card's, the idle share each card's, and ``correct`` has to
hold. Marked ``gpu``; skips with fewer than four cards."""
import ast
import re
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.driver import differing

NAME = "test-archive-4card"
SHARE = (4, 7, 7, 4)     # objects a card holds, as placement_slots' 4/7/7/4 blocks
BATCH = 2                # objects each card archives a call
LATE_MS = 30.0           # how long card 3 sleeps before its share


class FourCards(harness.Spec):
    """The test-only cell: ``rr16-archive-16``'s configuration at blocks of
    2^18 words and its metrics, on four cards, with this module as its
    traffic."""

    def __init__(self):
        base = harness.Spec("rr16-archive-16", overrides={"block_words": 1 << 18})
        self.__dict__.update(base.__dict__)
        self.name, self.chips = NAME, 4
        self.entry = dict(base.entry, name=NAME, traffic="archive-4card", chips=4)
        self.params = {"config": base.entry["config"], "traffic": "archive-4card",
                       "op": "archive-4card", "batch": BATCH, "check_calls": 2}

    def traffic(self):
        return sys.modules[__name__]


class Driver:
    def __init__(self, cell):
        from repro_torch.storage import multi
        self.cell, self.entry = cell, multi.pipelined_encode_many
        self.code = cell.program_code()
        self.refs = [cell.reference.Code(cell.n, cell.k, cell.l, int(cell.cfg["code_seed"]),
                                         device=d) for d in cell.devices]
        self.pools = [cell.random_words(s, cell.k, device=d)
                      for s, d in zip(SHARE, cell.devices)]
        cards = len(cell.devices)
        self.needed_blocks = cards * BATCH * (cell.k + cell.n)
        self.useful_blocks = cards * BATCH * cell.k
        self.late_cycles = int(LATE_MS * sleep_cycles_per_ms(cell.devices[3]))

    def batch(self, c: int, i: int):
        start = i % (SHARE[c] - BATCH + 1)
        return self.pools[c][start:start + BATCH]

    def call(self, i: int):
        outs = []
        for c, d in enumerate(self.cell.devices):
            if c == 3:
                with torch.cuda.device(d):
                    torch.cuda._sleep(self.late_cycles)
            outs.append(self.entry(self.code, self.batch(c, i), device=d))
        return outs

    def check(self, i: int, outs) -> tuple[int, int]:
        wrong = words = 0
        for c, out in enumerate(outs):
            for b, x in enumerate(self.batch(c, i)):
                want = self.refs[c].encode(x)
                wrong += differing(out[b], want, self.cell.l)
                words += want.numel()
        return wrong, words


def prepare(cell) -> Driver:
    return Driver(cell)


def sleep_cycles_per_ms(device) -> float:
    """``torch.cuda._sleep``'s cycles a millisecond on ``device``, timed."""
    with torch.cuda.device(device):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)         # the first launch pays its start
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        return 20_000_000 / a.elapsed_time(b)


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


def run(trace: bool, seed: int) -> dict:
    return harness.run_cell(FourCards(), seed, 2.0, trace, t_start=time.perf_counter(),
                            device=torch.device("cuda", 0))


def card_peaks(result) -> list[int]:
    line = next(n for n in result["notes"] if "memory peak by card=" in n)
    return list(ast.literal_eval(re.sub(r".*memory peak by card=", "", line)).values())


@pytest.mark.gpu
def test_four_card_call_peak_and_correct(four_cards):
    r = run(False, 2**31 + 401)
    assert r["correct"] and r["failed"] == 0 and r["device"]["count"] == 4, r["checks"]
    assert r["metrics"]["call_p95_ms"]["value"] >= 0.8 * LATE_MS    # card 3's late work
    peaks = card_peaks(r)
    assert len(peaks) == 4 and r["device"]["memory_peak_bytes"] == max(peaks)
    assert peaks[1] > peaks[0] and peaks[2] > peaks[3]     # 7 objects against 4


@pytest.mark.gpu
def test_without_the_join_the_late_card_falls_outside(four_cards, monkeypatch):
    monkeypatch.setattr(harness, "joiner", lambda devices: None)
    r = run(False, 2**31 + 402)
    assert r["correct"] and r["metrics"]["call_p95_ms"]["value"] < 0.5 * LATE_MS


@pytest.mark.gpu
def test_four_card_idle_is_each_cards(four_cards):
    """Cards 0-2 wait for card 3 most of each call: their idle shows, where
    the union of the four (card 3 always busy) would read almost none."""
    r = run(True, 2**31 + 403)
    assert r["correct"] and 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["metrics"]["device_idle_pct"]["value"] > 50
    assert 0 < r["metrics"]["kernel_roofline"]["value"] <= 100
