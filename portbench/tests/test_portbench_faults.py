"""A whole run of each cell with the timed path broken underneath comes out
not correct: once for each fault a cell can have, at a tiny size on the
CPU, the card's check skipped; and, on a card (marked ``gpu``), with the
card's own route of a decode or repair, one ``repair_chain`` launch,
broken."""
import time

import pytest
import torch
from conftest import CELLS, TINY, cpu_run

from portbench import harness

from repro_torch.kernels.gf_encode import ops
from repro_torch.storage import chain, multi, repair

ENTRIES = {"rr16-archive-16": (multi, "pipelined_encode_many"),
           "rr16-restore-1": (chain, "pipelined_decode"),
           "rr16-repair-16": (repair, "pipelined_repair_many")}


def state_unchanged(monkeypatch, cell):
    """Every tick returns without touching its outputs."""
    for name in ("chain_tick", "repair_tick"):
        monkeypatch.setattr(ops, name, lambda *a, **k: None)


def exchange_left_out(monkeypatch, cell):
    """The wire between chain positions is dropped: each tick reads zeros."""
    for name in ("chain_tick", "repair_tick"):
        real = getattr(ops, name)

        def tick(wire_in, *a, _real=real, **k):
            return _real(torch.zeros_like(wire_in), *a, **k)
        monkeypatch.setattr(ops, name, tick)


def half_left_out(monkeypatch, cell):
    """Half of the batch is served and the rest left zero (a single object:
    half of its words)."""
    mod, name = ENTRIES[cell]
    real = getattr(mod, name)

    def entry(code, *args, **kwargs):
        x = args[-1] if name != "pipelined_repair_many" else args[1]
        out = real(code, *args, **kwargs)
        if x.dim() == 3:
            half = x.shape[0] // 2
            out[half:] = 0
        else:
            out[..., out.shape[-1] // 2:] = 0
        return out
    monkeypatch.setattr(mod, name, entry)


def answer_altered(monkeypatch, cell):
    """One word of every answer is altered where it is produced."""
    mod, name = ENTRIES[cell]
    real = getattr(mod, name)

    def entry(*args, **kwargs):
        out = real(*args, **kwargs)
        flat = out.view(torch.int16).view(-1)
        flat[flat.numel() // 3] ^= 1
        return out
    monkeypatch.setattr(mod, name, entry)


@pytest.mark.parametrize("fault", [state_unchanged, exchange_left_out, half_left_out,
                                   answer_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    r = cpu_run(cell)
    assert not r["correct"] and r["checks"]["wrong_words"]["value"] > 0, r["checks"]


def chain_launch_skipped(real, calls):
    """The card's one launch of a decode or repair chain never runs: its sums
    stay what the buffer held."""
    def route(shards, *a, **k):
        calls.append(shards.device)
    return route


def chain_sum_altered(real, calls):
    """One word of the chain's sums is altered where the launch writes them."""
    def route(shards, shard_rows, out, *a, **k):
        calls.append(shards.device)
        real(shards, shard_rows, out, *a, **k)
        out.view(-1)[out.numel() // 3] ^= 1
    return route


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [chain_launch_skipped, chain_sum_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["rr16-restore-1", "rr16-repair-16"])
def test_card_route_fault_is_not_correct(monkeypatch, cell, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    calls = []
    monkeypatch.setattr(ops, "repair_chain", fault(ops.repair_chain, calls))
    r = harness.run_cell(cell, 2**31 + 307, 0.5, False, t_start=time.perf_counter(),
                         device=torch.device("cuda", 0),
                         overrides=dict(TINY, block_words=1 << 16))
    assert calls and all(d.type == "cuda" for d in calls)
    assert not r["correct"] and r["checks"]["wrong_words"]["value"] > 0, r["checks"]
