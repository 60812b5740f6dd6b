#!/usr/bin/env python3
"""The program's spans and wire counter over a traced stretch of a closed loop.

    python3 tools/trace_spans.py --workload rr16-archive-16 [--seed N] [--seconds 10]
    python3 tools/trace_spans.py --single [--seed N] [--seconds 10]

Runs the calls the benchmark makes (``portbench.harness``: the cell's
traffic driver, its warm-up, its closed-loop window with a traced stretch),
or, with ``--single``, the paper's single-object archive: the (8,4) code's
``chain.pipelined_encode`` of 256 MiB objects (4 blocks of 2^25 GF(2^16)
words) from a pool of 16 on the card. It keeps the traced stretch's chrome
trace and prints one JSON line: the card's name and power limit,
``tracing.reduce``'s numbers (``device_idle_pct``, ``launches_per_call``,
the device time a call), ``spans.program``'s readings of the program's spans
(``prologue_ms``, ``tick_host_us``, ``idle_in_program_pct``, the idle split
by innermost span, the launches outside every program span), the wire
counters over the window a call (``wire_zero_MB_per_call``,
``wire_hopped_bytes_per_call``) and, for a cell over a card layout, the
host's time in the ``repro_torch.hop`` spans a traced call
(``hop_span_ms_per_call``). A cell of several cards runs on its cards, as
``run.py`` runs it. No check of the answers: ``portbench/run.py`` decides
``correct``. Needs a CUDA card (as many as the cell asks for).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import driver, harness, spans, tracing  # noqa: E402

SINGLE = {"n": 8, "k": 4, "l": 16, "block_words": 1 << 25, "pool": 16}


class Single:
    """A closed loop of single-object archives: call i encodes pool object
    i mod 16."""

    def __init__(self, seed: int, device: torch.device):
        from repro_torch.core import codes
        from repro_torch.storage import chain
        self.entry, self.device = chain.pipelined_encode, device
        self.code = codes.make("rapidraid", SINGLE["n"], SINGLE["k"], l=SINGLE["l"], seed=0)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.pool = torch.empty((SINGLE["pool"], SINGLE["k"], SINGLE["block_words"]),
                                dtype=torch.uint16, device=device)
        self.pool.view(torch.int64).random_(-(1 << 63), None, generator=gen)

    def call(self, i: int):
        return self.entry(self.code, self.pool[i % SINGLE["pool"]], device=self.device)


def traced_loop(drv, devices, seconds: float, seed: int) -> dict:
    """The benchmark's warm-up and window over ``drv.call`` on ``devices``
    (one device, or a cell's cards), the stretch's events reduced both
    ways, and the wire counters' deltas a call."""
    from repro_torch.core import pipeline
    cards = len(driver.cards(devices))
    harness.warm_up(drv, devices, 0, True)
    run = harness.Run()
    before = pipeline.stats()
    stretch = tracing.Stretch(seconds, cards)
    errors = harness.window(devices, seconds, drv.call, harness.Reservoir(0, seed), stretch,
                            run)
    after = pipeline.stats()
    zeroed = after["wire_bytes_zeroed"] - before["wire_bytes_zeroed"]
    hopped = after["wire_bytes_hopped"] - before["wire_bytes_hopped"]
    stretch.close()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        stretch.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    reduced, prog = tracing.reduce(events, cards), spans.program(events)
    out = {"errors": errors, "calls": run.calls, "window_s": run.window_s,
           "dispatch_ms": sum(run.dispatch_ms) / max(len(run.dispatch_ms), 1),
           "wire_zero_MB_per_call": zeroed / run.calls / 1e6,
           "wire_hopped_bytes_per_call": hopped / run.calls}
    if reduced:
        hop_us = sum(float(e["dur"]) for e in events
                     if e.get("ph") == "X" and e.get("name") == "repro_torch.hop")
        out.update(traced_calls=reduced["calls"],
                   hop_span_ms_per_call=1e-3 * hop_us / reduced["calls"],
                   device_idle_pct=100 * (1 - reduced["busy_s"] / reduced["window_s"]),
                   launches_per_call=reduced["kernels"] / reduced["calls"],
                   kernel_ms_per_call=1e3 * reduced["kernel_s"] / reduced["calls"],
                   breakdown=reduced["breakdown"])
    if prog:
        def scaled(x, by):
            return None if x is None else x * by
        out.update(prologue_ms=scaled(prog["prologue_s"], 1e3),
                   tick_host_us=scaled(prog["tick_s"], 1e6),
                   idle_in_program_pct=scaled(prog["idle_in_program_s"],
                                              100 / prog["window_s"]),
                   ticks_per_call=prog["ticks"] / prog["calls"],
                   idle_by_span_ms_per_call={k: 1e3 * v / prog["calls"]
                                             for k, v in (prog["idle_by_span"] or {}).items()},
                   launches=prog["launches"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--workload")
    what.add_argument("--single", action="store_true")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_spans: no CUDA device available", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    harness.import_program()
    if args.single:
        devices, drv = device, Single(args.seed, device)
    else:
        spec = harness.Spec(args.workload)
        devices = [torch.device("cuda", c) for c in range(spec.chips)]
        drv = harness.prepare(spec, args.seed, devices)
    out = {"card": harness.card_line(), "what": args.workload or "rr8-single-encode",
           "seed": args.seed, **traced_loop(drv, devices, args.seconds, args.seed)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
