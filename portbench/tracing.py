"""The traced stretch of a ``--trace 1`` run, and its reduction to numbers.

``torch.profiler`` (CUPTI) watches the calls that start between a quarter of
the window and ``TRACE_SECONDS`` later (at most half the window). The
benchmark's own spans label them: ``portbench.call`` around each call,
``portbench.entry`` around the entry-point call and ``portbench.sync``
around the synchronise. The profiler's chrome trace, written to a
temporary file and removed, is reduced card by card (a device operation's
card is its ``args.device``, a peer copy's its ``args.inDevice``) to:

- ``window_s``: from the first traced call's start to the last one's end;
- ``busy_s``: the time in that stretch in which a kernel, a copy or a
  memset ran on a card (the union of that card's intervals), as a mean over
  the cell's cards, so that ``1 - busy_s / window_s`` is each card's idle
  share averaged over the cards, and a card that waits on another shows;
- ``calls``: the traced calls; ``kernels``: the kernels that ran in them on
  every card, whatever launched them; ``kernel_s``: the sum of those
  kernels' times, in card-seconds;
- ``breakdown``: the device operations that took the most time, summed over
  the cards, and the idle gaps of every card summed by what the host was
  doing (the innermost benchmark span, or between calls) and the device
  operation on that card that ended them.

On one card each number is the one card's.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

TRACE_SECONDS = 2.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LABELS = {"portbench.entry": "entry call", "portbench.sync": "synchronise"}


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


class Stretch:
    """Starts and stops the profiler around a steady stretch of the window of
    a cell on ``cards`` cards."""

    def __init__(self, seconds: float, cards: int = 1):
        self.cards = cards
        self.start_at = 0.25 * seconds
        self.stop_at = self.start_at + min(TRACE_SECONDS, 0.5 * seconds)
        self.prof = None
        self.done = False

    def tick(self, elapsed: float) -> bool:
        """Called before each call of the window; whether that call is traced."""
        if self.prof is None and not self.done and elapsed >= self.start_at:
            self.prof = profiler()
            self.prof.start()
        elif self.prof is not None and not self.done and elapsed >= self.stop_at:
            self.close()
        return self.prof is not None and not self.done

    def close(self) -> None:
        if self.prof is not None and not self.done:
            self.prof.stop()
        self.done = True

    def summary(self) -> dict | None:
        """The stretch's numbers, or None where nothing was traced."""
        self.close()
        if self.prof is None:
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.prof = None
        return reduce(events, self.cards)


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and argument list, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].strip()[:96] or name[:96]


def card_of(event: dict) -> int:
    """The card a device operation ran on: the trace's ``args.device``, or
    for a copy between cards, which has none, ``args.inDevice``, the card
    whose stream ran it."""
    args = event.get("args", {})
    return int(args.get("device", args.get("inDevice", 0)))


def reduce(events: list, cards: int = 1) -> dict | None:
    """Chrome-trace events (times in microseconds) of a cell on ``cards``
    cards -> the stretch's numbers in seconds; None where the trace holds no
    call. A card of the cell with no device operation is idle throughout."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("portbench.")]
    calls = merge((a, b) for a, b, n in spans if n == "portbench.call")
    if not calls:
        return None
    w0, w1 = calls[0][0], calls[-1][1]
    by_card: dict[int, list] = {c: [] for c in range(cards)}
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if a < b:
                op = (a, b, short(e["name"]), e["cat"])
                by_card.setdefault(card_of(e), []).append(op)
    host = sorted((a, b, n) for a, b, n in spans if n in LABELS)   # disjoint spans
    host_ts = [a for a, _, _ in host]

    busy_s = kernel_s = 0.0
    kernels = 0
    ops: dict[str, float] = defaultdict(float)
    gaps: dict[str, float] = defaultdict(float)
    for dev in by_card.values():
        busy = merge((a, b) for a, b, _, _ in dev)
        busy_s += sum(b - a for a, b in busy) * 1e-6
        ks = [b - a for a, b, _, c in dev if c == "kernel"]
        kernels, kernel_s = kernels + len(ks), kernel_s + sum(ks) * 1e-6
        for a, b, name, _ in dev:
            ops[name] += (b - a) * 1e-6
        starts = sorted((a, name) for a, _, name, _ in dev)
        start_ts = [a for a, _ in starts]
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            h = bisect.bisect_right(host_ts, g0) - 1
            doing = LABELS[host[h][2]] if h >= 0 and host[h][1] > g0 else "between calls"
            s = bisect.bisect_left(start_ts, g1)
            nxt = starts[s][1] if s < len(starts) else "window end"
            gaps[f"{doing} before {nxt}"] += (g1 - g0) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s / len(by_card),
            "calls": len(calls), "kernels": kernels, "kernel_s": kernel_s,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}
