"""What the program's own spans say about a traced stretch.

The port records ``repro_torch.*`` spans while a profiler runs
(``repro_torch.core.trace``): a root ``repro_torch.<entry>`` a call, and
under it ``resolve``, ``lookup`` (``build`` on a miss), ``buffers``,
``wires``, one ``tick`` a tick and ``unpack``. They share the chrome trace's
clock with the benchmark's own spans and the device's operations, so the
same events that ``tracing.reduce`` takes give, over the same window and the
same busy union:

- ``prologue_s``: the mean, over the traced calls, of the time from a
  root's start to its first tick's start;
- ``tick_s``: the mean duration of a ``repro_torch.tick`` span;
- ``idle_in_program_s``: the device's idle time (the complement of the busy
  union in the window) that lies inside a root;
- ``idle_by_span``: the idle time split by the innermost span, the
  benchmark's or the program's, over each piece of each gap;
- ``launches``: for each device operation's name, the kernels and memsets
  launched in the window and, of those, the ones whose launching runtime
  event (linked by ``correlation``) lies outside every program span.

``tracing.reduce`` computes what it always has; ``program`` reads the same
events beside it (``tools/trace_spans.py`` runs a cell with both).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.tracing import DEVICE_CATS, merge, short

PROGRAM = "repro_torch."
ROOTS = tuple(PROGRAM + e for e in ("encode", "decode", "encode_many", "decode_many",
                                    "repair", "repair_many"))
TICK = PROGRAM + "tick"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "between calls"


def _inside(intervals: list[tuple[float, float]], x: float) -> bool:
    """Whether ``x`` lies in one of the sorted disjoint ``intervals``."""
    i = bisect.bisect_right(intervals, (x, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= x <= intervals[i][1]


def _overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """The length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans, w0: float, w1: float) -> list[tuple[float, float, str]]:
    """[w0, w1] cut into pieces, each labelled with the innermost of
    ``spans`` ((start, end, name), nesting on one thread) that covers it,
    or ``OUTSIDE`` where none does."""
    marks = sorted([(a, 1, i) for i, (a, b, _) in enumerate(spans) if b > a]
                   + [(b, 0, i) for i, (a, b, _) in enumerate(spans) if b > a])
    stack: list[int] = []
    pieces, t = [], w0

    def piece(a, b):
        name = spans[stack[-1]][2] if stack else OUTSIDE
        if pieces and pieces[-1][2] == name:
            a = pieces.pop()[0]
        pieces.append((a, b, name))
    for x, starts, i in marks:
        x = min(max(x, w0), w1)
        if x > t:
            piece(t, x)
            t = x
        if starts:
            stack.append(i)
        else:
            stack.remove(i)
    if w1 > t:
        piece(t, w1)
    return pieces


def program(events: list) -> dict | None:
    """Chrome-trace events (times in microseconds) -> the program spans'
    numbers in seconds; None where the trace holds no traced call or no
    program span in one. Device numbers are None where the trace holds no
    device operation."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    marked = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e.get("name", "")))
              for e in xs if e.get("cat") == "user_annotation"]
    calls = merge((a, b) for a, b, n in marked if n == "portbench.call")
    if not calls:
        return None
    w0, w1 = calls[0][0], calls[-1][1]
    prog = [s for s in marked if s[2].startswith(PROGRAM) and _inside(calls, s[0])]
    roots = sorted(s for s in prog if s[2] in ROOTS)
    if not roots:
        return None
    tick_starts = sorted(a for a, _, n in prog if n == TICK)
    ticks = [b - a for a, b, n in prog if n == TICK]
    prologue = []
    for a, b, _ in roots:
        t = bisect.bisect_left(tick_starts, a)
        if t < len(tick_starts) and tick_starts[t] <= b:
            prologue.append(tick_starts[t] - a)
    out = {"window_s": (w1 - w0) * 1e-6, "calls": len(roots), "ticks": len(ticks),
           "prologue_s": sum(prologue) / len(prologue) * 1e-6 if prologue else None,
           "tick_s": sum(ticks) / len(ticks) * 1e-6 if ticks else None,
           "idle_in_program_s": None, "idle_by_span": None, "launches": None}

    dev = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1), e)
           for e in xs if e.get("cat") in DEVICE_CATS]
    dev = [d for d in dev if d[0] < d[1]]
    if not dev:
        return out
    busy = merge((a, b) for a, b, _ in dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    out["idle_in_program_s"] = _overlap(idle, merge((a, b) for a, b, _ in roots)) * 1e-6

    spans = [s for s in marked if s[2].startswith("portbench.") and _inside(calls, s[0])]
    by_span: dict[str, float] = defaultdict(float)
    j = 0
    for a, b, name in innermost(spans + prog, w0, w1):   # both sorted: one pass
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            by_span[name] += (min(b, idle[k][1]) - max(a, idle[k][0])) * 1e-6
            k += 1
    out["idle_by_span"] = dict(sorted(by_span.items(), key=lambda kv: -kv[1]))

    launched = {e["args"]["correlation"]: short(e["name"]) for _, _, e in dev
                if e.get("cat") in ("kernel", "gpu_memset")
                and "correlation" in e.get("args", {})}
    in_program = merge((a, b) for a, b, _ in prog)
    launches: dict[str, list[int]] = defaultdict(lambda: [0, 0])
    for e in xs:
        name = launched.get(e.get("args", {}).get("correlation"))
        if e.get("cat") in LAUNCH_CATS and name is not None:
            launches[name][0] += 1
            launches[name][1] += not _inside(in_program, float(e["ts"]))
    out["launches"] = {k: {"launched": v[0], "outside_program": v[1]}
                       for k, v in sorted(launches.items())}
    return out
