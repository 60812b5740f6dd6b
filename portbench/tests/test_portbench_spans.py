"""``portbench.spans.program`` on hand-built chrome-trace events with known
spans, launches, device operations and gaps; and ``tracing.reduce``, with
the metric readers that read it, unmoved by the program's spans."""
import pytest

from portbench import harness, spans, tracing


def X(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def user(name, a, b):
    return X(name, "user_annotation", a, b - a)


def call(at, ticks, extra=()):
    """The benchmark's spans of a call starting at ``at`` (100 us long) and
    the program's within it: a root from +2 to +39, resolve, lookup (with
    ``extra`` inside), buffers, wires from +7 to +10, then ``ticks`` as
    (start, end) offsets, and unpack at +35."""
    ev = [user("portbench.call", at, at + 100), user("portbench.entry", at + 1, at + 40),
          user("portbench.sync", at + 40, at + 99),
          user("repro_torch.encode_many", at + 2, at + 39),
          user("repro_torch.resolve", at + 3, at + 5), user("repro_torch.lookup", at + 5, at + 6),
          user("repro_torch.buffers", at + 6, at + 7), user("repro_torch.wires", at + 7, at + 10),
          user("repro_torch.unpack", at + 35, at + 38)]
    ev += [user("repro_torch.tick", at + a, at + b) for a, b in ticks]
    return ev + [user(n, at + a, at + b) for n, a, b in extra]


FILL, TICK = "void at::native::fill_kernel<int>(int*)", "void chain_tick_kernel<16, 2, 4>(int)"


def launch(ts, corr, cat="cuda_runtime"):
    return X("cudaLaunchKernel", cat, ts, 0.5, correlation=corr)


def device(name, a, b, corr):
    return X(name, "kernel", a, b - a, correlation=corr)


def trace_events(with_program=True, with_device=True):
    """Two traced calls. Busy [9, 95], [115, 190], [192, 193]; idle [0, 9],
    [95, 115], [190, 192], [193, 200]: 38 us, 20 of them inside the roots
    ([2, 9] and [102, 115])."""
    ev = call(0, [(10, 20), (20, 30)]) + call(
        100, [(10, 20), (20, 25)], extra=[("repro_torch.build", 5.2, 5.8)])
    if with_device:
        ev += [launch(8, 1), launch(11, 2), launch(21, 3, "cuda_driver"),
               launch(108, 4), launch(111, 5), launch(121, 6), launch(150, 7)]
        ev += [device(FILL, 9, 12, 1), device(TICK, 12, 60, 2), device(TICK, 60, 95, 3),
               device(FILL, 115, 116, 4), device(TICK, 116, 170, 5), device(TICK, 170, 190, 6),
               device("void other_kernel(int)", 192, 193, 7)]
    if not with_program:
        ev = [e for e in ev if not e["name"].startswith("repro_torch.")]
    return ev


def test_the_four_readings():
    got = spans.program(trace_events())
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["calls"] == 2 and got["ticks"] == 4
    assert got["prologue_s"] == pytest.approx(8e-6)           # root start -> first tick, both
    assert got["tick_s"] == pytest.approx((10 + 10 + 10 + 5) / 4 * 1e-6)
    assert got["idle_in_program_s"] == pytest.approx(20e-6)
    assert 100 * got["idle_in_program_s"] / got["window_s"] == pytest.approx(10.0)


def test_idle_split_by_the_innermost_span():
    by = spans.program(trace_events())["idle_by_span"]
    want = {"portbench.call": 4, "portbench.entry": 2, "portbench.sync": 12,
            "repro_torch.encode_many": 2, "repro_torch.resolve": 4, "repro_torch.lookup": 1.4,
            "repro_torch.build": 0.6, "repro_torch.buffers": 2, "repro_torch.wires": 5,
            "repro_torch.tick": 5}
    assert set(by) == set(want)
    for name, us in want.items():
        assert by[name] == pytest.approx(us * 1e-6), name
    assert sum(by.values()) == pytest.approx(38e-6)


def test_launches_outside_the_program_spans():
    got = spans.program(trace_events())["launches"]
    assert got == {"at::native::fill_kernel<int>": {"launched": 2, "outside_program": 0},
                   "chain_tick_kernel<16, 2, 4>": {"launched": 4, "outside_program": 0},
                   "other_kernel": {"launched": 1, "outside_program": 1}}


def test_none_without_a_program_span_or_a_call():
    assert spans.program(trace_events(with_program=False)) is None
    assert spans.program([e for e in trace_events() if e["name"] != "portbench.call"]) is None


def test_device_readings_none_without_a_device_operation():
    got = spans.program(trace_events(with_device=False))
    assert got["prologue_s"] == pytest.approx(8e-6) and got["tick_s"] is not None
    assert got["idle_in_program_s"] is None and got["idle_by_span"] is None
    assert got["launches"] is None


def test_innermost_labels_every_piece():
    pieces = spans.innermost([(1, 9, "a"), (2, 4, "b"), (4, 4, "empty"), (5, 12, "c")], 0, 10)
    assert pieces == [(0, 1, spans.OUTSIDE), (1, 2, "a"), (2, 4, "b"), (4, 5, "a"),
                      (5, 10, "c")]


@pytest.mark.parametrize("with_device", [True, False])
def test_reduce_and_its_readers_unmoved_by_program_spans(with_device):
    plain = tracing.reduce(trace_events(with_program=False, with_device=with_device))
    spanned = tracing.reduce(trace_events(with_device=with_device))
    assert spanned == plain

    def readings(t):
        run = harness.Run()
        run.trace, run.needed_bytes, run.device_name = t, 1 << 30, "NVIDIA H100 80GB HBM3"
        return {m: harness.load_module("metrics", m).read(run)
                for m in ("launches_per_call", "kernel_roofline", "device_idle_pct")}
    assert readings(spanned) == readings(plain)
    assert spanned["kernels"] == (7 if with_device else 0)
