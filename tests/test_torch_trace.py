"""The port's spans and its wire counter (``repro_torch.core.trace``,
``pipeline.stats``), on the CPU at tiny sizes.

With no profiler running no span is entered; under ``torch.profiler`` each
entry-point call is one ``repro_torch.<entry>`` root holding the resolve,
lookup, buffers, wires and unpack spans once each, ``build`` on a program's
first call only, and one ``tick`` span a tick, and no span lies outside a
root. ``wire_bytes_zeroed`` rises by the two fresh wires of a monolithic
call and not where the caller keeps its wires (a streamed program's
stripes). Tests marked ``gpu`` hold the same on the card.
"""
import itertools
import json
import math
import tempfile
from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codes, gf, jitcache, pipeline, trace  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402

N, K, L = 8, 4, 16
CHUNKS, STAGGER, OBJECTS = 4, 1, 3
S = 3                                   # lanes of a chunk
B = gf.LANES[L] * CHUNKS * S            # words of a block
ENTRIES = ("encode", "decode", "repair", "encode_many", "decode_many", "repair_many")


@pytest.fixture(autouse=True)
def _fresh_programs():
    jitcache.clear()
    yield
    jitcache.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def geometry():
    """The code, a decodable survivor set of k, one lost node and the
    helper count of its repair."""
    code = codes.make("rapidraid", N, K, l=L, seed=0)
    ids = next(list(c) for c in itertools.combinations(range(N), K) if code.decodable(c))
    missing = [2]
    alive = tuple(i for i in range(N) if i not in missing)
    helpers, _ = repair._repair_plan_cached(code, tuple(missing), alive)
    return code, ids, missing, len(helpers)


def calls(device="cpu"):
    """entry -> (a call of it on seeded data, its tick count, its wire shape)."""
    code, ids, missing, h = geometry()
    rng = np.random.default_rng(1)
    data = rng.integers(0, 1 << L, size=(OBJECTS, K, B)).astype(gf.WORD_DTYPE[L])
    cws = np.stack([code.encode_np(x) for x in data])
    alive = [i for i in range(N) if i not in missing]
    W = pipeline.window_size(CHUNKS, OBJECTS, STAGGER)
    one, many = pipeline.num_ticks, pipeline.num_ticks_many
    kw = {"num_chunks": CHUNKS, "device": device}
    return {
        "encode": (lambda: chain.pipelined_encode(code, data[0], **kw),
                   one(CHUNKS, N), (N, 1, S)),
        "decode": (lambda: chain.pipelined_decode(code, ids, cws[0][ids], **kw),
                   one(CHUNKS, K), (K, 1, K, S)),
        "repair": (lambda: repair.pipelined_repair(code, alive, cws[0][alive], missing, **kw),
                   one(CHUNKS, h), (h, 1, 1, S)),
        "encode_many": (lambda: multi.pipelined_encode_many(code, data, stagger=STAGGER, **kw),
                        many(CHUNKS, N, OBJECTS, STAGGER), (N, W, S)),
        "decode_many": (lambda: multi.pipelined_decode_many(code, ids, cws[:, ids],
                                                            stagger=STAGGER, **kw),
                        many(CHUNKS, K, OBJECTS, STAGGER), (K, W, K, S)),
        "repair_many": (lambda: repair.pipelined_repair_many(
                            code, alive, cws[:, alive], missing, stagger=STAGGER, **kw),
                        many(CHUNKS, h, OBJECTS, STAGGER), (h, W, 1, S)),
    }


def traced(fn, times: int, activities=(torch.profiler.ProfilerActivity.CPU,)):
    """``fn()`` called ``times`` times under a profiler: (the results, the
    chrome trace's events)."""
    with torch.profiler.profile(activities=list(activities)) as prof:
        outs = [fn() for _ in range(times)]
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    return outs, events


def program_spans(events):
    """(start, end, name) of every ``repro_torch.*`` span, by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("repro_torch."))


def test_span_is_shared_and_inert_without_a_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or nullcontext())
    assert trace.span("repro_torch.x") is trace.span("repro_torch.y")
    assert trace.spans("repro_torch.tick")() is trace.span("repro_torch.z")
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.span("repro_torch.x")
        trace.spans("repro_torch.tick")()
    assert entered == ["repro_torch.x", "repro_torch.tick"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_span_is_entered_without_a_profiler(monkeypatch, entry):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    fn, _, _ = calls()[entry]
    fn()
    fn()
    assert entered == []


@pytest.mark.parametrize("entry", ENTRIES)
def test_spans_of_each_call_under_a_profiler(entry):
    fn, ticks, _ = calls()[entry]
    want = fn()
    jitcache.clear()
    outs, events = traced(fn, 2)
    for out in outs:                        # tracing changes no answer
        assert torch.equal(out, want)
    spans = program_spans(events)
    roots = [s for s in spans if s[2] == f"repro_torch.{entry}"]
    assert len(roots) == 2
    for c, (a, b, _) in enumerate(roots):
        inside = [s for s in spans if a <= s[0] and s[1] <= b and s is not roots[c]]
        names = [n for _, _, n in inside]
        for name in ("resolve", "lookup", "buffers", "wires", "unpack"):
            assert names.count(f"repro_torch.{name}") == 1, (name, names)
        assert names.count("repro_torch.build") == (1 if c == 0 else 0)
        assert names.count("repro_torch.tick") == ticks
        # build sits under lookup; ticks come after the wires, unpack after the ticks
        lookup = next(s for s in inside if s[2] == "repro_torch.lookup")
        for s in inside:
            if s[2] == "repro_torch.build":
                assert lookup[0] <= s[0] and s[1] <= lookup[1]
        wires = next(s for s in inside if s[2] == "repro_torch.wires")
        unpack = next(s for s in inside if s[2] == "repro_torch.unpack")
        tick_spans = [s for s in inside if s[2] == "repro_torch.tick"]
        assert wires[1] <= tick_spans[0][0] and tick_spans[-1][1] <= unpack[0]
    outside = [s for s in spans
               if not any(a <= s[0] and s[1] <= b for a, b, _ in roots)]
    assert outside == []


def test_placed_ticks_are_spans_with_their_copies():
    code, _, _, _ = geometry()
    mesh = chain.make_chain_mesh(N, devices=["cpu"] * N)
    data = np.random.default_rng(2).integers(0, 1 << L, size=(K, B)).astype(np.uint16)
    outs, events = traced(lambda: chain.pipelined_encode(code, data, num_chunks=CHUNKS,
                                                         mesh=mesh), 1)
    np.testing.assert_array_equal(outs[0].numpy(), code.encode_np(data))
    names = [n for _, _, n in program_spans(events)]
    assert names.count("repro_torch.encode") == 1
    assert names.count("repro_torch.tick") == pipeline.num_ticks(CHUNKS, N)
    copies = [e for e in events if e.get("name") == "aten::copy_" and e.get("ph") == "X"]
    ticks = [s for s in program_spans(events) if s[2] == "repro_torch.tick"]
    assert copies and all(any(a <= float(e["ts"]) <= b for a, b, _ in ticks) for e in copies)


@pytest.mark.parametrize("entry", ENTRIES)
def test_wire_counter_counts_a_monolithic_calls_two_wires(entry):
    fn, _, shape = calls()[entry]
    fn()                                    # the program built
    for _ in range(2):
        before = pipeline.stats()["wire_bytes_zeroed"]
        fn()
        assert pipeline.stats()["wire_bytes_zeroed"] - before == 2 * 4 * math.prod(shape)


def test_wire_counter_still_where_the_caller_keeps_its_wires():
    """What a streamed program's stripes do: wires made once, then every
    run of the ticks over them zeroes nothing. A placed encode program
    keeps wires (an unplaced one keeps none: one ``encode_chain``): each
    position's incoming wire is zeroed once."""
    code, _, _, _ = geometry()
    mesh = chain.make_chain_mesh(N, devices=["cpu"] * N)
    program = chain.encode_program(code, B, CHUNKS, mesh=mesh)
    before = pipeline.stats()["wire_bytes_zeroed"]
    wires = pipeline.make_wires(program.wire_shape, program.device, program.placement)
    assert pipeline.stats()["wire_bytes_zeroed"] - before == N * 4 * math.prod((1, 1, S))
    data = np.random.default_rng(3).integers(0, 1 << L, size=(K, B)).astype(np.uint16)
    src = gf.pack_u32(torch.from_numpy(data), L)
    out = torch.empty((N, src.shape[-1]), dtype=torch.int32)
    after = pipeline.stats()["wire_bytes_zeroed"]
    for _ in range(2):
        program.ticks(src, out, wires)
        np.testing.assert_array_equal(gf.unpack_u32(out, L).numpy(), code.encode_np(data))
    assert pipeline.stats()["wire_bytes_zeroed"] == after


def test_placed_wires_count_the_incoming_buffers():
    placement = [torch.device("cpu")] * 3
    before = pipeline.stats()["wire_bytes_zeroed"]
    wires = pipeline.make_wires((3, 2, 5), torch.device("cpu"), placement)
    assert pipeline.stats()["wire_bytes_zeroed"] - before == 3 * 4 * 2 * 5
    assert [tuple(i.shape) for i, _ in wires] == [(1, 2, 5)] * 3


def test_reset_stats():
    pipeline.make_wires((2, 3), torch.device("cpu"))
    assert pipeline.stats()["wire_bytes_zeroed"] > 0
    pipeline.reset_stats()
    assert pipeline.stats() == {"wire_bytes_zeroed": 0, "wire_bytes_hopped": 0}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_streamed_call_zeroes_no_wire_once_its_stripes_exist(cuda):
    code, _, _, _ = geometry()
    data = np.random.default_rng(4).integers(0, 1 << L, size=(K, 4 * B)).astype(np.uint16)
    first = chain.pipelined_encode(code, data, num_chunks=CHUNKS, superchunk_words=B)
    before = pipeline.stats()["wire_bytes_zeroed"]
    again = chain.pipelined_encode(code, data, num_chunks=CHUNKS, superchunk_words=B)
    assert pipeline.stats()["wire_bytes_zeroed"] == before
    np.testing.assert_array_equal(again.numpy(), first.numpy())
    np.testing.assert_array_equal(again.numpy(), code.encode_np(data))


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRIES)
def test_every_launch_of_a_call_on_the_card_is_in_a_span(cuda, entry):
    fn, _, _ = calls("cuda")[entry]
    fn()
    torch.cuda.synchronize()
    acts = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    _, events = traced(lambda: (fn(), torch.cuda.synchronize()), 2, acts)
    spans = program_spans(events)
    assert sum(n == f"repro_torch.{entry}" for _, _, n in spans) == 2
    # an unplaced chain on the card, encode, decode or repair, is one launch
    # in one tick span
    assert sum(n == "repro_torch.tick" for _, _, n in spans) == 2
    device = {e["args"].get("correlation") for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memset")} - {None}
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in device]
    assert launches
    roots = [s for s in spans if s[2] == f"repro_torch.{entry}"]
    assert all(any(a <= float(e["ts"]) <= b for a, b, _ in roots) for e in launches)
