"""Streaming super-chunks in the PyTorch/CUDA port (``repro_torch.core.streaming``).

On the CPU: the stripe geometry (``plan_stream``, ``estimate_stripe_bytes``,
``superchunk_words_for``) equals the JAX package's over a grid, so one
budget gives one stripe width in both packages; every pipelined entry
point streamed at several stripe widths (a padded tail among them, with
and without a ``sink``) equals its monolithic call and the JAX package's
numpy oracles bit for bit; and the executor's contract (stripe order,
padding, the identity plan). Tests marked ``gpu`` hold the card's route:
each slot's CUDA graph against the tick loop, the double-buffered
executor at depths 1 and 2 against the monolithic call, the launch
counters under replay and the stripe footprint; they skip without a card.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codes, gf, jitcache, pipeline, streaming  # noqa: E402
from repro_torch.core import rapidraid as rr  # noqa: E402
from repro_torch.kernels.gf_encode import kernel  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    from repro.core import codes as jcodes
    from repro.core import streaming as jstreaming
    from repro.storage import repair as jrepair
except ImportError:
    jstreaming = None

CHUNKS = 4
ENTRIES = ["encode", "decode", "repair", "encode_many", "decode_many", "repair_many"]


@pytest.fixture(autouse=True)
def _reference(request):
    if jstreaming is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def words(rng, shape, l):
    return rng.integers(0, 1 << l, size=shape).astype(gf.WORD_DTYPE[l])


# ---------------------------------------------------------------------------
# stripe geometry: the JAX package's host math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("num_chunks", [1, 4, 8])
def test_plan_stream_equals_reference(l, num_chunks):
    for total in (1, 15, 16, 64, 640, 641, 1000, 4099):
        for sc in (None, 1, 7, 16, 100, 640, total, total + 1, 10 ** 9):
            got = streaming.plan_stream(total, sc, l=l, num_chunks=num_chunks)
            want = jstreaming.plan_stream(total, sc, l=l, num_chunks=num_chunks)
            assert (got.total_words, got.sc_words, got.num_superchunks, got.tail_words) == \
                (want.total_words, want.sc_words, want.num_superchunks, want.tail_words)
            assert got.streaming == want.streaming
            assert [got.stripe_span(s) for s in range(got.num_superchunks)] == \
                [want.stripe_span(s) for s in range(want.num_superchunks)]


GEOMS = [("rapidraid", 8, 4, 8), ("rapidraid", 6, 4, 16), ("rapidraid", 16, 11, 16),
         ("lrc", 16, 11, 16), ("mbr", 6, 4, 8)]


@pytest.mark.parametrize("family,n,k,l", GEOMS)
def test_stripe_bytes_and_budget_equal_reference(family, n, k, l):
    code, jcode = codes.make(family, n, k, l=l), jcodes.make(family, n, k, l=l)
    for sc in (16, 96, 1 << 12, 1 << 21):
        assert streaming.estimate_stripe_bytes(code, sc) == \
            jstreaming.estimate_stripe_bytes(jcode, sc)
        assert streaming.estimate_stripe_bytes(code, sc, rows_in=3, rows_out=5) == \
            jstreaming.estimate_stripe_bytes(jcode, sc, rows_in=3, rows_out=5)
    for budget in (1, 1 << 14, 1 << 16, 1 << 20, 600 << 20, 1 << 30):
        for nc in (1, 4, 8):
            assert streaming.superchunk_words_for(budget, code, nc) == \
                jstreaming.superchunk_words_for(budget, jcode, nc)


def test_paper_code_at_one_gib_streams_two_to_the_21():
    """The (16,11) GF(2^16) code at a 1 GiB budget and 8 chunks: 2^21 words
    a stripe, modeled at 600 MiB (the card's streaming run)."""
    code = rr.RapidRAIDCode.make(16, 11, l=16, seed=0)
    sc = streaming.superchunk_words_for(1 << 30, code, 8)
    assert sc == 1 << 21
    # 2 x (11 + 16) x 2 bytes of words, 2 x (2 + 1) x 16 packed lanes of 4 bytes
    assert streaming.estimate_stripe_bytes(code, sc) == 300 * sc + 384 == (600 << 20) + 384


def test_plan_identity_when_unset_or_covering():
    for sc in (None, 640, 10 ** 9):
        plan = streaming.plan_stream(640, sc, l=8, num_chunks=4)
        assert (plan.sc_words, plan.num_superchunks, plan.tail_words) == (640, 1, 640)
        assert not plan.streaming
        assert plan.stripe_span(0) == (0, 640)


def test_plan_rounds_to_granule_and_covers():
    plan = streaming.plan_stream(640, 100, l=8, num_chunks=4)
    assert plan.sc_words == 96 and plan.num_superchunks == 7
    assert plan.tail_words == 640 - 6 * 96
    spans = [plan.stripe_span(s) for s in range(plan.num_superchunks)]
    assert spans[0][0] == 0 and spans[-1][1] == 640
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert streaming.plan_stream(640, 1, l=8, num_chunks=4).sc_words == 16


def test_plan_rejects_bad_inputs():
    with pytest.raises(ValueError, match="superchunk_words"):
        streaming.plan_stream(640, 0, l=8, num_chunks=4)
    with pytest.raises(ValueError, match="at least 1 word"):
        streaming.plan_stream(0, None, l=8, num_chunks=4)


def test_budget_env_round_trip(monkeypatch):
    assert streaming.BUDGET_ENV == jstreaming.BUDGET_ENV
    monkeypatch.delenv(streaming.BUDGET_ENV, raising=False)
    assert streaming.budget_from_env() is None
    assert streaming.budget_from_env(123) == 123
    monkeypatch.setenv(streaming.BUDGET_ENV, "65536")
    assert streaming.budget_from_env(123) == 65536


# ---------------------------------------------------------------------------
# streamed entry points == monolithic == the JAX package's oracles
# ---------------------------------------------------------------------------


def _case(entry, n, k, l, B, seed=0):
    """(the call, taking superchunk_words and sink, and the JAX package's
    oracle result)."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=seed)
    jcode = jcodes.make("rapidraid", n, k, l=l, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lost = [0, n - 1]
    ids = [i for i in range(n) if i not in lost]
    if entry.endswith("_many"):
        objects = words(rng, (3, k, B), l)
        cws = np.stack([jcode.encode_np(o) for o in objects])
        shards = cws[:, ids]
        run, want = {
            "encode_many": (lambda **kw: multi.pipelined_encode_many(
                code, objects, CHUNKS, 2, device="cpu", **kw), cws),
            "decode_many": (lambda **kw: multi.pipelined_decode_many(
                code, ids, shards, CHUNKS, 1, device="cpu", **kw), objects),
            "repair_many": (lambda **kw: repair.pipelined_repair_many(
                code, ids, shards, lost, CHUNKS, 3, device="cpu", **kw),
                np.stack([jrepair.repair_np(jcode, lost, ids, s) for s in shards])),
        }[entry]
        return run, want
    data = words(rng, (k, B), l)
    cw = jcode.encode_np(data)
    return {
        "encode": (lambda **kw: chain.pipelined_encode(code, data, CHUNKS, device="cpu", **kw),
                   cw),
        "decode": (lambda **kw: chain.pipelined_decode(code, ids, cw[ids], CHUNKS,
                                                       device="cpu", **kw),
                   jcode.decode_np(ids, cw[ids])),
        "repair": (lambda **kw: repair.pipelined_repair(code, ids, cw[ids], lost, CHUNKS,
                                                        device="cpu", **kw),
                   jrepair.repair_np(jcode, lost, ids, cw[ids])),
    }[entry]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("n,k,l", [(8, 4, 8), (6, 4, 16)])
@pytest.mark.parametrize("granules", [1, 3, 7])
def test_streamed_entry_points_equal_monolithic_and_oracles(entry, n, k, l, granules):
    """B = 20 granules and a stripe of 1, 3 or 7 granules: 20, 7 (a 2-granule
    tail) and 3 (a 6-granule tail) stripes, each bit-identical to the
    monolithic call and to the JAX package's numpy oracle, assembled or
    through a sink."""
    granule = gf.LANES[l] * CHUNKS
    B = 20 * granule
    run, want = _case(entry, n, k, l, B)
    mono = run()
    np.testing.assert_array_equal(mono.numpy(), want)
    got = run(superchunk_words=granules * granule)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    seen = []
    assert run(superchunk_words=granules * granule,
               sink=lambda s, out: seen.append((s, out.copy()))) is None
    plan = streaming.plan_stream(B, granules * granule, l=l, num_chunks=CHUNKS)
    assert [s for s, _ in seen] == list(range(plan.num_superchunks))
    for s, out in seen:
        lo, hi = plan.stripe_span(s)
        np.testing.assert_array_equal(out, want[..., lo:hi])


@pytest.mark.parametrize("entry", ["encode", "decode_many"])
def test_stripe_width_not_a_granule_multiple_rounds_down(entry):
    l = 16
    granule = gf.LANES[l] * CHUNKS
    run, want = _case(entry, 8, 4, l, 9 * granule)
    np.testing.assert_array_equal(run(superchunk_words=2 * granule + 5).numpy(), want)
    np.testing.assert_array_equal(run(superchunk_words=1).numpy(), want)


def test_odd_object_width_streams_with_a_padded_tail():
    """A block of a non-lane multiple of words cannot run monolithically
    but streams: the tail stripe is zero-padded to the stripe width."""
    l, k, n = 16, 4, 8
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=2)
    data = words(np.random.default_rng(0), (k, 8 * 7 + 3), l)
    with pytest.raises(ValueError, match="chunks"):
        chain.pipelined_encode(code, data, CHUNKS, device="cpu")
    got = chain.pipelined_encode(code, data, CHUNKS, device="cpu", superchunk_words=16)
    np.testing.assert_array_equal(got.numpy(), jcodes.make("rapidraid", n, k, l=l, seed=2)
                                  .encode_np(data))


def test_identity_plan_with_a_sink():
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=1)
    data = words(np.random.default_rng(0), (4, 64), 8)
    seen = []
    assert chain.pipelined_encode(code, data, CHUNKS, device="cpu", superchunk_words=64,
                                  sink=lambda s, out: seen.append((s, out))) is None
    assert len(seen) == 1 and seen[0][0] == 0
    np.testing.assert_array_equal(seen[0][1], code.encode_np(data))


def test_run_words_identity_is_the_program_call():
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=1)
    data = torch.from_numpy(words(np.random.default_rng(0), (4, 64), 16))
    program = chain.encode_program(code, 64, CHUNKS, device="cpu")
    plan = streaming.plan_stream(64, None, l=16, num_chunks=CHUNKS)
    out = streaming.run_words(program, data, plan)
    assert isinstance(out, torch.Tensor) and torch.equal(out, program(data))


def test_execute_retires_in_order_and_pads_the_tail():
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=4)
    program = chain.encode_program(code, 32, CHUNKS, device="cpu")
    data = words(np.random.default_rng(3), (4, 32 * 3 + 16), 8)
    plan = streaming.plan_stream(data.shape[1], 32, l=8, num_chunks=CHUNKS)
    asked, got = [], []

    def get_stripe(s):
        asked.append(s)
        lo, hi = plan.stripe_span(s)
        return data[:, lo:hi]

    streaming.execute(plan, program, get_stripe, lambda s, out: got.append((s, out.copy())))
    assert asked == [0, 1, 2, 3] and [s for s, _ in got] == [0, 1, 2, 3]
    tail = np.zeros((4, 32), np.uint8)
    tail[:, :16] = data[:, 96:]
    np.testing.assert_array_equal(got[-1][1], code.encode_np(tail))
    with pytest.raises(ValueError, match="depth"):
        streaming.execute(plan, program, get_stripe, lambda s, out: None, depth=0)


def test_program_refuses_a_wrong_input():
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=1)
    program = chain.encode_program(code, 64, CHUNKS, device="cpu")
    with pytest.raises(ValueError, match="program input"):
        program(torch.zeros((4, 32), dtype=torch.uint16))


def test_measure_footprint_is_none_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card reports a number")
    assert streaming.measure_footprint(lambda: None) is None


@pytest.mark.parametrize("l", [8, 16])
def test_stripe_staging_copies_words_and_pads(l):
    """A slot's staging takes a stripe whose rows start anywhere, whose row
    stride is any word count, read-only or a CPU tensor, and zero-pads a
    short one; what lands in the pinned buffer is the words, padded."""
    st = streaming._Stripes.__new__(streaming._Stripes)   # the staging alone
    st.l, width = l, 8 * gf.LANES[l]
    st.h_in = [torch.full((3, width // gf.LANES[l]), -1, dtype=torch.int32)]
    staged = st.h_in[0].numpy().view(gf.WORD_DTYPE[l])
    rng = np.random.default_rng(l)
    for cols in (4 * width, 4 * width + 1, 4 * width + 3):
        data = words(rng, (3, cols), l)
        for lo, w in ((0, width), (gf.LANES[l], width), (1, width), (2, width - 3),
                      (width, width // 2)):
            for x in (data[:, lo:lo + w], torch.from_numpy(data)[:, lo:lo + w],
                      np.frombuffer(data.tobytes(), data.dtype).reshape(data.shape)[:, lo:lo + w]):
                st.h_in[0].fill_(-1)
                st._stage(0, x)
                want = np.zeros((3, width), data.dtype)
                want[:, :w] = data[:, lo:lo + w]
                np.testing.assert_array_equal(staged, want)


class _Event:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def record(self, stream=None):
        self.log.append(("record", self.name))

    def synchronize(self):
        self.log.append(("sync", self.name))


def _fake_slots(monkeypatch, log, slots, rows=2, lanes=3):
    """A ``_Stripes`` whose streams, events and graphs are host fakes: each
    slot's graph copies its input stripe to its output, plus one."""
    class Stream:
        def wait_stream(self, other):
            pass

        def wait_event(self, event):
            log.append(("wait", event.name))

    class Graph:
        def __init__(self, i):
            self.i = i

        def replay(self):
            log.append(("replay", self.i))
            st.d_out[self.i].copy_(st.d_in[self.i] + 1)

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    st = streaming._Stripes.__new__(streaming._Stripes)
    st.slots, st.l, st.device = slots, 16, "cuda"
    st.d_in, st.d_out, st.h_in, st.h_out = (
        [torch.zeros((rows, lanes), dtype=torch.int32) for _ in range(slots)] for _ in range(4))
    st.h_out_words = [h.numpy().view(np.uint16) for h in st.h_out]
    st.h2d, st.d2h, st.graphs = Stream(), Stream(), [Graph(i) for i in range(slots)]
    st.in_done, st.computed, st.out_done = (
        [_Event(log, f"{what}{i}") for i in range(slots)] for what in ("in", "comp", "out"))
    return st


@pytest.mark.parametrize("slots", [2, 3])
def test_stripe_loop_copies_replays_and_retires_in_order(monkeypatch, slots):
    """The card's stripe loop with its streams faked on the host: each
    stripe is staged, copied in, replayed after its copy's event and copied
    out; ``put_stripe(s)`` runs after s's copy-out event, in order, and a
    slot is staged again only after the stripe it held has retired."""
    log = []
    st = _fake_slots(monkeypatch, log, slots)
    data = words(np.random.default_rng(slots), (2, 6 * 7), 16)
    got = []

    def get_stripe(s):
        log.append(("get", s))
        return data[:, 6 * s:6 * s + 6]

    def put_stripe(s, out):
        log.append(("put", s))
        got.append((s, out.copy()))

    st.run(7, get_stripe, put_stripe)
    assert [s for s, _ in got] == list(range(7))
    for s, out in got:   # the fake graph adds one to each int32 lane
        lanes = data[:, 6 * s:6 * s + 6].copy().view(np.int32) + 1
        np.testing.assert_array_equal(out.view(np.int32), lanes)
    for s in range(7):
        i = s % slots
        at = log.index(("put", s))
        assert log[at - 1] == ("sync", f"out{i}")
        replay = [j for j, e in enumerate(log) if e == ("replay", i)][s // slots]
        assert log[replay - 1] == ("wait", f"in{i}")
        if s + slots < 7:
            assert log.index(("get", s + slots)) > at


def test_stripe_loop_raise_waits_for_stripes_in_flight(monkeypatch):
    log = []
    st = _fake_slots(monkeypatch, log, 2)
    data = words(np.random.default_rng(0), (2, 36), 16)

    def put_stripe(s, out):
        if s == 1:
            raise RuntimeError("sink failed")

    with pytest.raises(RuntimeError, match="sink failed"):
        st.run(6, lambda s: data[:, 6 * s:6 * s + 6], put_stripe)
    assert log[-1] == ("sync", "out0")          # stripe 2, still in flight


def test_caller_kept_wires_must_fit():
    with pytest.raises(ValueError, match="wire buffers"):
        pipeline.software_pipeline(lambda *a: None, 3, 2, (3, 1, 4), device="cpu",
                                   wires=[torch.zeros((3, 1, 5), dtype=torch.int32)] * 2)


# ---------------------------------------------------------------------------
# the card: graphs, the double-buffered executor, counters
# ---------------------------------------------------------------------------


def _streams(entry, cuda, B, sc):
    code = rr.RapidRAIDCode.make(16, 11, l=16, seed=0)
    rng = np.random.default_rng(7)
    lost = [5, 6, 7, 8, 14]
    ids = [i for i in range(16) if i not in lost]
    data = words(rng, (11, B), 16)
    cw = code.encode_np(data)
    objects = words(rng, (3, 11, B // 4), 16)
    cws = np.stack([code.encode_np(o) for o in objects])
    return code, {
        "encode": (lambda **kw: chain.pipelined_encode(code, data, **kw), cw),
        "decode": (lambda **kw: chain.pipelined_decode(code, ids, cw[ids], **kw), data),
        "repair": (lambda **kw: repair.pipelined_repair(code, ids, cw[ids], lost, **kw),
                   cw[lost]),
        "encode_many": (lambda **kw: multi.pipelined_encode_many(code, objects, **kw), cws),
        "decode_many": (lambda **kw: multi.pipelined_decode_many(code, ids, cws[:, ids], **kw),
                        objects),
        "repair_many": (lambda **kw: repair.pipelined_repair_many(
            code, ids, cws[:, ids], lost, **kw), cws[:, lost]),
    }[entry]


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRIES)
def test_streamed_on_card_equals_monolithic(cuda, entry):
    """Each entry point streamed on the card (graph replays, copies on
    streams of their own) at a stripe width with a padded tail equals its
    monolithic call on the card and the host oracle."""
    B = 16 * 8 * 25
    code, (run, want) = _streams(entry, cuda, B, None)
    mono = run()
    assert mono.device.type == "cuda"
    np.testing.assert_array_equal(mono.cpu().numpy(), want)
    width = want.shape[-1]
    got = run(superchunk_words=width // 3)
    np.testing.assert_array_equal(got.numpy(), want)
    plan = streaming.plan_stream(width, width // 3, l=16, num_chunks=8)
    assert plan.tail_words != plan.sc_words


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_double_buffered_execute_equals_depth_one(cuda, depth):
    code = rr.RapidRAIDCode.make(16, 11, l=16, seed=0)
    data = words(np.random.default_rng(8), (11, 16 * 8 * 40), 16)
    plan = streaming.plan_stream(data.shape[1], 16 * 8 * 3, l=16, num_chunks=8)
    program = chain.encode_program(code, plan.sc_words, 8)
    outs = {}
    for d in (1, depth):
        got = np.empty((16, data.shape[1]), np.uint16)

        def put(s, out, got=got):
            lo, hi = plan.stripe_span(s)
            got[:, lo:hi] = out[:, :hi - lo]
        streaming.execute(plan, program, lambda s: data[:, slice(*plan.stripe_span(s))],
                          put, depth=d)
        outs[d] = got
    np.testing.assert_array_equal(outs[depth], outs[1])
    np.testing.assert_array_equal(outs[1], code.encode_np(data))


@pytest.mark.gpu
def test_graph_replay_equals_tick_loop_and_counts_launches(cuda):
    """A slot's graph replays exactly the tick loop's launches: same
    output, and each replay adds the loop's launches to the counters
    (capture itself adds none)."""
    code = rr.RapidRAIDCode.make(16, 11, l=16, seed=0)
    sc = 16 * 8 * 4
    program = chain.encode_program(code, sc, 8)
    x = torch.from_numpy(words(np.random.default_rng(9), (11, sc), 16)).to(cuda)
    kernel.reset_launch_counts()
    loop = program(x)
    torch.cuda.synchronize()
    per_run = kernel.launch_counts()
    assert per_run["encode_chain"] == 1 and per_run["chain_tick"] == 0
    st = program.stripes(1)
    st.d_in[0].copy_(gf.pack_u32(x, 16))
    kernel.reset_launch_counts()
    for _ in range(3):
        st.graphs[0].replay()
    torch.cuda.synchronize()
    assert kernel.launch_counts() == {name: 3 * c for name, c in per_run.items()}
    assert torch.equal(gf.unpack_u32(st.d_out[0], 16), loop)
    assert st.graphs[0].launches == per_run


@pytest.mark.gpu
def test_streamed_run_counts_every_stripe_and_builds_once(cuda):
    code = rr.RapidRAIDCode.make(16, 11, l=16, seed=0)
    data = words(np.random.default_rng(10), (11, 16 * 8 * 20), 16)
    jitcache.clear()
    chain.pipelined_encode(code, data, 8, superchunk_words=16 * 8 * 4)   # builds, warms
    misses = jitcache.stats()["misses"]
    kernel.reset_launch_counts()
    got = chain.pipelined_encode(code, data, 8, superchunk_words=16 * 8 * 4)
    assert jitcache.stats()["misses"] == misses
    assert kernel.launch_counts()["encode_chain"] == 5
    assert kernel.launch_counts()["chain_tick"] == 0
    np.testing.assert_array_equal(got.numpy(), code.encode_np(data))


@pytest.mark.gpu
def test_stripe_footprint_is_measured_and_bounded(cuda):
    code = rr.RapidRAIDCode.make(16, 11, l=16, seed=0)
    sc = 1 << 14
    data = words(np.random.default_rng(11), (11, 4 * sc), 16)
    plan = streaming.plan_stream(data.shape[1], sc, l=16, num_chunks=8)
    jitcache.clear()

    def one_stripe():
        program = chain.encode_program(code, sc, 8)
        streaming.execute(streaming.plan_stream(sc, None, l=16, num_chunks=8), program,
                          lambda s: data[:, :sc], lambda s, out: None)

    peak = streaming.measure_footprint(one_stripe)
    assert peak is not None and 0 < peak <= streaming.estimate_stripe_bytes(code, sc)
    assert plan.num_superchunks == 4
