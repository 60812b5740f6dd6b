"""The call plan of the pipelined entry points (``storage.chain.call_plan``).

Where ticks run (the CPU, a placed chain) a call resolves its schedule as
it always has: ``num_chunks=None`` and ``stagger=None`` take the tuning
cache's values, which key the program. An unplaced call on the card is one
launch that reads no schedule: its plan reaches no tuner and carries none,
so calls that differ only in ``num_chunks`` or ``stagger`` share one
program. The CPU tests plan card calls with the device check stubbed, so
no card is needed; the ``gpu`` test runs the six entry points on the card
against the CPU route.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import autotune, gf, jitcache, rapidraid as rr  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402

N, K, L = 8, 4, 16
B_OBJ = 3
B = gf.LANES[L] * 8 * 4                          # 64 words: 1, 2, 4, 8, 16 chunks
LOST = [0, 5]
IDS = [i for i in range(N) if i not in LOST]
ENTRIES = ["encode", "decode", "repair", "encode_many", "decode_many", "repair_many"]
TUNER = ("num_chunks_for", "stagger_for", "calibrated_topology")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A private tuning cache, clean counters and programs."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setenv(autotune.TUNE_ENV, "cached")
    autotune.reset()
    jitcache.clear()
    yield
    autotune.reset()
    jitcache.clear()


@pytest.fixture
def code():
    code = rr.RapidRAIDCode.make(N, K, l=L, seed=0)
    assert code.decodable(IDS)
    return code


def refuse_the_tuner(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an unplaced card call reached the tuner")
    for name in TUNER:
        monkeypatch.setattr(autotune, name, refuse)


def plan_of(code, entry, num_chunks=None, stagger=None, **kw):
    """The plan ``entry``'s call makes: its sets, chain and batch."""
    sets = {"decode": (tuple(IDS),), "repair": (tuple(LOST), tuple(IDS))}.get(
        entry.removesuffix("_many"), ())
    h = {"encode": N, "decode": len(IDS), "repair": K}[entry.removesuffix("_many")]
    return chain.call_plan(code, "test", entry, B, num_chunks, stagger, chain_len=h, sets=sets,
                           B_obj=B_OBJ if entry.endswith("_many") else None, **kw)


def test_tick_paths_resolve_a_cached_schedule(code):
    """With a cache of 2 chunks for encode and encode_many and a stagger of
    2, a CPU call and a call placed on ``["cpu"] * n`` resolve and key 2
    and 2, as the entry points always have."""
    cpu = torch.device("cpu")
    for entry, extra in (("encode", ()), ("encode_many", ("x0=3",))):
        autotune.cache().put(autotune._key(entry, code.spec, f"B={B}", f"chain={N}", *extra,
                                           "num_chunks", device=cpu), {"value": 2})
    autotune.cache().put(autotune._key("stagger", code.spec, f"b={B_OBJ}", "nc=2",
                                       device=cpu), {"value": 2})
    rng = np.random.default_rng(1)
    data = rng.integers(0, 1 << L, size=(B_OBJ, K, B)).astype(np.uint16)
    want = np.stack([code.encode_np(x) for x in data])
    mesh = chain.make_chain_mesh(N, devices=["cpu"] * N)
    for where, m in (({"device": "cpu"}, None), ({"mesh": mesh}, mesh)):
        one = plan_of(code, "encode", **where)
        many = plan_of(code, "encode_many", **where)
        assert (one.num_chunks, one.stagger, many.num_chunks, many.stagger) == (2, 0, 2, 2)
        np.testing.assert_array_equal(chain.pipelined_encode(code, data[0], **where).numpy(),
                                      want[0])
        np.testing.assert_array_equal(multi.pipelined_encode_many(code, data, **where).numpy(),
                                      want)
        keys = jitcache.compile_counts()
        assert repr(("encode", code.cache_key, m, B, 2, cpu)) in keys
        assert repr(("encode_many", code.cache_key, m, B_OBJ, B, 2, 2, cpu)) in keys
    assert autotune.stats()["hits"] > 0


@pytest.mark.parametrize("entry", ENTRIES)
def test_an_unplaced_card_call_plans_no_schedule(code, monkeypatch, entry):
    """Planned for ``cuda:0`` (the device check stubbed), any schedule
    gives one key with none in it, and no tuner function is reached; an
    explicit ``num_chunks`` is still checked and sets the stripe granule,
    and a None one takes ``DEFAULT_NUM_CHUNKS``'s."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    refuse_the_tuner(monkeypatch)
    before = autotune.stats()
    card = torch.device("cuda", 0)
    batch = entry.endswith("_many")
    plans = [plan_of(code, entry, nc, stagger, device=card)
             for nc, stagger in ((None, None), (2, 1 if batch else None), (4, 2 if batch else None))]
    assert {p.key for p in plans} == {plans[0].key}
    assert all((p.device, p.placement, p.num_chunks, p.stagger) == (card, None, None, None)
               for p in plans)
    sets = len(plans[0].key) - 5 - batch           # entry, code, mesh, [B_obj], words, device
    assert plans[0].key[2 + sets:] == (None,) + ((B_OBJ,) if batch else ()) + (B, card)
    with pytest.raises(ValueError, match="3 chunks"):
        plan_of(code, entry, 3, device=card)
    with pytest.raises(ValueError, match="num_chunks must be >= 1"):
        plan_of(code, entry, 0, device=card)
    if batch:
        with pytest.raises(ValueError, match="stagger must be >= 1"):
            plan_of(code, entry, None, 0, device=card)
    tuned = plan_of(code, entry, device=card, superchunk_words=40)
    explicit = plan_of(code, entry, 2, device=card, superchunk_words=40)
    assert tuned.stream == streaming.plan_stream(B, 40, l=L, num_chunks=chain.DEFAULT_NUM_CHUNKS)
    assert (tuned.stream.sc_words, explicit.stream.sc_words) == (32, 40)
    assert autotune.stats() == before


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRIES)
def test_unplaced_card_calls_share_one_program(code, monkeypatch, entry):
    """On the card, calls at two chunk counts (and two staggers for a
    batch) and with none build one program, reach no tuner, and equal the
    CPU route bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(2)
    data = rng.integers(0, 1 << L, size=(B_OBJ, K, B)).astype(np.uint16)
    cw = np.stack([code.encode_np(x) for x in data])
    calls = {
        "encode": lambda **kw: chain.pipelined_encode(code, data[0], **kw),
        "decode": lambda **kw: chain.pipelined_decode(code, IDS, cw[0][IDS], **kw),
        "repair": lambda **kw: repair.pipelined_repair(code, IDS, cw[0][IDS], LOST, **kw),
        "encode_many": lambda **kw: multi.pipelined_encode_many(code, data, **kw),
        "decode_many": lambda **kw: multi.pipelined_decode_many(code, IDS, cw[:, IDS], **kw),
        "repair_many": lambda **kw: repair.pipelined_repair_many(code, IDS, cw[:, IDS], LOST,
                                                                 **kw),
    }
    call, batch = calls[entry], entry.endswith("_many")
    schedules = [{}, {"num_chunks": 2}, {"num_chunks": 4}]
    if batch:
        schedules = [{}, {"num_chunks": 2, "stagger": 1}, {"num_chunks": 4, "stagger": 2}]
    want = call(device="cpu", **schedules[1])
    jitcache.clear()
    with monkeypatch.context() as m:
        refuse_the_tuner(m)
        before = autotune.stats()
        got = [call(**schedule) for schedule in schedules]
        assert autotune.stats() == before
    assert list(jitcache.entry_counts(entry).values()) == [1]
    for out in got:
        assert out.device.type == "cuda"
        assert torch.equal(out.cpu(), want)
