"""The program cache of the PyTorch/CUDA port (``repro_torch.core.jitcache``).

On the CPU: the cache's hit/miss/size and ``compile_counts`` /
``entry_counts`` semantics, held against the JAX package's
``repro.core.jitcache`` on the same calls, and every pipelined entry point
building its program once per key: a warm call with the same shapes
builds nothing and copies no table to the device, and the S stripes of a
streamed call share one program. Tests marked ``gpu`` hold the same on
the card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gf, jitcache, rapidraid as rr, streaming  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    from repro.core import jitcache as jjitcache
except ImportError:
    jjitcache = None

CHUNKS = 4


@pytest.fixture(autouse=True)
def _fresh_cache(request):
    if jjitcache is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")
    jitcache.clear()
    yield
    jitcache.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def words(rng, shape, l):
    return rng.integers(0, 1 << l, size=shape).astype(gf.WORD_DTYPE[l])


def test_jitcache_get_and_stats():
    """The case of the JAX package's ``test_jitcache_get_and_stats``, run
    through both caches side by side. The reference's plain callable reports
    -1 builds (no jit introspection); every program in the port is a
    ``streaming.Program``, which reports the 1 build it had."""
    def port_program():
        return streaming.Program(device=torch.device("cpu"), l=16, sc_words=2, in_lead=(1,),
                                 out_lead=(1,), wire_shape=(1,), ticks=lambda *a: None)

    for cache, make, builds in ((jitcache, port_program, 1),
                                (jjitcache, lambda: (lambda x: x + 1), -1)):
        cache.clear()
        built = []

        def builder(built=built, make=make):
            built.append(1)
            return make()

        key = ("unit", 1, 2)
        fn1 = cache.get(key, builder)
        fn2 = cache.get(key, builder)
        assert fn1 is fn2 and built == [1]
        st = cache.stats()
        assert st["hits"] == 1 and st["misses"] == 1 and st["size"] == 1
        assert cache.compile_counts() == {repr(key): builds}
        assert cache.entry_counts("unit") == {repr(key): builds}
        assert cache.entry_counts("other") == {}
        cache.clear()
        assert cache.stats() == {"hits": 0, "misses": 0, "size": 0}
    jjitcache.clear()


def test_builder_failure_caches_nothing():
    def boom():
        raise ValueError("not decodable")

    with pytest.raises(ValueError):
        jitcache.get(("decode", 1), boom)
    assert jitcache.stats()["size"] == 0
    assert jitcache.get(("decode", 1), lambda: len) is len
    assert jitcache.stats()["size"] == 1


def _calls(code, l, B):
    """Every pipelined entry point on one (8,4) case, as callables."""
    rng = np.random.default_rng(1)
    data = words(rng, (code.k, B), l)
    objects = words(rng, (3, code.k, B), l)
    cw = code.encode_np(data)
    cws = np.stack([code.encode_np(o) for o in objects])
    lost = [0, 6]
    ids = [i for i in range(code.n) if i not in lost]
    return {
        "encode": lambda: chain.pipelined_encode(code, data, CHUNKS, device="cpu"),
        "decode": lambda: chain.pipelined_decode(code, ids, cw[ids], CHUNKS, device="cpu"),
        "repair": lambda: repair.pipelined_repair(code, ids, cw[ids], lost, CHUNKS,
                                                  device="cpu"),
        "encode_many": lambda: multi.pipelined_encode_many(code, objects, CHUNKS, 1,
                                                           device="cpu"),
        "decode_many": lambda: multi.pipelined_decode_many(code, ids, cws[:, ids], CHUNKS, 2,
                                                           device="cpu"),
        "repair_many": lambda: repair.pipelined_repair_many(code, ids, cws[:, ids], lost,
                                                            CHUNKS, 1, device="cpu"),
    }


@pytest.mark.parametrize("entry", ["encode", "decode", "repair", "encode_many",
                                   "decode_many", "repair_many"])
@pytest.mark.parametrize("l", [8, 16])
def test_warm_entry_point_builds_nothing(entry, l, monkeypatch):
    """The second call with the same shapes is a hit: same program, no
    build, no table copied to the device, and ``entry_counts`` shows 1."""
    code = rr.RapidRAIDCode.make(8, 4, l=l, seed=3)
    call = _calls(code, l, gf.LANES[l] * CHUNKS * 6)[entry]
    copies = []
    real = chain.device_tables

    def spy(tables, device):
        copies.append(tables.shape)
        return real(tables, device)

    for mod in (chain, repair):                  # the modules that copy tables
        monkeypatch.setattr(mod, "device_tables", spy)
    first = call()
    assert jitcache.stats()["misses"] == 1 and len(copies) == 1
    second = call()
    assert torch.equal(first, second)
    st = jitcache.stats()
    assert st["misses"] == 1 and st["hits"] == 1 and st["size"] == 1
    assert len(copies) == 1                      # the warm call copied no table
    counts = jitcache.entry_counts(entry)
    assert list(counts.values()) == [1]
    assert jitcache.compile_counts() == counts


def test_keys_carry_stripe_width_chunks_and_survivors():
    """A program per (stripe width, num_chunks, survivor set, stagger): a
    new geometry misses, the same one hits."""
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=3)
    rng = np.random.default_rng(2)
    data = words(rng, (4, 64), 16)
    cw = code.encode_np(data)
    chain.pipelined_encode(code, data, 4, device="cpu")
    chain.pipelined_encode(code, data, 8, device="cpu")
    chain.pipelined_encode(code, data[:, :32], 4, device="cpu")
    chain.pipelined_encode(code, data, 4, device="cpu")
    assert jitcache.stats()["misses"] == 3 and len(jitcache.entry_counts("encode")) == 3
    for ids in ([0, 1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 6], [0, 1, 2, 3, 4, 5]):
        chain.pipelined_decode(code, ids, cw[ids], 4, device="cpu")
    assert len(jitcache.entry_counts("decode")) == 2
    objects = np.stack([data, data])
    for stagger in (1, 2, 1):
        multi.pipelined_encode_many(code, objects, 4, stagger, device="cpu")
    assert len(jitcache.entry_counts("encode_many")) == 2


def test_stripes_share_one_program():
    """S stripes of a streamed call run one program, and a second streamed
    call builds nothing (the JAX package's trace-count case)."""
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=5)
    granule = gf.LANES[8] * CHUNKS
    data = words(np.random.default_rng(0), (4, granule * 21), 8)
    for _ in range(2):
        out = chain.pipelined_encode(code, data, CHUNKS, device="cpu",
                                     superchunk_words=granule * 4)
    assert list(jitcache.entry_counts("encode").values()) == [1]
    st = jitcache.stats()
    assert st["misses"] == 1 and st["hits"] == 1
    np.testing.assert_array_equal(out.numpy(), code.encode_np(data))
    cw = out.numpy()
    alive = [0, 2, 3, 4, 6, 7]
    got = repair.pipelined_repair(code, alive, cw[alive], [1, 5], CHUNKS, device="cpu",
                                  superchunk_words=granule * 4)
    assert list(jitcache.entry_counts("repair").values()) == [1]
    np.testing.assert_array_equal(got.numpy(), cw[[1, 5]])


def test_encode_program_shares_the_encode_key():
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=5)
    program = chain.encode_program(code, 64, CHUNKS, device="cpu")
    assert chain.encode_program(code, 64, CHUNKS, device="cpu") is program
    data = words(np.random.default_rng(0), (4, 64), 16)
    chain.pipelined_encode(code, data, CHUNKS, device="cpu")
    assert jitcache.stats() == {"hits": 2, "misses": 1, "size": 1}
    with pytest.raises(ValueError, match="chunks"):
        chain.encode_program(code, 60, CHUNKS, device="cpu")


@pytest.mark.gpu
def test_warm_call_on_card_builds_nothing(cuda):
    """On the card a warm encode builds no program, and a streamed call's
    second run builds nothing either."""
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=3)
    B = gf.LANES[16] * CHUNKS * 64
    rng = np.random.default_rng(4)
    data = words(rng, (4, B), 16)
    want = code.encode_np(data)
    for _ in range(2):
        got = chain.pipelined_encode(code, data, CHUNKS)
    assert jitcache.stats()["misses"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    for _ in range(2):
        got = chain.pipelined_encode(code, data, CHUNKS, superchunk_words=B // 4)
    assert jitcache.stats()["misses"] == 2
    assert list(jitcache.entry_counts("encode").values()) == [1, 1]
    np.testing.assert_array_equal(got.numpy(), want)
