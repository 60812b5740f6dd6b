"""The port's pipelined encode/decode slice vs the JAX package's oracles.

The JAX multi-device chain entry points are not the reference here: the
port is held against the numpy oracles (``encode_np``, ``decode_np``,
``pipeline_encode_local``) and the JAX package's host helpers, with the
cases of ``tests/test_storage_distributed.py``.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gf, pipeline, rapidraid as rr  # noqa: E402
from repro_torch.storage import chain  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    from repro.core import pipeline as jpipeline
    from repro.core import rapidraid as jrr
    from repro.storage import chain as jchain
except ImportError:
    jrr = None

CHAIN_CASES = [
    (8, 4, 8, 4),    # the paper's running example, GF(2^8)
    (8, 4, 16, 4),   # same, GF(2^16)
    (6, 4, 16, 3),   # n < 2k overlapped placement (§IV-C)
    (16, 11, 16, 8),  # the paper's evaluated production code (§VI)
]


@pytest.fixture(autouse=True)
def _reference(request):
    if jrr is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def words(rng, k, B, l):
    return rng.integers(0, 1 << l, size=(k, B)).astype(gf.WORD_DTYPE[l])


@pytest.mark.parametrize("n", [1, 2, 5, 16])
@pytest.mark.parametrize("num_chunks", [1, 3, 8])
def test_schedule_matches_jax(n, num_chunks):
    assert pipeline.num_ticks(num_chunks, n) == jpipeline.num_ticks(num_chunks, n)
    for reverse in (False, True):
        assert (pipeline.chain_perm(n, reverse)
                == jpipeline.chain_perm(n, reverse))
        assert ([pipeline.chain_pos(i, n, reverse) for i in range(n)]
                == [jpipeline.chain_pos(i, n, reverse) for i in range(n)])
    # the pipeline visits exactly the (node, chunk = t - node) pairs of the
    # JAX schedule, once each, with the wire ping-pong of the docstring
    seen = []

    def step(wire_in, wire_out, t, lo, count):
        assert wire_in is not wire_out and not wire_in[0].any()
        seen.extend((i, t - i) for i in range(lo, lo + count))
        wire_out[lo + 1:lo + count + 1] = 1   # row 0 must stay zero

    ticks = pipeline.software_pipeline(step, n, num_chunks, (n + 1, 1, 2),
                                       device=torch.device("cpu"))
    assert ticks == jpipeline.num_ticks(num_chunks, n)
    assert sorted(seen) == [(i, c) for i in range(n) for c in range(num_chunks)]
    assert len(seen) == n * num_chunks


@pytest.mark.parametrize("n,k,l,chunks", CHAIN_CASES)
def test_pipelined_encode_matches_oracles(n, k, l, chunks, monkeypatch):
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    jcode = jrr.RapidRAIDCode.make(n, k, l=l, seed=13)
    rng = np.random.default_rng(0)
    B = chunks * gf.LANES[l] * 8
    data = words(rng, k, B, l)
    ticks = []
    tick = chain.ops.chain_tick
    monkeypatch.setattr(chain.ops, "chain_tick",
                        lambda *a: (ticks.append(a[7]), tick(*a)))
    got = chain.pipelined_encode(code, data, num_chunks=chunks, device="cpu")
    assert got.dtype == gf.TORCH_WORD_DTYPE[l] and tuple(got.shape) == (n, B)
    np.testing.assert_array_equal(got.numpy(), jcode.encode_np(data))
    want, want_ticks = jrr.pipeline_encode_local(jcode, data, num_chunks=chunks)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ticks == list(range(want_ticks))


def test_pipelined_decode_from_survivors():
    """Paper §III's pipelined decode, the case of test_pipelined_decode_chain."""
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=13)
    jcode = jrr.RapidRAIDCode.make(8, 4, l=16, seed=13)
    rng = np.random.default_rng(3)
    data = words(rng, 4, gf.LANES[16] * 8 * 8, 16)
    cw = jcode.encode_np(data)
    ids = [0, 2, 3, 6, 7]
    got = chain.pipelined_decode(code, ids, cw[ids], num_chunks=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), data)
    np.testing.assert_array_equal(got.numpy(), jcode.decode_np(ids, cw[ids]))


@pytest.mark.parametrize("n,k,l,lost", [(8, 4, 8, [1, 4, 5]), (16, 11, 16, [2, 9]),
                                         (6, 4, 8, [0, 5])])
def test_encode_lose_decode_round_trip(n, k, l, lost):
    """The slice end to end: archive, drop nodes, read back from survivors."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    rng = np.random.default_rng(4)
    data = words(rng, k, gf.LANES[l] * 4 * 6, l)
    cw = chain.pipelined_encode(code, data, num_chunks=4, device="cpu")
    ids = [i for i in range(n) if i not in lost]
    assert code.decodable(ids)
    got = chain.pipelined_decode(code, ids, cw.numpy()[ids], num_chunks=4,
                                 device="cpu")
    np.testing.assert_array_equal(got.numpy(), data)


def test_decode_refuses_undecodable_survivors():
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=13)
    bad = next(ids for ids in itertools.combinations(range(8), 4)
               if not code.decodable(ids))
    with pytest.raises(ValueError, match="not decodable"):
        chain.pipelined_decode(code, bad, np.zeros((4, 32), np.uint8),
                               num_chunks=2, device="cpu")


@pytest.mark.parametrize("B,l,num_chunks", [(30, 8, 2), (6, 8, 1), (12, 16, 0),
                                            (10, 16, 3), (64, 16, 8)])
def test_check_chunking_raises_like_jax(B, l, num_chunks):
    def outcome(fn):
        try:
            fn(B, l, num_chunks, "pipelined_encode")
        except ValueError as e:
            return str(e)
        return None
    assert outcome(chain._check_chunking) == outcome(jchain._check_chunking)
    code = rr.RapidRAIDCode.make(8, 4, l=l, seed=0)
    data = np.zeros((4, B), gf.WORD_DTYPE[l])
    if outcome(jchain._check_chunking) is not None:
        with pytest.raises(ValueError, match="pipelined_encode"):
            chain.pipelined_encode(code, data, num_chunks=num_chunks, device="cpu")


def test_entry_points_reject_bad_words():
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=0)
    with pytest.raises(ValueError):
        chain.pipelined_encode(code, np.zeros((3, 16), np.uint16), device="cpu")
    with pytest.raises(ValueError):
        chain.pipelined_encode(code, np.zeros((4, 16), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        chain.pipelined_decode(code, [0, 1, 2, 3, 4], np.zeros((4, 16), np.uint16),
                               device="cpu")


def test_entry_points_run_on_cuda_by_default():
    """No silent CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chain.pipelined_encode(code, np.zeros((4, 32), np.uint8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chain.pipelined_decode(code, [0, 1, 2, 3, 4], np.zeros((5, 32), np.uint8))


@pytest.mark.parametrize("n,k,l", [(8, 4, 8), (6, 4, 16), (16, 11, 16)])
def test_host_helpers_match_jax(n, k, l):
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    jcode = jrr.RapidRAIDCode.make(n, k, l=l, seed=13)
    for got, want in zip(chain.bitplane_coeff_planes(code),
                         jchain.bitplane_coeff_planes(jcode)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(chain.placement_indices(code),
                         jchain.placement_indices(jcode)):
        np.testing.assert_array_equal(got, want)
    data = words(np.random.default_rng(5), k, 16, l)
    np.testing.assert_array_equal(chain.build_local_blocks(code, data),
                                  jchain.build_local_blocks(jcode, data))
    ids = list(range(n - k, n)) if code.decodable(range(n - k, n)) else list(range(n))
    D = code.decode_matrix(ids)
    np.testing.assert_array_equal(chain.column_bitplanes(D, l),
                                  jchain.column_bitplanes(D, l))
    # the slot table over the object's blocks reads the host placement
    src, slots, _ = chain.encode_operands(code, gf.pack_u32(torch.from_numpy(data), l))
    local = torch.where(torch.from_numpy(slots >= 0)[:, :, None],
                        src[0, torch.from_numpy(slots.clip(0)).long()], 0)
    want = jchain.build_local_blocks(jcode, data)
    np.testing.assert_array_equal(gf.unpack_u32(local, l).numpy(), want)


def test_order_chain_matches_jax():
    rng = np.random.default_rng(6)
    for n, k in [(6, 4), (8, 4), (16, 11)]:
        speeds = rng.uniform(0.1, 1.0, size=n)
        np.testing.assert_array_equal(chain.order_chain(speeds, n, k),
                                      jchain.order_chain(speeds, n, k))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,l,chunks", CHAIN_CASES)
def test_pipelined_encode_decode_on_cuda(cuda, n, k, l, chunks):
    from repro_torch.kernels.gf_encode import kernel
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    rng = np.random.default_rng(0)
    data = words(rng, k, chunks * gf.LANES[l] * 300, l)
    kernel.reset_launch_counts()
    got = chain.pipelined_encode(code, data, num_chunks=chunks)
    assert got.device.type == "cuda"
    # the whole encode chain is one launch, its running combination in registers
    assert kernel.encode_chain.launches == 1 and kernel.chain_tick.launches == 0
    np.testing.assert_array_equal(got.cpu().numpy(), code.encode_np(data))
    ids = sorted(rng.permutation(n)[:k + 1].tolist())
    if code.decodable(ids):
        rec = chain.pipelined_decode(code, ids, got.cpu().numpy()[ids],
                                     num_chunks=chunks)
        # the whole decode chain is one launch, its sums kept in registers
        assert kernel.repair_chain.launches == 1 and kernel.repair_tick.launches == 0
        np.testing.assert_array_equal(rec.cpu().numpy(), data)
