"""The port's atomic baseline, repair and degraded reads vs the JAX package.

The JAX multi-device entry points are not the reference here: the port is
held against the numpy oracles (``repair_np``, ``classical.encode_np``) and
the single-device JAX calls that run on the CPU (``atomic.encode_local``,
``repair.degraded_read``, the latter through the Pallas kernel in interpret
mode). Words are integers: every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import classical, fault_tolerance as ft, gf, pipeline  # noqa: E402
from repro_torch.core import rapidraid as rr  # noqa: E402
from repro_torch.kernels.gf_encode import kernel  # noqa: E402
from repro_torch.storage import atomic, repair  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp
    from repro.core import classical as jclassical
    from repro.core import fault_tolerance as jft
    from repro.core import pipeline as jpipeline
    from repro.core import rapidraid as jrr
    from repro.storage import atomic as jatomic
    from repro.storage import repair as jrepair
except ImportError:
    jnp = None

REPAIR_CASES = [(8, 4, 8), (8, 4, 16), (6, 4, 16), (16, 11, 16)]


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def words(rng, shape, l):
    return rng.integers(0, 1 << l, size=shape).astype(gf.WORD_DTYPE[l])


def loss_patterns(n, k, seed=0, per_count=2):
    """Seeded loss patterns, ``per_count`` for every loss count 1..n-k."""
    rng = np.random.default_rng(seed)
    for r in range(1, n - k + 1):
        for _ in range(per_count):
            yield sorted(rng.choice(n, size=r, replace=False).tolist())


# ---------------------------------------------------------------------------
# classical Cauchy RS and the atomic encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,l", [(16, 11, 16), (16, 11, 8), (8, 4, 8), (6, 4, 16)])
def test_classical_code_matches_jax(n, k, l):
    code, jcode = classical.make_code(n, k, l), jclassical.make_code(n, k, l)
    np.testing.assert_array_equal(code.G, jcode.G)
    assert code.G.dtype == jcode.G.dtype
    assert code.storage_overhead == jcode.storage_overhead
    rng = np.random.default_rng(n + l)
    data = words(rng, (k, 40), l)
    parity = classical.encode_np(code, data)
    np.testing.assert_array_equal(parity, jclassical.encode_np(jcode, data))
    np.testing.assert_array_equal(classical.encode(code, torch.from_numpy(data)).numpy(),
                                  parity)
    cw = np.concatenate([data, parity])
    for lost in loss_patterns(n, k, seed=l, per_count=1):
        ids = [i for i in range(n) if i not in lost]
        D = classical.decode_matrix(code, ids)
        np.testing.assert_array_equal(D, jclassical.decode_matrix(jcode, ids))
        np.testing.assert_array_equal(classical.decode_np(code, ids, cw[ids]), data)
        np.testing.assert_array_equal(
            classical.decode(code, ids, torch.from_numpy(cw[ids])).numpy(), data)


@pytest.mark.parametrize("family", ["rapidraid", "classical"])
@pytest.mark.parametrize("n,k,l", [(8, 4, 8), (16, 11, 16)])
def test_encode_local_matches_jax(family, n, k, l):
    if family == "rapidraid":
        code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=5), jrr.RapidRAIDCode.make(n, k, l=l, seed=5)
    else:
        code, jcode = classical.make_code(n, k, l), jclassical.make_code(n, k, l)
    rng = np.random.default_rng(7)
    packed = words(rng, (k, 4 * 37), l).view(np.uint32)   # a ragged lane count
    got = atomic.encode_local(code, torch.from_numpy(packed.view(np.int32)), device="cpu")
    want = np.asarray(jatomic.encode_local(jcode, jnp.asarray(packed)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n,k,l", [(16, 11, 16), (8, 4, 8), (6, 4, 16)])
def test_classical_distributed_encode_matches_oracle(n, k, l):
    code = classical.make_code(n, k, l)
    data = words(np.random.default_rng(n), (k, 96), l)
    got = atomic.classical_distributed_encode(code, data, device="cpu")
    want = np.concatenate([data, jclassical.encode_np(jclassical.make_code(n, k, l), data)])
    assert got.dtype == gf.TORCH_WORD_DTYPE[l]
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        atomic.classical_distributed_encode(code, data[:, :gf.LANES[l] + 1], device="cpu")


# ---------------------------------------------------------------------------
# repair plans and the Table I analysis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,l", REPAIR_CASES)
def test_repair_plan_matches_jax_every_loss_count(n, k, l):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=3), jrr.RapidRAIDCode.make(n, k, l=l, seed=3)
    for missing in loss_patterns(n, k):
        alive = [i for i in range(n) if i not in missing]
        try:
            jhelpers, jR = jft.repair_plan(jcode, missing, alive)
        except ValueError:
            with pytest.raises(ValueError):
                ft.repair_plan(code, missing, alive)
            continue
        helpers, R = ft.repair_plan(code, missing, alive)
        assert helpers == jhelpers
        np.testing.assert_array_equal(R, jR)
        assert code.repair_helpers(missing, alive) == jcode.repair_helpers(missing, alive)
        np.testing.assert_array_equal(ft.repair_matrix(code, missing, alive),
                                      jft.repair_matrix(jcode, missing, alive))


def test_repair_plan_rejects_overlap_and_overloss():
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=3)
    with pytest.raises(ValueError):
        ft.repair_plan(code, [0, 1], [1, 2, 3, 4, 5])
    with pytest.raises(ValueError):
        ft.repair_plan(code, [0, 1, 2, 3, 4], [5, 6, 7])


@pytest.mark.parametrize("n,k", [(8, 4), (6, 4)])
def test_table1_analysis_matches_jax(n, k):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=8, seed=2), jrr.RapidRAIDCode.make(n, k, l=8, seed=2)
    assert ft.dependent_ksubsets(code.G, k, 8) == jft.dependent_ksubsets(jcode.G, k, 8)
    assert ft.is_mds(code) == jft.is_mds(jcode)
    assert ft.recoverability_by_size(code.G, k, 8) == jft.recoverability_by_size(jcode.G, k, 8)
    assert ft.resilience_table(code) == jft.resilience_table(jcode)
    assert ft.natural_dependencies(n, k, l=8, trials=2) == jft.natural_dependencies(n, k, l=8, trials=2)
    for p in (0.1, 0.01):
        assert ft.static_resilience_mds(n, k, p) == jft.static_resilience_mds(n, k, p)
        assert ft.nines(ft.static_resilience_replication(3, p)) == jft.nines(
            jft.static_resilience_replication(3, p))


# ---------------------------------------------------------------------------
# pipelined and star repair, degraded reads (plain versions on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", range(10))
@pytest.mark.parametrize("n", [1, 4, 11])
def test_reverse_positions_match_jax_chain_pos(n, t):
    """Laid out by ``position_nodes(n, reverse=True)``, the forward ticks make
    node idx work chunk t - chain_pos(idx) of the JAX reverse chain, and the
    wire leaves toward node 0, the last position."""
    chunks = 4
    nodes = pipeline.position_nodes(n, reverse=True)
    assert nodes == [jpipeline.chain_pos(p, n, reverse=True) for p in range(n)]
    assert nodes[-1] == 0
    if t >= pipeline.num_ticks(chunks, n):
        return
    lo, count = pipeline.active_nodes(t, n, chunks)
    worked = {nodes[p]: t - p for p in range(lo, lo + count)}
    want = {idx: t - jpipeline.chain_pos(idx, n, reverse=True) for idx in range(n)
            if 0 <= t - jpipeline.chain_pos(idx, n, reverse=True) < chunks}
    assert worked == want


@pytest.mark.parametrize("num_chunks", [1, 3, 8])
@pytest.mark.parametrize("n,k,l", REPAIR_CASES)
def test_pipelined_and_star_repair_match_repair_np(n, k, l, num_chunks):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=13), jrr.RapidRAIDCode.make(n, k, l=l, seed=13)
    data = words(np.random.default_rng(num_chunks), (k, num_chunks * gf.LANES[l] * 5), l)
    cw = code.encode_np(data)
    for missing in loss_patterns(n, k, seed=num_chunks, per_count=1):
        ids = [i for i in range(n) if i not in missing]
        if not code.decodable(ids):
            with pytest.raises(ValueError):
                repair.pipelined_repair(code, ids, cw[ids], missing, num_chunks, device="cpu")
            continue
        want = jrepair.repair_np(jcode, missing, ids, cw[ids])
        np.testing.assert_array_equal(want, cw[missing])
        np.testing.assert_array_equal(repair.repair_np(code, missing, ids, cw[ids]), want)
        got = repair.pipelined_repair(code, ids, cw[ids], missing, num_chunks, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        got = repair.star_repair(code, ids, torch.from_numpy(cw[ids]), missing, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,k,l", REPAIR_CASES)
def test_degraded_read_matches_jax(n, k, l):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=2), jrr.RapidRAIDCode.make(n, k, l=l, seed=2)
    data = words(np.random.default_rng(3), (k, 128), l)
    cw = code.encode_np(data)
    for lost in loss_patterns(n, k, seed=4, per_count=1):
        ids = [i for i in range(n) if i not in lost]
        if not code.decodable(ids):
            continue
        sl = cw[ids][:, 32:96]
        blocks = [0, k - 1]
        want = jrepair.degraded_read_np(jcode, ids, sl, blocks)
        np.testing.assert_array_equal(want, data[blocks, 32:96])
        np.testing.assert_array_equal(repair.degraded_read_np(code, ids, sl, blocks), want)
        np.testing.assert_array_equal(np.asarray(jrepair.degraded_read(jcode, ids, sl, blocks)),
                                      want)
        got = repair.degraded_read(code, ids, sl, blocks, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_repair_entry_points_reject_bad_input():
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=1)
    cw = code.encode_np(words(np.random.default_rng(0), (4, 64), 8))
    ids = [1, 2, 3, 4, 5, 6, 7]
    with pytest.raises(ValueError):       # shards for 6 rows, ids for 7
        repair.pipelined_repair(code, ids, cw[ids[:-1]], [0], device="cpu")
    with pytest.raises(ValueError):       # 64 words do not make 3 chunks of lanes
        repair.pipelined_repair(code, ids, cw[ids], [0], num_chunks=3, device="cpu")
    with pytest.raises(ValueError):       # wrong word type for GF(2^8)
        repair.star_repair(code, ids, cw[ids].astype(np.uint16), [0], device="cpu")
    with pytest.raises(ValueError):       # 2 words are no whole lane
        repair.degraded_read(code, ids, cw[ids][:, :2], [0], device="cpu")


def test_entry_points_default_to_cuda():
    """Without a card, an entry point called without ``device`` raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=1)
    cw = code.encode_np(words(np.random.default_rng(0), (4, 64), 8))
    ids = [1, 2, 3, 4, 5, 6, 7]
    before = kernel.launch_counts()
    for call in (lambda: repair.pipelined_repair(code, ids, cw[ids], [0]),
                 lambda: repair.star_repair(code, ids, cw[ids], [0]),
                 lambda: repair.degraded_read(code, ids, cw[ids], [0]),
                 lambda: atomic.encode_local(code, np.zeros((4, 8), np.int32)),
                 lambda: atomic.classical_distributed_encode(
                     classical.make_code(8, 4, 8), cw[:4])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert kernel.launch_counts() == before


# ---------------------------------------------------------------------------
# on the card: the slice's entry points through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,l", [(8, 4, 8), (16, 11, 16)])
def test_slice_on_cuda_matches_cpu(cuda, n, k, l):
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    chunks = 4
    data = words(np.random.default_rng(1), (k, chunks * gf.LANES[l] * 301), l)
    cw = code.encode_np(data)
    missing = next(m for m in loss_patterns(n, k, seed=2)
                   if len(m) == n - k and code.decodable(set(range(n)) - set(m)))
    ids = [i for i in range(n) if i not in missing]
    kernel.reset_launch_counts()
    rep = repair.pipelined_repair(code, ids, cw[ids], missing, chunks)
    star = repair.star_repair(code, ids, cw[ids], missing)
    read = repair.degraded_read(code, ids, cw[ids][:, 64:192], [0, k - 1])
    local = atomic.encode_local(code, torch.from_numpy(data.view(np.int32)))
    ccode = classical.make_code(n, k, l)
    ccw = atomic.classical_distributed_encode(ccode, data)
    torch.cuda.synchronize()
    assert kernel.launch_counts() == {"chain_tick": 0, "gf_encode_mxu": 0, "repair_tick": 0,
                                      "repair_chain": 1, "encode_chain": 0, "gf_encode": 4}
    np.testing.assert_array_equal(rep.cpu().numpy(), cw[missing])
    np.testing.assert_array_equal(star.cpu().numpy(), cw[missing])
    np.testing.assert_array_equal(read.cpu().numpy(), data[[0, k - 1], 64:192])
    np.testing.assert_array_equal(local.cpu().numpy().view(gf.WORD_DTYPE[l]), cw)
    np.testing.assert_array_equal(ccw.cpu().numpy(),
                                  np.concatenate([data, classical.encode_np(ccode, data)]))
