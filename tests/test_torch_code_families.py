"""Code families of the PyTorch/CUDA port: LRC, MBR and the registry.

On the CPU the port's families, registry and ``ErasureCode`` members are
held against the JAX package's on the family grid of ``tests/test_codes.py``
(generators, ``encode_np``, ``decode_np(block_words=)``, ``repair_np``,
repair plans, ``to_message``, overheads and transfer words), and the
device paths the families take run their kernels' plain versions:
``atomic.encode_local`` of an LRC or MBR generator, ``pipelined_repair`` /
``pipelined_repair_many`` / ``star_repair`` of an LRC block through its
local group, and the multi-object entry points that refuse a family as
the JAX package's do. Tests marked ``gpu`` run the same device paths
through the kernels and skip without a card.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codes, gf, pipeline, rapidraid as rr  # noqa: E402
from repro_torch.core.codes import lrc, regenerating  # noqa: E402
from repro_torch.storage import atomic, chain, multi, repair  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp
    from repro.core import codes as jcodes
    from repro.core import rapidraid as jrr
except ImportError:
    jnp = None

FAMILIES = ("rapidraid", "lrc", "mbr")
GRID = [(8, 4, 16), (6, 4, 8)]     # (n, k, l): test_codes.py's (8,4) GF(2^16), and (6,4)
N, K, L = 8, 4, 16


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def payload(code, B=256, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << code.l, size=(code.k, B)).astype(gf.WORD_DTYPE[code.l])


def pair(family, n, k, l, seed=0):
    return codes.make(family, n, k, l=l, seed=seed), jcodes.make(family, n, k, l=l, seed=seed)


def loss_patterns(code, f_max, per_count=6):
    for n_lost in range(1, f_max + 1):
        yield from (list(m) for m in itertools.islice(
            itertools.combinations(range(code.n), n_lost), per_count))


# ---------------------------------------------------------------------------
# the family grid against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,l", GRID + [(16, 11, 16)])
@pytest.mark.parametrize("family", FAMILIES)
def test_generator_geometry_and_members_match(family, n, k, l):
    got, want = pair(family, n, k, l, seed=3)
    np.testing.assert_array_equal(got.G, want.G)
    assert got.G.dtype == want.G.dtype
    assert (got.family, got.n, got.k, got.l, got.seed) == (want.family, n, k, l, 3)
    assert got.spec.to_manifest() == want.spec.to_manifest()
    assert (got.positionwise, got.supports_chain_encode, got.rows_per_node, got.sub_k) == (
        want.positionwise, want.supports_chain_encode, want.rows_per_node, want.sub_k)
    assert got.storage_overhead == want.storage_overhead
    for B in (64, 256, 1000):
        assert got.shard_words(B) == want.shard_words(B)
        assert got.repair_transfer_words(B) == want.repair_transfer_words(B)
    if family == "lrc":
        assert (got.groups, got.n_local, got.n_global, got.locality) == (
            want.groups, want.n_local, want.n_global, want.locality)
    if family == "mbr":
        np.testing.assert_array_equal(got.psi, want.psi)
        assert (got.d, got.alpha, got.sub_message) == (want.d, want.alpha, want.sub_message)


@pytest.mark.parametrize("n,k,l", GRID)
@pytest.mark.parametrize("family", FAMILIES)
def test_encode_to_message_and_decode_match(family, n, k, l):
    """``encode_np``, ``to_message`` and ``decode_np(block_words=)`` == the
    JAX package's, for block lengths that pad MBR's message and not."""
    got, want = pair(family, n, k, l)
    for B in (256, 250):
        data = payload(got, B=B, seed=B)
        np.testing.assert_array_equal(got.to_message(data), want.to_message(data))
        cw = got.encode_np(data)
        np.testing.assert_array_equal(cw, want.encode_np(data))
        assert cw.shape == (n, got.shard_words(B))
        for lost in loss_patterns(got, got.max_tolerated_losses(), per_count=3):
            ids = [i for i in range(n) if i not in lost]
            np.testing.assert_array_equal(got.decode_np(ids, cw[ids], block_words=B), data)
            np.testing.assert_array_equal(want.decode_np(ids, cw[ids], block_words=B), data)


@pytest.mark.parametrize("n,k,l", GRID)
@pytest.mark.parametrize("family", FAMILIES)
def test_repair_np_and_plans_match(family, n, k, l):
    got, want = pair(family, n, k, l)
    data = payload(got, seed=1)
    cw = got.encode_np(data)
    assert got.max_tolerated_losses() == want.max_tolerated_losses()
    for lost in loss_patterns(got, got.max_tolerated_losses()):
        ids = [i for i in range(n) if i not in lost]
        rebuilt = got.repair_np(lost, ids, cw[ids])
        np.testing.assert_array_equal(rebuilt, cw[lost])
        np.testing.assert_array_equal(rebuilt, want.repair_np(lost, ids, cw[ids]))
        assert got.repair_helpers(lost, ids) == want.repair_helpers(lost, ids)
        if got.positionwise:
            helpers, R = got.repair_plan(lost, ids)
            jhelpers, jR = want.repair_plan(lost, ids)
            assert helpers == jhelpers
            np.testing.assert_array_equal(R, jR)


@pytest.mark.parametrize("family", FAMILIES)
def test_decodable_matches(family):
    got, want = pair(family, N, K, L)
    for m in range(1, N + 1):
        for ids in itertools.islice(itertools.combinations(range(N), m), 20):
            assert got.decodable(ids) == want.decodable(ids), ids


def test_lrc_local_repair_and_mbr_summands_match():
    got, want = pair("lrc", N, K, L)
    for row in range(N):
        assert got.row_group(row) == want.row_group(row)
    for gi in range(got.n_local):
        assert got.group_rows(gi) == want.group_rows(gi)
    helpers, R = got.repair_plan([0], list(range(1, N)))
    assert set(helpers) <= set(got.group_rows(got.row_group(0))) and np.all(R == 1)
    mbr, jmbr = pair("mbr", N, K, L)
    data = payload(mbr, seed=4)
    cw = mbr.encode_np(data)
    helpers = [i for i in range(N) if i != 2][:mbr.d]
    mus = np.stack([mbr.helper_summand(2, h, cw[h]) for h in helpers])
    np.testing.assert_array_equal(mus, np.stack([jmbr.helper_summand(2, h, cw[h])
                                                 for h in helpers]))
    np.testing.assert_array_equal(mbr.combine_summands(2, helpers, mus), cw[[2]])
    assert mbr.max_tolerated_losses() == N - K


def test_registry_memoizes_and_unknown_family_raises_like_jax():
    assert codes.families() == jcodes.families()
    for family in FAMILIES:
        code = codes.make(family, N, K, l=L)
        assert codes.make(family, N, K, l=L) is code
        assert codes.from_spec(code.spec) is code
        assert codes.CodeSpec.from_manifest(code.spec.to_manifest()) == code.spec
    assert isinstance(codes.make("lrc", N, K, l=L), lrc.LRCCode)
    assert isinstance(codes.make("mbr", N, K, l=L), regenerating.MBRCode)
    assert codes.make("rapidraid", N, K, l=L, seed=3) == rr.RapidRAIDCode.make(N, K, l=L,
                                                                                seed=3)
    with pytest.raises(ValueError) as got:
        codes.make("zfec", N, K)
    with pytest.raises(ValueError) as want:
        jcodes.make("zfec", N, K)
    assert str(got.value) == str(want.value)
    assert "unknown code family 'zfec'" in str(got.value)
    for family, n, k in (("lrc", 5, 4), ("mbr", 4, 4)):
        with pytest.raises(ValueError):
            codes.make(family, n, k)


@pytest.mark.parametrize("n,k,l", [(8, 4, 16), (16, 11, 8)])
def test_rapidraid_encode_decode_match_jax(n, k, l):
    """``rapidraid.encode`` / ``decode`` / ``decode_matrix`` on word tensors
    == the JAX package's on arrays."""
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=2), jrr.RapidRAIDCode.make(n, k, l=l,
                                                                                  seed=2)
    data = payload(code, B=64, seed=n)
    cw = rr.encode(code, torch.from_numpy(data))
    assert cw.dtype == gf.TORCH_WORD_DTYPE[l]
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jrr.encode(jcode, jnp.asarray(data))))
    ids = [i for i in range(n) if i not in (0, n - 1)]
    np.testing.assert_array_equal(rr.decode_matrix(code, ids), jrr.decode_matrix(jcode, ids))
    got = rr.decode(code, ids, cw[torch.tensor(ids)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jrr.decode(jcode, ids, jnp.asarray(cw.numpy()[ids]))))
    np.testing.assert_array_equal(got.numpy(), data)
    with pytest.raises(ValueError):
        rr.encode(code, torch.from_numpy(data[:-1]))


# ---------------------------------------------------------------------------
# the device paths the families take (plain versions on the CPU)
# ---------------------------------------------------------------------------


def encode_local_words(code, data, device) -> np.ndarray:
    """``atomic.encode_local`` of the family's generator over its message,
    reshaped to the (n, shard_words) codeword."""
    msg = torch.from_numpy(np.ascontiguousarray(code.to_message(data))).to(device)
    out = atomic.encode_local(code, gf.pack_u32(msg, code.l), device=device)
    return gf.unpack_u32(out, code.l).reshape(code.n, -1).cpu().numpy()


@pytest.mark.parametrize("n,k,l", GRID)
@pytest.mark.parametrize("family", ["lrc", "mbr"])
def test_encode_local_equals_encode_np(family, n, k, l):
    got, want = pair(family, n, k, l)
    for B in (256, 248):
        data = payload(got, B=B, seed=B)
        np.testing.assert_array_equal(encode_local_words(got, data, "cpu"),
                                      want.encode_np(data))


@pytest.mark.parametrize("num_chunks", [1, 4])
@pytest.mark.parametrize("n,k,l", GRID + [(16, 11, 16)])
def test_lrc_repair_runs_its_local_group(n, k, l, num_chunks, monkeypatch):
    """A lost LRC block whose group is intact is rebuilt by a chain of its
    local group only (``locality`` helpers or fewer, num_ticks of that
    chain), by the star and by the staggered batch, each == ``repair_np``."""
    code, jcode = pair("lrc", n, k, l)
    B = gf.LANES[l] * num_chunks * 4
    objects = np.stack([payload(code, B=B, seed=s) for s in range(3)])
    cw = np.stack([code.encode_np(o) for o in objects])
    seen = []
    real = pipeline.software_pipeline

    def spy(step, chain_len, *args, **kwargs):
        seen.append(chain_len)
        return real(step, chain_len, *args, **kwargs)

    monkeypatch.setattr(pipeline, "software_pipeline", spy)
    for lost in range(code.k + code.n_local):       # data and local-parity rows
        ids = [i for i in range(n) if i != lost]
        want = jcode.repair_np([lost], ids, cw[0, ids])
        np.testing.assert_array_equal(want, cw[0, [lost]])
        group = set(code.group_rows(code.row_group(lost))) - {lost}
        assert set(repair.repair_operands(code, [lost], ids, "cpu")[0]) == {
            ids.index(h) for h in group}
        got = repair.pipelined_repair(code, ids, cw[0, ids], [lost], num_chunks, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        assert seen[-1] == len(group) <= code.locality
        star = repair.star_repair(code, ids, cw[0, ids], [lost], device="cpu")
        np.testing.assert_array_equal(star.numpy(), want)
        many = repair.pipelined_repair_many(code, ids, cw[:, ids], [lost], num_chunks, 2,
                                            device="cpu")
        np.testing.assert_array_equal(many.numpy(), cw[:, [lost]])


@pytest.mark.parametrize("family", ["lrc", "mbr"])
def test_multi_entry_points_take_or_refuse_a_family_as_jax(family):
    """``pipelined_encode_many`` refuses both (no chain schedule);
    ``pipelined_decode_many`` refuses MBR (sub-packetized) and decodes an
    LRC batch, as the JAX entry points do."""
    code = codes.make(family, N, K, l=L)
    objects = np.stack([payload(code, B=64, seed=s) for s in range(2)])
    with pytest.raises(ValueError, match="no chain schedule"):
        multi.pipelined_encode_many(code, objects, device="cpu")
    cw = np.stack([code.encode_np(o) for o in objects])
    ids = [i for i in range(N) if i not in (1, 6)]
    if family == "mbr":
        with pytest.raises(ValueError, match="sub-packetized"):
            multi.pipelined_decode_many(code, ids, cw[:, ids], device="cpu")
        with pytest.raises(ValueError, match="sub-packetized"):
            chain.pipelined_decode(code, ids, cw[0, ids], device="cpu")
        return
    got = multi.pipelined_decode_many(code, ids, cw[:, ids], 4, 1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), objects)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("family", ["lrc", "mbr"])
def test_encode_local_on_cuda_equals_encode_np(cuda, family, l):
    # MBR at (6,4): its (30, 14) generator builds in NVRTC faster than (8,4)'s (56, 22)
    code = codes.make(family, *((N, K) if family == "lrc" else (6, 4)), l=l)
    data = payload(code, B=1000, seed=5)
    np.testing.assert_array_equal(encode_local_words(code, data, cuda), code.encode_np(data))


@pytest.mark.gpu
@pytest.mark.parametrize("l", [8, 16])
def test_lrc_repair_on_cuda_equals_repair_np(cuda, l):
    from repro_torch.kernels.gf_encode import kernel
    code = codes.make("lrc", 16, 11, l=l)
    objects = np.stack([payload(code, B=gf.LANES[l] * 8 * 40, seed=s) for s in range(3)])
    cw = np.stack([code.encode_np(o) for o in objects])
    lost = 4
    ids = [i for i in range(16) if i != lost]
    kernel.reset_launch_counts()
    got = repair.pipelined_repair(code, ids, cw[0, ids], [lost], 8, device=cuda)
    # the helpers' chain is one launch, its sums kept in registers
    assert kernel.launch_counts()["repair_chain"] == 1
    assert kernel.launch_counts()["repair_tick"] == 0
    np.testing.assert_array_equal(got.cpu().numpy(), code.repair_np([lost], ids, cw[0, ids]))
    star = repair.star_repair(code, ids, cw[0, ids], [lost], device=cuda)
    np.testing.assert_array_equal(star.cpu().numpy(), cw[0, [lost]])
    many = repair.pipelined_repair_many(code, ids, cw[:, ids], [lost], 8, 1, device=cuda)
    np.testing.assert_array_equal(many.cpu().numpy(), cw[:, [lost]])
