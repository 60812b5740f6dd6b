"""Static-coefficient encode ops of the PyTorch port vs the JAX package.

On the CPU the port's ops run the kernels' plain versions; the JAX ops run
their Pallas kernels in interpret mode, as ``tests/test_kernels.py`` does.
Tests marked ``gpu`` hold the bit-plane (``gf_encode``) and bit-lift
(``gf_encode_mxu``) CUDA kernels against their plain versions and skip
without a card. Words are integers: every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gf  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp
    from repro.kernels.gf_encode import kernel as jkernel
    from repro.kernels.gf_encode import ops as jops
    from repro.kernels.gf_encode import ref as jref
except ImportError:
    jnp = None


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


def coeffs(rng, rows, k, l):
    M = rng.integers(0, 1 << l, size=(rows, k))
    M[0, 0] = 0                       # a zero coefficient: all its planes zero
    return M


def as_np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n,k", [(8, 4), (16, 11)])
@pytest.mark.parametrize("l", [8, 16])
def test_encode_packed_and_words_match_jax(l, n, k, batched):
    """The bit-plane encode at an odd packed length (Bp = 499), one object
    or a batch of 3, against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(10 + n)
    M = coeffs(rng, n - k, k, l)
    shape = (3, k, 499 * gf.LANES[l]) if batched else (k, 499 * gf.LANES[l])
    data = words(rng, shape, l)
    got = ops.encode_words(M, torch.from_numpy(data), l)
    want = jops.encode_words(M, jnp.asarray(data), l)
    assert got.dtype == gf.TORCH_WORD_DTYPE[l]
    np.testing.assert_array_equal(as_np(got), np.asarray(want))
    packed = data.view(np.uint32)
    got_p = ops.encode_packed(M, torch.from_numpy(packed.view(np.int32)), l)
    want_p = jops.encode_packed(M, jnp.asarray(packed), l)
    np.testing.assert_array_equal(as_np(got_p).view(np.uint32), np.asarray(want_p))


@pytest.mark.parametrize("B", [1024, 998, 1000, 1002])
@pytest.mark.parametrize("l", [8, 16])
def test_encode_mxu_matches_jax(l, B):
    rng = np.random.default_rng(B + l)
    M = coeffs(rng, 5, 11, l)
    data = words(rng, (11, B), l)
    got = ops.encode_mxu(M, torch.from_numpy(data), l)
    want = np.asarray(jops.encode_mxu(M, jnp.asarray(data), l))
    assert got.dtype == gf.TORCH_WORD_DTYPE[l] and want.dtype == gf.WORD_DTYPE[l]
    np.testing.assert_array_equal(as_np(got), want)


@pytest.mark.parametrize("l", [8, 16])
def test_encode_mxu_any_batches_on_the_word_axis(l):
    rng = np.random.default_rng(20 + l)
    M = coeffs(rng, 4, 4, l)
    data = words(rng, (3, 4, 1000), l)
    got = ops._encode_mxu_any(M, torch.from_numpy(data), l)
    want = np.asarray(jops._encode_mxu_any(M, jnp.asarray(data), l))
    assert got.dtype == gf.TORCH_WORD_DTYPE[l] and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(as_np(got), want)
    two_d = ops._encode_mxu_any(M, torch.from_numpy(data[1]), l)
    np.testing.assert_array_equal(as_np(two_d), want[1])


@pytest.mark.parametrize("rows,k", [(5, 11), (16, 11), (3, 4)])
@pytest.mark.parametrize("l", [8, 16])
def test_bitlift_matrix_matches_jax(l, rows, k):
    M = coeffs(np.random.default_rng(rows * k), rows, k, l)
    got = kernel.bitlift_matrix(M, l)
    np.testing.assert_array_equal(got, jkernel.bitlift_matrix(M, l))
    padded = kernel.padded_bitlift(M, l)
    assert padded.shape[0] % 16 == 0 and padded.shape[1] % 32 == 0
    np.testing.assert_array_equal(padded[:rows * l, :k * l], got)
    assert not padded[rows * l:].any() and not padded[:, k * l:].any()


@pytest.mark.parametrize("preferred", [None, 64, 1024])
def test_pick_block_matches_jax(preferred):
    for Bp in (1, 2, 3, 5, 63, 64, 65, 499, 511, 512, 513, 1 << 24):
        args = (Bp,) if preferred is None else (Bp, preferred)
        assert ops.pick_block(*args) == jops.pick_block(*args)


@pytest.mark.parametrize("l", [8, 16])
def test_refs_match_jax_refs(l):
    rng = np.random.default_rng(30 + l)
    M = coeffs(rng, 5, 11, l)
    data = words(rng, (11, 64 * gf.LANES[l]), l)
    batch = words(rng, (3, 11, 64 * gf.LANES[l]), l)
    packed, packed_b = data.view(np.uint32), batch.view(np.uint32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
    np.testing.assert_array_equal(
        as_np(ref.encode_packed_ref(M, t(packed), l)).view(np.uint32),
        np.asarray(jref.encode_packed_ref(M, jnp.asarray(packed), l)))
    np.testing.assert_array_equal(
        as_np(ref.encode_packed_many_ref(M, t(packed_b), l)).view(np.uint32),
        np.asarray(jref.encode_packed_many_ref(M, jnp.asarray(packed_b), l)))
    np.testing.assert_array_equal(
        as_np(ref.encode_words_ref(M, torch.from_numpy(data), l)),
        np.asarray(jref.encode_words_ref(M, jnp.asarray(data), l)))
    np.testing.assert_array_equal(
        as_np(ref.bitlift_encode_ref(M, torch.from_numpy(data[:, 1:]), l)),
        np.asarray(jref.bitlift_encode_ref(M, jnp.asarray(data[:, 1:]), l)))


def test_bitlift_ref_walks_columns_in_chunks(monkeypatch):
    rng = np.random.default_rng(40)
    M = coeffs(rng, 3, 4, 8)
    data = torch.from_numpy(words(rng, (4, 1001), 8))
    whole = ref.bitlift_encode_ref(M, data, 8)
    monkeypatch.setattr(ref, "BITLIFT_CHUNK", 128)
    assert torch.equal(ref.bitlift_encode_ref(M, data, 8), whole)
    np.testing.assert_array_equal(as_np(whole), gf.gf_matmul_np(M, as_np(data), 8))


def test_encode_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """The CUDA wrappers never compute on the CPU: they raise before building."""
    z = lambda *s, dtype=torch.int32: torch.zeros(s, dtype=dtype)
    before, compiles = kernel.launch_counts(), kernel.gf_encode.compiles
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gf_encode(z(1, 4, 8), np.ones((2, 4), np.int64), z(1, 2, 8), 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gf_encode_mxu(z(4, 8, dtype=torch.uint8), z(16, 32, dtype=torch.int8),
                             z(2, 8, dtype=torch.uint8), 8)
    with pytest.raises(ValueError, match="CUDA"):       # past the old 256-bit cap
        kernel.gf_encode_mxu(z(11, 8, dtype=torch.uint16),
                             torch.from_numpy(kernel.mxu_operand(np.ones((17, 11)), 16)),
                             z(17, 8, dtype=torch.uint16), 16)
    assert kernel.launch_counts() == before and kernel.gf_encode.compiles == compiles
    assert set(before) == {"chain_tick", "repair_tick", "repair_chain", "encode_chain",
                           "gf_encode", "gf_encode_mxu"}
    with pytest.raises(ValueError):
        ops.encode_packed(np.ones((2, 3), np.int64), z(4, 8), 8)
    with pytest.raises(ValueError):
        ops.encode_mxu(np.ones((2, 3), np.int64), z(3, 8, dtype=torch.uint16), 8)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("O", [1, 3])
@pytest.mark.parametrize("rows,k", [(5, 11), (16, 11), (3, 4), (20, 4)])
@pytest.mark.parametrize("l", [8, 16])
def test_gf_encode_kernel_matches_plain(cuda, l, rows, k, O):
    """Ragged Bp = 499, row counts past one register group (20 > 16)."""
    rng = np.random.default_rng(50 + rows + O)
    M = coeffs(rng, rows, k, l)
    data = torch.from_numpy(words(rng, (O, k, 499 * gf.LANES[l]), l).view(np.int32))
    x = data.to(cuda)
    before = kernel.gf_encode.launches
    got = ops.encode_packed(M, x, l)
    want = ref.encode_packed_many_ref(M, x, l)
    torch.cuda.synchronize()
    assert kernel.gf_encode.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), ops.encode_packed(M, data, l))
    small = ops.encode_packed(M, x[0, :, :5], l)          # a 5-lane launch
    assert torch.equal(small, ref.encode_packed_ref(M, x[0, :, :5], l))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [998, 1000, 1002])
@pytest.mark.parametrize("rows,k", [(5, 11), (16, 11), (3, 4)])
@pytest.mark.parametrize("l", [8, 16])
def test_gf_encode_mxu_kernel_matches_plain(cuda, l, rows, k, B):
    rng = np.random.default_rng(60 + rows + B)
    M = coeffs(rng, rows, k, l)
    data = torch.from_numpy(words(rng, (k, B), l))
    x = data.to(cuda)
    before = kernel.gf_encode_mxu.launches
    got = ops.encode_mxu(M, x, l)
    want = ref.bitlift_encode_ref(M, x, l)
    torch.cuda.synchronize()
    assert kernel.gf_encode_mxu.launches == before + 1
    assert got.dtype == gf.TORCH_WORD_DTYPE[l]
    assert torch.equal(got.to(torch.int32), want.to(torch.int32))
    np.testing.assert_array_equal(got.cpu().numpy(), gf.gf_matmul_np(M, data.numpy(), l))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mxu (17, 11)", "mxu (2, 17)", "packed (12, 64)"])
def test_kernels_run_matrices_past_their_old_limits(cuda, case):
    """Matrices the kernels once refused (over 256 lifted rows or columns;
    planes past 48 KB) run through the kernels, with ragged B and Bp, and
    equal the plain versions."""
    kind, shape = case.split(" ", 1)
    rows, k = (int(v) for v in shape.strip("()").split(","))
    rng = np.random.default_rng(rows * k)
    M = coeffs(rng, rows, k, 16)
    before = kernel.launch_counts()
    if kind == "mxu":
        for B in (998, 1002):
            x = torch.from_numpy(words(rng, (k, B), 16)).to(cuda)
            got, want = ops.encode_mxu(M, x, 16), ref.bitlift_encode_ref(M, x, 16)
            assert torch.equal(got.to(torch.int32), want.to(torch.int32))
        assert kernel.gf_encode_mxu.launches == before["gf_encode_mxu"] + 2
    else:
        for Bp in (499, 500):
            x = torch.from_numpy(words(rng, (k, 2 * Bp), 16).view(np.int32)).to(cuda)
            assert torch.equal(ops.encode_packed(M, x, 16), ref.encode_packed_ref(M, x, 16))
        assert kernel.gf_encode.launches == before["gf_encode"] + 2
