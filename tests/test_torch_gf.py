"""PyTorch port of the GF(2^l) field vs the JAX package's ``repro.core.gf``.

GF words are integers, so every comparison is bit-exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gf as jgf  # noqa: E402
from repro.core import rapidraid as jrr  # noqa: E402
from repro_torch.core import gf  # noqa: E402

FIELDS = [8, 16]


def rand_words(rng, shape, l):
    return rng.integers(0, 1 << l, size=shape).astype(jgf.WORD_DTYPE[l])


def as_u32(x) -> np.ndarray:
    """Packed lanes of either package as a uint32 numpy view."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("l", FIELDS)
def test_host_tables_and_constants_match(l):
    exp_t, log_t = gf.gf_tables(l)
    exp_j, log_j = jgf.gf_tables(l)
    np.testing.assert_array_equal(exp_t, exp_j)
    np.testing.assert_array_equal(log_t, log_j)
    assert gf.PRIM_POLY[l] == jgf.PRIM_POLY[l]
    assert gf.LANES[l] == jgf.LANES[l] and gf.LSB_MASK[l] == jgf.LSB_MASK[l]
    assert gf.WORD_DTYPE[l] == jgf.WORD_DTYPE[l]


@pytest.mark.parametrize("l", FIELDS)
def test_host_scalar_ops_match(l):
    rng = np.random.default_rng(1)
    for a, b, e in rng.integers(1, 1 << l, size=(50, 3)):
        a, b, e = int(a), int(b), int(e)
        assert gf.gf_mul_scalar(a, b, l) == jgf.gf_mul_scalar(a, b, l)
        assert gf.gf_inv_scalar(a, l) == jgf.gf_inv_scalar(a, l)
        assert gf.gf_pow_scalar(a, e, l) == jgf.gf_pow_scalar(a, e, l)
        assert gf.bitplane_consts(a, l) == jgf.bitplane_consts(a, l)
    assert gf.gf_pow_scalar(0, 3, l) == jgf.gf_pow_scalar(0, 3, l)
    with pytest.raises(ZeroDivisionError):
        gf.gf_inv_scalar(0, l)


@pytest.mark.parametrize("l", FIELDS)
def test_host_matrix_ops_match(l):
    rng = np.random.default_rng(2)
    A = rand_words(rng, (6, 5), l)
    B = rand_words(rng, (5, 40), l)
    np.testing.assert_array_equal(gf.gf_mul_np(A, A, l), jgf.gf_mul_np(A, A, l))
    np.testing.assert_array_equal(gf.gf_matmul_np(A, B, l),
                                  jgf.gf_matmul_np(A, B, l))
    assert gf.gf_rank_np(A, l) == jgf.gf_rank_np(A, l)
    sq = rand_words(rng, (5, 5), l)
    np.testing.assert_array_equal(gf.gf_inv_matrix_np(sq, l),
                                  jgf.gf_inv_matrix_np(sq, l))
    np.testing.assert_array_equal(gf.bitplane_table(A, l),
                                  jgf.bitplane_table(A, l))


@pytest.mark.parametrize("l", FIELDS)
def test_pack_unpack_match_jax_bit_for_bit(l):
    rng = np.random.default_rng(3)
    words = rand_words(rng, (3, 64 * gf.LANES[l]), l)
    got = gf.pack_u32(torch.from_numpy(words), l)
    want = jgf.pack_u32(jnp.asarray(words), l)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(as_u32(got), as_u32(want))
    back = gf.unpack_u32(got, l)
    np.testing.assert_array_equal(back.numpy(), words)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jgf.unpack_u32(want, l)))


@pytest.mark.parametrize("l", FIELDS)
def test_pack_rejects_bad_words(l):
    lanes = gf.LANES[l]
    with pytest.raises(ValueError):
        gf.pack_u32(torch.zeros((2, lanes + 1), dtype=gf.TORCH_WORD_DTYPE[l]), l)
    with pytest.raises(ValueError):
        gf.pack_u32(torch.zeros((2, lanes), dtype=torch.int32), l)
    with pytest.raises(ValueError):
        gf.unpack_u32(torch.zeros((2, 4), dtype=torch.int64), l)


@pytest.mark.parametrize("l", FIELDS)
def test_mul_const_packed_matches_jax(l):
    rng = np.random.default_rng(4)
    lanes = rng.integers(0, 2 ** 32, size=(2, 256), dtype=np.uint32)
    for c in [0, 1, 2, int(rng.integers(3, 1 << l)), (1 << l) - 1]:
        got = gf.gf_mul_const_packed(torch.from_numpy(lanes.view(np.int32)), c, l)
        want = jgf.gf_mul_const_packed(jnp.asarray(lanes), c, l)
        np.testing.assert_array_equal(as_u32(got), as_u32(want))


@pytest.mark.parametrize("l", FIELDS)
@pytest.mark.parametrize("n,k", [(8, 4), (16, 11)])
def test_matvec_packed_matches_jax_and_field(l, n, k):
    code = jrr.RapidRAIDCode.make(n, k, l=l, seed=5)
    rng = np.random.default_rng(6)
    words = rand_words(rng, (k, 128 * gf.LANES[l]), l)
    got = gf.gf_matvec_packed(code.G, gf.pack_u32(torch.from_numpy(words), l), l)
    want = jgf.gf_matvec_packed(code.G, jgf.pack_u32(jnp.asarray(words), l), l)
    np.testing.assert_array_equal(as_u32(got), as_u32(want))
    np.testing.assert_array_equal(gf.unpack_u32(got, l).numpy(),
                                  code.encode_np(words))
