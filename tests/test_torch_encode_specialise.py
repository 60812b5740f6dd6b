"""The per-matrix bit-plane encode and the wgmma bit-lift layout of the port.

CPU tests: matrices past the size limits the port's kernels once had run
through the CPU routes and equal the JAX package's ops bit for bit; the
specialised ``gf_encode`` source holds exactly the matrix's nonzero plane
terms, computes the encode when its body is evaluated, and is cached under a
key that follows the matrix, the field and the template; the bit-lift's
shared-memory operand is the padded lifted matrix, and the kernel's index
arithmetic (register fragments, wgmma descriptors, epilogue), replayed in
numpy, computes the encode. Tests marked ``gpu`` run the same matrices through the
CUDA kernels and skip without a card.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gf  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402

try:  # the reference; a machine with only the port installed runs the rest
    import jax.numpy as jnp
    from repro.kernels.gf_encode import ops as jops
except ImportError:
    jnp = None

PAST_CAPS_MXU = [(17, 11), (2, 17)]      # lift past 256 rows / 256 columns at l = 16
PAST_CAPS_PACKED = (12, 64)              # planes past 48 KB at l = 16


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def coeffs(rng, rows, k, l):
    M = rng.integers(0, 1 << l, size=(rows, k))
    M[0, 0] = 0                       # a zero coefficient: all its planes zero
    return M


def words(rng, shape, l):
    return rng.integers(0, 1 << l, size=shape).astype(gf.WORD_DTYPE[l])


# ---------------------------------------------------------------------------
# past the old caps, on the CPU routes, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,k", PAST_CAPS_MXU)
def test_encode_mxu_past_old_cap_matches_jax(jax_ref, rows, k):
    rng = np.random.default_rng(rows * 100 + k)
    M = coeffs(rng, rows, k, 16)
    data = words(rng, (k, 1002), 16)
    got = ops.encode_mxu(M, torch.from_numpy(data), 16)
    want = np.asarray(jops.encode_mxu(M, jnp.asarray(data), 16))
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_packed_past_old_cap_matches_jax(jax_ref):
    """(12, 64) at l = 16: 12,288 plane terms, the JAX kernel in interpret mode."""
    rows, k = PAST_CAPS_PACKED
    rng = np.random.default_rng(1264)
    M = coeffs(rng, rows, k, 16)
    packed = words(rng, (k, 2 * 37), 16).view(np.uint32)       # Bp = 37, ragged
    got = ops.encode_packed(M, torch.from_numpy(packed.view(np.int32)), 16)
    want = np.asarray(jops.encode_packed(M, jnp.asarray(packed), 16))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ---------------------------------------------------------------------------
# the specialised gf_encode source
# ---------------------------------------------------------------------------

_TERM = re.compile(r"T([12])\(a(\d+), m(\d+)_(\d+), 0x([0-9a-f]+)u"
                   r"(?:, m(\d+)_(\d+), 0x([0-9a-f]+)u)?\)")


def source_terms(src: str) -> list[tuple[int, int, int, int]]:
    """(row, input, bit, constant) of every term call in a generated source."""
    terms = []
    for m in _TERM.finditer(src):
        n, r = int(m.group(1)), int(m.group(2))
        terms.append((r, int(m.group(3)), int(m.group(4)), int(m.group(5), 16)))
        if n == 2:
            terms.append((r, int(m.group(6)), int(m.group(7)), int(m.group(8), 16)))
    return terms


def evaluate_body(src: str, x: np.ndarray, rows: int, l: int) -> np.ndarray:
    """Run the generated body's statements in numpy on (k, Bp) uint32 lanes."""
    body = src[src.index("long long Bp) {"):src.index("// data (O, GF_K")]
    env, out = {}, np.zeros((rows, x.shape[1]), dtype=np.uint64)
    x = x.astype(np.uint64)
    for line in body.splitlines():
        line = line.strip()
        if m := re.fullmatch(r"u32 (a\d+) = 0;", line):
            env[m.group(1)] = np.zeros(x.shape[1], dtype=np.uint64)
        elif m := re.fullmatch(r"LOAD\(nx, (\d+)\)", line):
            env["nx"] = x[int(m.group(1))]
        elif line == "const u32 v = nx;" or re.fullmatch(r"case \d+: \{", line):
            env["v"] = env["nx"]                        # the loop's next input row
        elif m := re.fullmatch(r"MASK\((m\d+_\d+), (\d+)\)", line):
            env[m.group(1)] = (env["v"] >> np.uint64(int(m.group(2)))) & np.uint64(gf.LSB_MASK[l])
        elif m := _TERM.fullmatch(line):
            acc = "a" + m.group(2)
            env[acc] ^= (env[f"m{m.group(3)}_{m.group(4)}"] * np.uint64(int(m.group(5), 16)))
            if m.group(1) == "2":
                env[acc] ^= env[f"m{m.group(6)}_{m.group(7)}"] * np.uint64(int(m.group(8), 16))
            env[acc] &= np.uint64(0xFFFFFFFF)
        elif m := re.fullmatch(r"STORE\((\d+), (a\d+)\)", line):
            out[int(m.group(1))] = env[m.group(2)]
    return out.astype(np.uint32)


@pytest.mark.parametrize("rows,k,l", [(5, 11, 16), (16, 11, 16), (20, 4, 8), (3, 4, 8)])
def test_encode_source_holds_exactly_the_nonzero_planes(rows, k, l):
    rng = np.random.default_rng(rows + k + l)
    M = coeffs(rng, rows, k, l)
    M[rows - 1, :] = 0                # a row with no term at all
    planes = gf.bitplane_table(M, l)
    want = sorted((r, j, b, int(planes[r, j, b])) for r, j, b in zip(*np.nonzero(planes)))
    src = kernel.encode_source(M, l)
    assert sorted(source_terms(src)) == want
    assert f"#define GF_ROWS {rows}" in src and f"#define GF_K {k}" in src
    # every row is stored once; a mask exists only where some row of its group uses it
    assert sorted(int(r) for r in re.findall(r"STORE\((\d+), a", src)) \
        == list(range(rows))
    masks = re.findall(r"MASK\(m(\d+)_(\d+),", src)
    used = {(j, b) for _, j, b, _ in want}
    assert {(int(j), int(b)) for j, b in masks} == used
    assert len(masks) == len({(j, b, g) for j, b, g in _group_masks(planes)})


def _group_masks(planes):
    rows = planes.shape[0]
    for g0 in range(0, rows, kernel.ENCODE_ROW_GROUP):
        sub = planes[g0:g0 + kernel.ENCODE_ROW_GROUP]
        for j, b in zip(*np.nonzero(sub.any(axis=0))):
            yield j, b, g0


@pytest.mark.parametrize("rows,k,l", [(5, 11, 16), (20, 4, 8), (3, 7, 8)])
def test_encode_source_body_computes_the_encode(rows, k, l):
    rng = np.random.default_rng(7 * rows + k)
    M = coeffs(rng, rows, k, l)
    x = rng.integers(0, 1 << 32, size=(k, 40), dtype=np.uint64).astype(np.uint32)
    got = evaluate_body(kernel.encode_source(M, l), x, rows, l)
    want = ref.encode_packed_ref(M, torch.from_numpy(x.view(np.int32)), l).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_encode_key_changes_with_matrix_field_and_template():
    M = coeffs(np.random.default_rng(3), 5, 11, 8)
    base = kernel.encode_key(M, 8)
    assert kernel.encode_key(M.copy(), 8) == base
    M2 = M.copy()
    M2[1, 2] ^= 1
    template = kernel.ENCODE_TEMPLATE.read_text()
    others = [kernel.encode_key(M2, 8), kernel.encode_key(M, 16),
              kernel.encode_key(M, 8, template=template + "\n// changed\n"),
              kernel.encode_key(M, 8, flags=kernel.NVRTC_FLAGS + ("-lineinfo",))]
    assert kernel.encode_key(M, 8, template=template) == base
    assert len({base, *others}) == len(others) + 1


# ---------------------------------------------------------------------------
# the bit-lift's shared-memory operand and the kernel's index arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,k,l", [(5, 11, 8), (16, 11, 16), (17, 11, 16), (2, 17, 16),
                                      (3, 4, 8), (9, 2, 8), (5, 11, 16)])
def test_mxu_operand_unswizzles_to_padded_bitlift(rows, k, l):
    M = coeffs(np.random.default_rng(rows * k), rows, k, l)
    image = kernel.mxu_operand(M, l)
    nt, n_tiles, K_pad = kernel.mxu_tiling(rows, k, l)
    assert image.dtype == np.int8 and image.shape == (K_pad // 32, n_tiles, nt // 8, 2, 8, 16)
    assert nt in (64, 128, 256) and nt * n_tiles >= rows * l and (nt * n_tiles) % 64 == 0
    full = kernel.mxu_operand_lifted(image, rows, l)
    padded = kernel.padded_bitlift(M, l)
    np.testing.assert_array_equal(full[:padded.shape[0], :padded.shape[1]], padded)
    assert not full[padded.shape[0]:].any() and not full[:, padded.shape[1]:].any()
    order = kernel.mxu_row_order(rows, l)
    assert sorted(order) == list(range(nt * n_tiles))


def emulate_mxu(M: np.ndarray, x: np.ndarray, l: int) -> np.ndarray:
    """gf_mxu.cu's index arithmetic in numpy: each thread's register
    fragments of the bits (wgmma's A operand: rows g and g + 8 of its warp,
    k bytes 4t.. and 16 + 4t.. of each k-step), the lifted matrix read
    through the descriptor's core matrices (LBO 128 B, SBO 256 B), and the
    epilogue's register-to-word mapping."""
    rows, k = M.shape
    nt, n_tiles, K_pad = kernel.mxu_tiling(rows, k, l)
    npad, B, RT = nt * n_tiles, x.shape[1], nt // (4 * l)
    image = kernel.mxu_operand(M, l).reshape(-1).astype(np.int64)
    kk, n = np.arange(32), np.arange(nt)
    out = np.zeros((rows, B), dtype=np.int64)
    for c0 in range(0, B, 64):
        bits = np.full((64, K_pad), -99, dtype=np.int64)     # every byte set below
        for w, g, t in np.ndindex(4, 8, 4):
            col = c0 + 16 * w + 2 * g
            for ks, half in np.ndindex(K_pad // 32, 2):
                kb = ks * 32 + 16 * half + 4 * t
                j, sh = kb // l, kb % l
                for h in range(2):                            # fragment rows g, g + 8
                    v = int(x[j, col + h]) if j < k and col + h < B else 0
                    bits[16 * w + g + 8 * h, kb:kb + 4] = (v >> (sh + np.arange(4))) & 1
        for t_n in range(n_tiles):
            D = np.zeros((64, nt), dtype=np.int64)
            for ks in range(K_pad // 32):
                b_op = image[ks * npad * 32 + t_n * nt * 32 + (n[:, None] >> 3) * 256
                             + (kk >> 4) * 128 + (n[:, None] & 7) * 16 + (kk & 15)]
                D += bits[:, ks * 32:(ks + 1) * 32] @ b_op.T
            for w, g, t, rr in np.ndindex(4, 8, 4, RT):
                r = t_n * (nt // l) + t * RT + rr
                q = rr * l + np.arange(l)
                reg = 4 * (q >> 1) + (q & 1)                  # + 2 for the second word
                for h in range(2):
                    col_n = 8 * ((reg + 2 * h) >> 2) + 2 * t + ((reg + 2 * h) & 1)
                    word = int(((D[16 * w + g + 8 * h, col_n] & 1) << np.arange(l)).sum())
                    col = c0 + 16 * w + 2 * g + h
                    if r < rows and col < B:
                        out[r, col] = word
    return out


@pytest.mark.parametrize("rows,k,l,B", [(3, 4, 16, 70), (5, 11, 8, 100), (17, 3, 16, 64),
                                        (9, 2, 8, 65), (2, 17, 16, 64)])
def test_mxu_index_arithmetic_computes_the_encode(rows, k, l, B):
    rng = np.random.default_rng(rows + k + B)
    M = coeffs(rng, rows, k, l)
    x = rng.integers(0, 1 << l, size=(k, B))
    np.testing.assert_array_equal(emulate_mxu(M, x, l), gf.gf_matmul_np(M, x, l))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("B", [998, 1000, 1002, 64 * 1000 + 7])
@pytest.mark.parametrize("rows,k", PAST_CAPS_MXU)
def test_gf_encode_mxu_past_old_cap_matches_plain(cuda, rows, k, B):
    rng = np.random.default_rng(rows + k + B)
    M = coeffs(rng, rows, k, 16)
    data = torch.from_numpy(words(rng, (k, B), 16))
    x = data.to(cuda)
    before = kernel.gf_encode_mxu.launches
    got = ops.encode_mxu(M, x, 16)
    want = ref.bitlift_encode_ref(M, x, 16)
    torch.cuda.synchronize()
    assert kernel.gf_encode_mxu.launches == before + 1
    assert torch.equal(got.to(torch.int32), want.to(torch.int32))
    np.testing.assert_array_equal(got.cpu().numpy(), gf.gf_matmul_np(M, data.numpy(), 16))


@pytest.mark.gpu
@pytest.mark.parametrize("Bp", [499, 500, 4096 + 3])
def test_gf_encode_past_old_cap_matches_plain(cuda, Bp):
    rows, k = PAST_CAPS_PACKED
    rng = np.random.default_rng(Bp)
    M = coeffs(rng, rows, k, 16)
    x = torch.from_numpy(words(rng, (2, k, 2 * Bp), 16).view(np.int32)).to(cuda)
    before = kernel.gf_encode.launches
    got = ops.encode_packed(M, x, 16)
    want = ref.encode_packed_many_ref(M, x, 16)
    torch.cuda.synchronize()
    assert kernel.gf_encode.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_gf_encode_compiles_once_per_matrix(cuda):
    rng = np.random.default_rng(77)
    M = coeffs(rng, 4, 6, 8)
    M[1, 1] = 0xAB                    # unlike any other test's matrix
    x = torch.from_numpy(words(rng, (6, 4 * 256), 8).view(np.int32)).to(cuda)
    first = ops.encode_packed(M, x, 8)
    compiles, launches = kernel.gf_encode.compiles, kernel.gf_encode.launches
    again = ops.encode_packed(M, x, 8)
    torch.cuda.synchronize()
    assert kernel.gf_encode.compiles == compiles       # the second call builds nothing
    assert kernel.gf_encode.launches == launches + 1
    assert torch.equal(first, again) and torch.equal(again, ref.encode_packed_ref(M, x, 8))
    M2 = M.copy()
    M2[0, 1] ^= 1
    ops.encode_packed(M2, x, 8)
    assert len(kernel._encode_fns) >= 2


@pytest.mark.gpu
def test_gf_encode_mxu_raises_past_shared_memory(cuda):
    """A (48, 48) matrix over GF(2^16) lifts to 768 x 768 bits, 576 KB: past
    the 227 KB a block may use, the wrapper raises before launching."""
    M = np.ones((48, 48), np.int64)
    before = kernel.launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        ops.encode_mxu(M, torch.zeros((48, 64), dtype=torch.uint16, device=cuda), 16)
    assert kernel.launch_counts() == before
