"""The encode tick's product tables and slot table against the JAX package.

``chain_tick`` multiplies by table lookup: per (node, slot) the host builds
tables of the products of every byte value by the slot's xi and psi
coefficients, and the kernel reads the replica blocks in place through the
slot table. These tests hold the tables against the JAX package's field,
replay the kernel's lookup arithmetic (one lookup per byte of a word, and
the byte permutes that split the packed products) as a plain torch function
against the plain version and the JAX chain step, and check that the
encode entry point reads the object's blocks where they lie. Tests marked
``gpu`` hold the kernel against its plain version and skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gf, pipeline, rapidraid as rr  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402
from repro_torch.storage import chain  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp
    from repro.core import gf as jgf
    from repro.core import rapidraid as jrr
    from repro.kernels.gf_encode import ops as jops
except ImportError:
    jnp = None

CODES = [(8, 4, 8), (6, 4, 16), (16, 11, 16)]
KEPT, FWD, INTERLEAVE = 0x5410, 0x7632, 0x6240   # the kernel's byte-permute selectors


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def lanes(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def t32(x: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(device)


def u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).view(np.uint32)


def tick_case(rng, l, max_b, n=5, O=2, chunks=3, S=37, R=4):
    """Operands of one tick: blocks read through slots, a padded slot (-1)
    and a last node without psi."""
    wire_in = lanes(rng, (n + 1, O, S))
    src = lanes(rng, (O, R, S * chunks))
    slots = rng.integers(0, R, size=(n, max_b)).astype(np.int32)
    psi = rng.integers(1, 1 << l, size=(n, max_b))
    xi = rng.integers(1, 1 << l, size=(n, max_b))
    slots[n - 2, max_b - 1] = -1
    psi[n - 2, max_b - 1] = xi[n - 2, max_b - 1] = 0
    psi[n - 1] = 0
    tables = kernel.product_tables(gf.bitplane_table(psi, l), gf.bitplane_table(xi, l), l)
    return wire_in, src, slots, psi, xi, tables


@pytest.mark.parametrize("n,k,l", CODES)
def test_product_tables_are_gf_products(n, k, l):
    """Entry [i, s, j, v] of a code's tables is xi * (v << 8j) in the low
    half and psi * (v << 8j) in the high half, in the JAX package's field."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    jcode = jrr.RapidRAIDCode.make(n, k, l=l, seed=13)
    tables = chain.product_tables(code)
    assert tables.shape == (n, jcode.chain.max_blocks, l // 8, 256)
    assert tables.dtype == np.uint32 and not tables.flags.writeable
    assert chain.product_tables(code) is tables                  # cached per code
    xi = jcode.chain.xi.astype(np.int64)[:, :, None, None]
    psi = jcode.chain.psi.astype(np.int64)[:, :, None, None]
    v = np.arange(256)[None, :] << (8 * np.arange(l // 8))[:, None]   # (l // 8, 256)
    want = (jgf.gf_mul_np(xi, v, l).astype(np.uint32)
            | jgf.gf_mul_np(psi, v, l).astype(np.uint32) << 16)
    np.testing.assert_array_equal(tables, want)
    # the plain version reads only the single-bit entries: the JAX planes
    got_psi, got_xi = ref.table_planes(t32(np.array(tables)), l)
    np.testing.assert_array_equal(got_psi.numpy(), jgf.bitplane_table(jcode.chain.psi, l))
    np.testing.assert_array_equal(got_xi.numpy(), jgf.bitplane_table(jcode.chain.xi, l))


@pytest.mark.parametrize("l", [8, 16])
def test_product_tables_refuse_planes_outside_the_field(l):
    planes = gf.bitplane_table(np.array([[3]]), l)
    with pytest.raises(ValueError):
        kernel.product_tables(planes, planes[..., :-1], l)
    bad = planes.copy()
    bad[0, 0, 0] = 1 << l
    with pytest.raises(ValueError):
        kernel.product_tables(bad, planes, l)


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's ``__byte_perm`` on uint32 values held in int64: byte m of the
    result is byte ``(sel >> 4m) & 7`` of the 8 bytes {y:x}."""
    src = [(x >> (8 * b)) & 0xFF for b in range(4)] + [(y >> (8 * b)) & 0xFF for b in range(4)]
    return sum(src[(sel >> (4 * m)) & 7] << (8 * m) for m in range(4))


def table_tick(wire_in, wire_out, src, slots, out, tables, l, t, num_chunks,
               node_lo, node_count):
    """The kernel's arithmetic as plain torch: per word of a lane, the xor of
    its bytes' table entries over the node's slots, then the
    byte permutes that split the kept and forwarded halves into lanes."""
    O, R, Bp = src.shape
    n, max_b = slots.shape
    S = Bp // num_chunks
    words = 32 // l
    tab = torch.from_numpy(u32(tables).astype(np.int64))
    for i in range(node_lo, node_lo + node_count):
        ch = t - i
        x = wire_in[i].long() & 0xFFFFFFFF                           # (O, S)
        e = [torch.zeros_like(x) for _ in range(words)]
        for s in range(max_b):
            if slots[i, s] < 0:
                continue
            v = src[:, slots[i, s], ch * S:(ch + 1) * S].long() & 0xFFFFFFFF
            for w in range(words):
                for j in range(l // 8):
                    e[w] ^= tab[i, s, j][(v >> (w * l + 8 * j)) & 0xFF]
        if l == 16:
            kept, fwd = byte_perm(e[0], e[1], KEPT), byte_perm(e[0], e[1], FWD)
        else:
            lo, hi = byte_perm(e[0], e[1], INTERLEAVE), byte_perm(e[2], e[3], INTERLEAVE)
            kept, fwd = byte_perm(lo, hi, KEPT), byte_perm(lo, hi, FWD)
        out[i, :, ch * S:(ch + 1) * S] = (x ^ kept).to(torch.int32)
        if i + 1 < wire_out.shape[0]:
            wire_out[i + 1] = (x ^ fwd).to(torch.int32)


@pytest.mark.parametrize("wire_rows", ["n", "n+1"])
@pytest.mark.parametrize("max_b", [1, 2])
@pytest.mark.parametrize("l", [8, 16])
def test_table_arithmetic_matches_plain_version_and_jax(l, max_b, wire_rows):
    """The lookup arithmetic == ``ref.chain_tick_ref`` (the bit-plane math
    over gathered blocks) == the JAX chain step of every active node. At
    tick 4 the last node is active: an n-row wire drops its forward."""
    rng = np.random.default_rng(21)
    n, O, chunks, S, t = 5, 2, 3, 37, 4
    wire_in, src, slots, psi, xi, tables = tick_case(rng, l, max_b, n, O, chunks, S)
    lo, count = pipeline.active_nodes(t, n, chunks)
    rows = n if wire_rows == "n" else n + 1
    results = []
    for fn in (ref.chain_tick_ref, table_tick):
        out = torch.zeros((n, O, S * chunks), dtype=torch.int32)
        wire_out = torch.zeros((rows, O, S), dtype=torch.int32)
        fn(t32(wire_in), wire_out, t32(src), slots, out, t32(tables), l, t, chunks,
           lo, count)
        results.append((u32(out), u32(wire_out)))
    for got, want in zip(results[1], results[0]):
        np.testing.assert_array_equal(got, want)
    out, wire_out = results[0]
    bp_psi, bp_xi = gf.bitplane_table(psi, l), gf.bitplane_table(xi, l)
    for i in range(lo, lo + count):
        sl = slice((t - i) * S, (t - i + 1) * S)
        local = np.where(slots[i][None, :, None] >= 0, src[:, slots[i].clip(0), sl], 0)
        jc, jxo = jops.chain_step(jnp.asarray(wire_in[i][:, None]), jnp.asarray(local),
                                  jnp.asarray(bp_psi[i]), jnp.asarray(bp_xi[i]), l, block=S)
        np.testing.assert_array_equal(out[i][:, sl], np.asarray(jc)[:, 0])
        if i + 1 < rows:
            np.testing.assert_array_equal(wire_out[i + 1], np.asarray(jxo)[:, 0])
    assert not wire_out[:lo + 1].any()     # rows no active node writes stay as they were


@pytest.mark.parametrize("n,k,l,chunks", [(8, 4, 8, 4), (6, 4, 16, 3), (16, 11, 16, 8)])
def test_pipelined_encode_reads_blocks_in_place(n, k, l, chunks, monkeypatch):
    """The CPU encode equals ``encode_np`` and the tick oracle; every tick
    reads the caller's object where it lies (no placement copy) and the
    wire has n rows."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    jcode = jrr.RapidRAIDCode.make(n, k, l=l, seed=13)
    data = np.random.default_rng(2).integers(0, 1 << l, size=(k, chunks * gf.LANES[l] * 8))
    words = torch.from_numpy(data.astype(gf.WORD_DTYPE[l]))
    seen = []
    tick = chain.ops.chain_tick

    def spy(wire_in, wire_out, src, *rest):
        seen.append((src.data_ptr(), tuple(src.shape), wire_out.shape[0]))
        return tick(wire_in, wire_out, src, *rest)

    monkeypatch.setattr(chain.ops, "chain_tick", spy)
    got = chain.pipelined_encode(code, words, num_chunks=chunks, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jcode.encode_np(data.astype(gf.WORD_DTYPE[l])))
    want, ticks = jrr.pipeline_encode_local(jcode, data.astype(gf.WORD_DTYPE[l]),
                                            num_chunks=chunks)
    np.testing.assert_array_equal(got.numpy(), want)
    Bp = words.shape[1] // gf.LANES[l]
    assert seen == [(words.data_ptr(), (1, k, Bp), n)] * ticks


def test_chain_tick_refuses_bad_slots():
    for slots in (np.array([[0], [4]]), np.array([[0], [-2]]), np.zeros((2, 513), np.int32),
                  np.zeros((2, 0), np.int32), np.array([[0.0], [1.0]])):
        with pytest.raises(ValueError, match="slots"):
            kernel._check_slots("chain_tick", slots, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("wire_rows", ["n", "n+1"])
@pytest.mark.parametrize("O", [1, 2])
@pytest.mark.parametrize("S", [37, 1000, 1002, 1037])
@pytest.mark.parametrize("max_b", [1, 2])
@pytest.mark.parametrize("l", [8, 16])
def test_chain_tick_kernel_matches_plain_ragged(cuda, l, max_b, S, O, wire_rows):
    """The kernel on the card == the plain version, at ragged lane counts
    (16-byte lanes at S = 1000, single lanes at 37, 1002 and 1037), with
    the last node active and a wire of n rows (its forward dropped) or
    n + 1 (kept)."""
    rng = np.random.default_rng(23)
    n, chunks, t = 5, 3, 4
    wire_in, src, slots, _, _, tables = tick_case(rng, l, max_b, n, O, chunks, S)
    lo, count = pipeline.active_nodes(t, n, chunks)
    args = (t32(wire_in, cuda), t32(src, cuda), slots, t32(tables, cuda))
    rows = n if wire_rows == "n" else n + 1
    results = []
    for fn, launched in ((kernel.chain_tick, 1), (ref.chain_tick_ref, 0)):
        out = torch.zeros((n, O, S * chunks), dtype=torch.int32, device=cuda)
        wire_out = torch.zeros((rows, O, S), dtype=torch.int32, device=cuda)
        before = kernel.chain_tick.launches
        fn(args[0], wire_out, args[1], slots, out, args[3], l, t, chunks, lo, count)
        assert kernel.chain_tick.launches == before + launched
        results.append((out, wire_out))
    torch.cuda.synchronize()
    for got, want in zip(*results):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,l,chunks", [(8, 4, 8, 4), (16, 11, 16, 8)])
def test_pipelined_encode_on_cuda_reads_blocks_in_place(cuda, n, k, l, chunks, monkeypatch):
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    data = np.random.default_rng(3).integers(0, 1 << l, size=(k, chunks * gf.LANES[l] * 300))
    data = data.astype(gf.WORD_DTYPE[l])
    words = torch.from_numpy(data).to(cuda)
    seen = []
    launch = chain.ops._encode_chain_cuda

    def spy(src, *rest):
        seen.append(src.data_ptr())
        return launch(src, *rest)

    monkeypatch.setattr(chain.ops, "_encode_chain_cuda", spy)
    kernel.reset_launch_counts()
    got = chain.pipelined_encode(code, words, num_chunks=chunks)
    # one encode_chain launch, on the words' own lanes: nothing gathered
    assert kernel.encode_chain.launches == 1 and kernel.chain_tick.launches == 0
    assert seen == [words.data_ptr()]
    np.testing.assert_array_equal(got.cpu().numpy(), code.encode_np(data))


@pytest.mark.gpu
@pytest.mark.parametrize("l", [8, 16])
def test_chain_step_on_cuda_matches_plain(cuda, l):
    rng = np.random.default_rng(24)
    x_in, local = lanes(rng, (2, 1, 1000)), lanes(rng, (2, 2, 1000))
    bp_psi = gf.bitplane_table(rng.integers(1, 1 << l, size=2), l)
    bp_xi = gf.bitplane_table(rng.integers(1, 1 << l, size=2), l)
    got = ops.chain_step(t32(x_in, cuda), t32(local, cuda), t32(bp_psi, cuda),
                         t32(bp_xi, cuda), l)
    want = ops.chain_step(t32(x_in), t32(local), t32(bp_psi), t32(bp_xi), l)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
