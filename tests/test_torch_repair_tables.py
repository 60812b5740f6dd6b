"""The decode and repair tick's product tables and row table against the JAX package.

``repair_tick`` multiplies by table lookup: per (node, row pack, byte) the
host builds a table of the products of every byte value by the coefficients
of a pack of rows (two rows at GF(2^16), four at GF(2^8)), and the kernel
reads the survivors' shards in place through a row table. These tests hold
the tables against the JAX package's field, replay the kernel's lookup
arithmetic (the lookups and the byte permutes that put each row's products
back into lanes) as plain torch against the plain version and the JAX
repair step, and check that the decode and repair entry points read the
shards where they lie. Tests marked ``gpu`` hold the kernel against its
plain version and skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gf, pipeline, rapidraid as rr  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402
from repro_torch.storage import chain, repair  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp
    from repro.core import gf as jgf
    from repro.core import rapidraid as jrr
    from repro.kernels.gf_encode import ops as jops
    from repro.storage import chain as jchain
    from repro.storage import repair as jrepair
except ImportError:
    jnp = None

CODES = [(8, 4, 8), (6, 4, 16), (16, 11, 16)]
GROUP_ROWS = 12   # rows the kernel carries in registers per step (gf_tick.cu kGroupRows)


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


def words(rng, shape, l):
    return rng.integers(0, 1 << l, size=shape).astype(gf.WORD_DTYPE[l])


def repair_case(rng, l, rows, n=4, O=2, chunks=3, S=29, R=6):
    """Operands of one tick: the shards (R, O, Bp) read through a row table
    that is not the identity, and the coefficients D (n, rows)."""
    wire_in = lanes(rng, (n, O, rows, S))
    shards = lanes(rng, (R, O, S * chunks))
    shard_rows = rng.permutation(R)[:n].astype(np.int32)
    D = rng.integers(1, 1 << l, size=(n, rows))
    D[0, 0] = 0                                        # a zero coefficient
    return wire_in, shards, shard_rows, D


def jax_tick(wire_in, shards, shard_rows, D, l, t, chunks, lo, count, head_zero=False):
    """The JAX repair step of every active node on its chunk: (out, wire_out)."""
    n, O, rows, S = wire_in.shape
    want_out = np.zeros((O, rows, S * chunks), np.uint32)
    want_wire = np.zeros((n, O, rows, S), np.uint32)
    for i in range(lo, lo + count):
        sl = slice((t - i) * S, (t - i + 1) * S)
        x = np.zeros_like(wire_in[i]) if head_zero and i == 0 else wire_in[i]
        acc = np.asarray(jops.repair_step(jnp.asarray(x),
                                          jnp.asarray(shards[shard_rows[i]][:, None, sl]),
                                          jnp.asarray(jgf.bitplane_table(D[i], l)), l,
                                          block=S))
        if i == n - 1:
            want_out[:, :, sl] = acc
        else:
            want_wire[i + 1] = acc
    return want_out, want_wire


@pytest.mark.parametrize("rows", [1, 2, 5, 11])
@pytest.mark.parametrize("l", [8, 16])
def test_repair_tables_are_gf_products(l, rows):
    """Entry [i, p, j, v] packs the products of (v << 8j) by the coefficients
    of rows (32 // l) * p + r, row r in bits [l * r, l * r + l), in the JAX
    package's field; rows past the last are zero."""
    rng = np.random.default_rng(rows)
    n, per = 3, 32 // l
    D = rng.integers(0, 1 << l, size=(n, rows))
    tables = kernel.repair_tables(gf.bitplane_table(D, l), l)
    packs = -(-rows // per)
    assert tables.shape == (n, packs, l // 8, 256) and tables.dtype == np.uint32
    assert kernel.repair_packs(rows, l) == packs
    v = np.arange(256)[None, :] << (8 * np.arange(l // 8))[:, None]    # (l // 8, 256)
    Dp = np.zeros((n, packs * per), np.int64)
    Dp[:, :rows] = D
    want = np.zeros((n, packs, l // 8, 256), np.uint32)
    for r in range(per):
        c = Dp[:, r::per][:, :, None, None]
        want |= jgf.gf_mul_np(c, v, l).astype(np.uint32) << np.uint32(l * r)
    np.testing.assert_array_equal(tables, want)
    # the plain version reads only the single-bit entries: the JAX planes
    got = ref.repair_table_planes(t32(tables), l, rows)
    np.testing.assert_array_equal(got.numpy(), jgf.bitplane_table(D, l))


@pytest.mark.parametrize("l", [8, 16])
def test_repair_tables_refuse_planes_outside_the_field(l):
    planes = gf.bitplane_table(np.array([[3, 5]]), l)
    with pytest.raises(ValueError):
        kernel.repair_tables(planes[..., :-1], l)
    bad = planes.copy()
    bad[0, 1, 0] = 1 << l
    with pytest.raises(ValueError):
        kernel.repair_tables(bad, l)


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's ``__byte_perm`` on uint32 values held in int64: byte m of the
    result is byte ``(sel >> 4m) & 7`` of the 8 bytes {y:x}."""
    src = [(x >> (8 * b)) & 0xFF for b in range(4)] + [(y >> (8 * b)) & 0xFF for b in range(4)]
    return sum(src[(sel >> (4 * m)) & 7] << (8 * m) for m in range(4))


def table_repair_tick(wire_in, wire_out, shards, shard_rows, out, tables, l, t,
                      num_chunks, node_lo, node_count, head_zero=False):
    """The kernel's arithmetic as plain torch: per lane and row pack, the
    table lookups of its bytes, then the byte permutes that give each row
    of the pack its products, xored into that row's sums."""
    R, O, Bp = shards.shape
    n, packs = tables.shape[:2]
    rows = out.shape[1]
    S = Bp // num_chunks
    tab = torch.from_numpy(u32(tables).astype(np.int64))
    for i in range(node_lo, node_lo + node_count):
        ch = t - i
        v = shards[int(shard_rows[i]), :, ch * S:(ch + 1) * S].long() & 0xFFFFFFFF  # (O, S)
        acc = wire_in[i].long() & 0xFFFFFFFF                                    # (O, rows, S)
        if head_zero and i == 0:
            acc = torch.zeros_like(acc)
        acc = list(acc.unbind(1)) + [None] * (packs * (32 // l) - rows)
        for p in range(packs):
            T = tab[i, p]
            if l == 16:
                e0 = T[0][v & 255] ^ T[1][(v >> 8) & 255]
                e1 = T[0][(v >> 16) & 255] ^ T[1][v >> 24]
                got = [byte_perm(e0, e1, 0x5410), byte_perm(e0, e1, 0x7632)]
            else:
                e0, e1, e2, e3 = (T[0][(v >> (8 * m)) & 255] for m in range(4))
                a, b = byte_perm(e0, e1, 0x5140), byte_perm(e0, e1, 0x7362)
                c, d = byte_perm(e2, e3, 0x5140), byte_perm(e2, e3, 0x7362)
                got = [byte_perm(a, c, 0x5410), byte_perm(a, c, 0x7632),
                       byte_perm(b, d, 0x5410), byte_perm(b, d, 0x7632)]
            for r, g in enumerate(got):
                row = p * len(got) + r
                if row < rows:
                    acc[row] = acc[row] ^ g
        res = torch.stack(acc[:rows], 1).to(torch.int32)
        if i == n - 1:
            out[:, :, ch * S:(ch + 1) * S] = res
        else:
            wire_out[i + 1] = res


@pytest.mark.parametrize("head_zero", [False, True])
@pytest.mark.parametrize("t", [0, 3, 5])
@pytest.mark.parametrize("rows", [1, 5, 11, GROUP_ROWS + 1])
@pytest.mark.parametrize("l", [8, 16])
def test_table_arithmetic_matches_plain_version_and_jax(l, rows, t, head_zero):
    """The lookup arithmetic == ``ref.repair_tick_ref`` (the bit-plane math)
    == the JAX repair step of every active node, through a row table that is
    not the identity; at tick 5 the last node writes the output chunk."""
    rng = np.random.default_rng(31 + rows)
    n, O, chunks, S = 4, 2, 3, 29
    wire_in, shards, shard_rows, D = repair_case(rng, l, rows, n, O, chunks, S)
    tables = kernel.repair_tables(gf.bitplane_table(D, l), l)
    lo, count = pipeline.active_nodes(t, n, chunks)
    results = []
    for fn in (ref.repair_tick_ref, table_repair_tick):
        out = torch.zeros((O, rows, S * chunks), dtype=torch.int32)
        wire_out = torch.zeros((n, O, rows, S), dtype=torch.int32)
        fn(t32(wire_in), wire_out, t32(shards), shard_rows, out, t32(tables), l, t,
           chunks, lo, count, head_zero)
        results.append((u32(out), u32(wire_out)))
    for got, want in zip(results[1], results[0]):
        np.testing.assert_array_equal(got, want)
    want = jax_tick(wire_in, shards, shard_rows, D, l, t, chunks, lo, count, head_zero)
    for got, w in zip(results[0], want):
        np.testing.assert_array_equal(got, w)


def _decode_case(n, k, l):
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    ids = next(list(ids) for ids in (range(n - k, n), range(1, n)) if code.decodable(ids))
    return code, ids


def _repair_loss(code):
    """The first of a few n - k node losses whose survivors can rebuild it."""
    n, k = code.n, code.k
    for lost in ([0, n - 1], [1, n - 2], [0, 1], [n - 2, n - 1]):
        lost = sorted(set(lost))[:n - k]
        if code.decodable([i for i in range(n) if i not in lost]):
            return lost
    raise AssertionError("no decodable loss among the candidates")


@pytest.mark.parametrize("case", ["decode", "repair", "past_cap"])
def test_repair_tick_ref_matches_jax_repair_step(case):
    """``ref.repair_tick_ref`` on the tables of a survivor set's decode
    planes, a repair plan's planes, and 800 rows at GF(2^16) (past the
    48 KB of planes the first CUDA kernel took), each through a row table that is
    not the identity == the JAX repair step of every active node."""
    rng = np.random.default_rng(41)
    chunks, S, O = 3, 12, 2
    if case == "decode":
        code, ids = _decode_case(8, 4, 16)
        planes, l = chain.decode_planes(code, tuple(ids)), 16
        np.testing.assert_array_equal(planes, jchain.column_bitplanes(
            jrr.RapidRAIDCode.make(8, 4, l=16, seed=13).decode_matrix(ids), 16))
    elif case == "repair":
        code = rr.RapidRAIDCode.make(8, 4, l=8, seed=13)
        lost = _repair_loss(code)
        ids = [i for i in range(8) if i not in lost]
        shard_rows, host_tables = repair._repair_operands_cached(code, tuple(lost), tuple(ids))
        planes = ref.repair_table_planes(t32(np.array(host_tables)), 8, len(lost)).numpy()
        l = 8
        helpers, R = repair._repair_plan_cached(code, tuple(lost), tuple(ids))
        order = pipeline.position_nodes(len(helpers), reverse=True)
        np.testing.assert_array_equal(planes, gf.bitplane_table(R.T[order], 8))
    else:
        l = 16
        planes = gf.bitplane_table(rng.integers(1, 1 << l, size=(4, 800)), l)
    n, rows = planes.shape[:2]
    D = planes[..., 0]                            # plane 0 is the coefficient
    R_rows = n + 2
    wire_in = lanes(rng, (n, O, rows, S))
    shards = lanes(rng, (R_rows, O, S * chunks))
    shard_rows = rng.permutation(R_rows)[:n].astype(np.int32)
    tables = kernel.repair_tables(planes, l)
    t = n - 1                                     # the last node is active
    lo, count = pipeline.active_nodes(t, n, chunks)
    out = torch.zeros((O, rows, S * chunks), dtype=torch.int32)
    wire_out = torch.zeros((n, O, rows, S), dtype=torch.int32)
    ref.repair_tick_ref(t32(wire_in), wire_out, t32(shards), shard_rows, out, t32(tables),
                        l, t, chunks, lo, count)
    want_out, want_wire = jax_tick(wire_in, shards, shard_rows, D, l, t, chunks, lo, count)
    np.testing.assert_array_equal(u32(out), want_out)
    np.testing.assert_array_equal(u32(wire_out), want_wire)


@pytest.mark.parametrize("n,k,l", CODES)
def test_decode_and_repair_tables_are_cached(n, k, l):
    """A warm decode or repair builds no tables: the host tables are cached
    per survivor set and per plan, read-only."""
    code, ids = _decode_case(n, k, l)
    tables = chain.decode_tables(code, tuple(ids))
    assert chain.decode_tables(code, tuple(ids)) is tables and not tables.flags.writeable
    assert tables.shape == (len(ids), kernel.repair_packs(k, l), l // 8, 256)
    np.testing.assert_array_equal(tables, kernel.repair_tables(
        chain.decode_planes(code, tuple(ids)), l))
    lost = [i for i in range(n) if i not in ids][:n - k] or [0]
    alive = [i for i in range(n) if i not in lost]
    rows, rt = repair._repair_operands_cached(code, tuple(lost), tuple(alive))
    again = repair._repair_operands_cached(code, tuple(lost), tuple(alive))
    assert again[0] is rows and again[1] is rt
    assert not rows.flags.writeable and not rt.flags.writeable
    helpers, _ = repair._repair_plan_cached(code, tuple(lost), tuple(alive))
    order = pipeline.position_nodes(len(helpers), reverse=True)
    assert rows.tolist() == [alive.index(helpers[p]) for p in order]


@pytest.mark.parametrize("n,k,l,chunks", [(8, 4, 8, 4), (6, 4, 16, 3), (16, 11, 16, 8)])
def test_pipelined_repair_reads_shards_in_place(n, k, l, chunks, monkeypatch):
    """Every repair tick reads the caller's packed shards where they lie
    (no gather of the helpers), through the plan's row table, with node 0
    told that its incoming sums are zero; the result is ``repair_np``'s."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    jcode = jrr.RapidRAIDCode.make(n, k, l=l, seed=13)
    data = words(np.random.default_rng(3), (k, chunks * gf.LANES[l] * 8), l)
    cw = code.encode_np(data)
    lost = _repair_loss(code)
    ids = [i for i in range(n) if i not in lost]
    shards = torch.from_numpy(np.ascontiguousarray(cw[ids]))
    seen = []
    tick = repair.ops.repair_tick

    def spy(wire_in, wire_out, packed, shard_rows, *rest, head_zero):
        seen.append((packed.data_ptr(), tuple(packed.shape), tuple(shard_rows), head_zero))
        return tick(wire_in, wire_out, packed, shard_rows, *rest, head_zero=head_zero)

    monkeypatch.setattr(repair.ops, "repair_tick", spy)
    got = repair.pipelined_repair(code, ids, shards, lost, chunks, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jrepair.repair_np(jcode, lost, ids, cw[ids]))
    rows, _ = repair._repair_operands_cached(code, tuple(lost), tuple(ids))
    Bp = shards.shape[1] // gf.LANES[l]
    assert seen == [(shards.data_ptr(), (len(ids), 1, Bp), tuple(rows), True)] * \
        pipeline.num_ticks(chunks, k)


@pytest.mark.parametrize("n,k,l,chunks", [(8, 4, 8, 4), (16, 11, 16, 8)])
def test_pipelined_decode_reads_shards_in_place(n, k, l, chunks, monkeypatch):
    code, ids = _decode_case(n, k, l)
    data = words(np.random.default_rng(4), (k, chunks * gf.LANES[l] * 8), l)
    shards = torch.from_numpy(np.ascontiguousarray(code.encode_np(data)[ids]))
    seen = []
    tick = chain.ops.repair_tick

    def spy(wire_in, wire_out, packed, shard_rows, *rest, head_zero):
        seen.append((packed.data_ptr(), tuple(shard_rows), head_zero))
        return tick(wire_in, wire_out, packed, shard_rows, *rest, head_zero=head_zero)

    monkeypatch.setattr(chain.ops, "repair_tick", spy)
    got = chain.pipelined_decode(code, ids, shards, chunks, device="cpu")
    np.testing.assert_array_equal(got.numpy(), data)
    assert seen == [(shards.data_ptr(), tuple(range(len(ids))), True)] * \
        pipeline.num_ticks(chunks, len(ids))


def test_repair_tick_refuses_bad_row_tables():
    for rows in (np.array([0, 4]), np.array([-1, 0]), np.array([[0, 1]]),
                 np.array([0.0, 1.0]), np.array([], np.int32)):
        with pytest.raises(ValueError, match="shard_rows"):
            kernel._check_shard_rows("repair_tick", rows, 4)


def test_repair_step_keeps_a_nonzero_head_row():
    """``ops.repair_step`` is a one-node chain whose x_in is not zero: the
    tick must read it (no head_zero)."""
    rng = np.random.default_rng(5)
    x_in, local = lanes(rng, (2, 3, 64)), lanes(rng, (2, 1, 64))
    bp = gf.bitplane_table(rng.integers(1, 1 << 16, size=3), 16)
    got = ops.repair_step(t32(x_in), t32(local), t32(bp), 16)
    want = jops.repair_step(jnp.asarray(x_in), jnp.asarray(local), jnp.asarray(bp), 16,
                            block=64)
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    assert x_in.any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("O", [1, 2])
@pytest.mark.parametrize("S", [29, 1000, 1002])
@pytest.mark.parametrize("l,rows", [(16, 1), (16, 11), (16, 13), (8, 5), (8, 11),
                                    (16, 800), (8, 1600)])
def test_repair_tick_kernel_matches_plain_past_the_old_cap(cuda, l, rows, S, O):
    """The kernel == the plain version through a row table that is not the
    identity, at ragged lane counts (16-byte lanes at S = 1000), for rows
    that fill one register group or spill into a second, and past the
    first kernel's 48 KB of planes: 800 rows at GF(2^16) and 1600 at
    GF(2^8), whose tables are staged in turn; with and without head_zero."""
    rng = np.random.default_rng(rows + S)
    n, chunks = 4, 3
    wire_in, shards, shard_rows, D = repair_case(rng, l, rows, n, O, chunks, S)
    tables = t32(kernel.repair_tables(gf.bitplane_table(D, l), l), cuda)
    for t, head_zero in ((2, True), (4, False)):
        lo, count = pipeline.active_nodes(t, n, chunks)
        results = []
        for fn, launched in ((kernel.repair_tick, 1), (ref.repair_tick_ref, 0)):
            out = torch.zeros((O, rows, S * chunks), dtype=torch.int32, device=cuda)
            wire_out = torch.zeros((n, O, rows, S), dtype=torch.int32, device=cuda)
            before = kernel.repair_tick.launches
            fn(t32(wire_in, cuda), wire_out, t32(shards, cuda), shard_rows, out, tables, l,
               t, chunks, lo, count, head_zero)
            assert kernel.repair_tick.launches == before + launched
            results.append((out, wire_out))
        torch.cuda.synchronize()
        for got, want in zip(*results):
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,l,chunks", [(8, 4, 8, 4), (16, 11, 16, 8)])
def test_pipelined_decode_and_repair_on_cuda_match_cpu(cuda, n, k, l, chunks):
    """Both repair-tick entry points on the card == their CPU route, reading
    the shards in place from a CUDA tensor."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    data = words(np.random.default_rng(6), (k, chunks * gf.LANES[l] * 300), l)
    cw = code.encode_np(data)
    lost = _repair_loss(code)
    ids = [i for i in range(n) if i not in lost]
    kernel.reset_launch_counts()
    dec = chain.pipelined_decode(code, ids, torch.from_numpy(cw[ids]).to(cuda), chunks)
    rep = repair.pipelined_repair(code, ids, torch.from_numpy(cw[ids]).to(cuda), lost, chunks)
    torch.cuda.synchronize()
    # each chain is one launch, its sums kept in registers
    assert kernel.repair_chain.launches == 2 and kernel.repair_tick.launches == 0
    cpu_dec = chain.pipelined_decode(code, ids, cw[ids], chunks, device="cpu")
    cpu_rep = repair.pipelined_repair(code, ids, cw[ids], lost, chunks, device="cpu")
    np.testing.assert_array_equal(dec.cpu().numpy(), cpu_dec.numpy())
    np.testing.assert_array_equal(rep.cpu().numpy(), cpu_rep.numpy())
    np.testing.assert_array_equal(dec.cpu().numpy(), data)
    np.testing.assert_array_equal(rep.cpu().numpy(), cw[lost])
