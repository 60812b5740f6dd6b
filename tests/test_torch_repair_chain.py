"""A whole unplaced decode or repair chain in one call (``ops.repair_chain``).

On the CPU ``ops.repair_chain`` runs the ticks of the chain's schedule
through ``ops.repair_tick``, over fresh wires, and is held against a numpy
oracle of the sums the chain's last position writes. Tests marked ``gpu``
hold ``kernel.repair_chain``, one launch, bit for bit against the same chain
run as ``kernel.repair_tick`` ticks on the card, across both fields, rows
that fill one, two or three register groups, chains of 1 to 300 positions
(tables staged in position groups, several launches), 16-byte and 4-byte
lanes and the single and batch layouts of the shards; and the unplaced
entry points on the card against the oracles, in one ``repair_chain``
launch a run or stripe, with no tick launched and no wire zeroed.
"""
import collections
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codes, gf, jitcache, pipeline  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402

FIELD_ROWS = [(l, rows) for l in (16, 8) for rows in (1, 2, 11, 12, 13, 25)]
CHUNKS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_programs():
    jitcache.clear()
    yield
    jitcache.clear()


def chain_case(rng, l, rows, h, n_obj, S, batch, chunks=CHUNKS, R=None):
    """A chain of h positions over R shard rows read through a row table
    that is not the identity: (shard words (R, n_obj, B), the shards' lanes
    as the tick takes them (R, n_obj, Bp), the row table, the coefficients
    D (h, rows), the tables). ``batch``: the shards laid out (n_obj, R, Bp)
    and passed transposed, as the multi-object entry points pass them."""
    R = h + 2 if R is None else R
    B = gf.LANES[l] * S * chunks
    shard_words = rng.integers(0, 1 << l, size=(R, n_obj, B)).astype(gf.WORD_DTYPE[l])
    shard_rows = rng.choice(R, size=h, replace=h > R).astype(np.int32)
    D = rng.integers(1, 1 << l, size=(h, rows))
    D[0, 0] = 0                                       # a zero coefficient
    tables = torch.from_numpy(kernel.repair_tables(gf.bitplane_table(D, l), l).view(np.int32))
    lanes = gf.pack_u32(torch.from_numpy(shard_words), l)
    if batch:
        lanes = lanes.transpose(0, 1).contiguous().transpose(0, 1)
    return shard_words, lanes, shard_rows, D, tables


def oracle(shard_words, shard_rows, D, l):
    """(n_obj, rows, B) words: object b's sums D^T x its shards, in the rows'
    order of the table."""
    return np.stack([gf.gf_matmul_np(D.T, shard_words[shard_rows, b], l)
                     for b in range(shard_words.shape[1])])


def out_like(shards, rows, device=None):
    R, n_obj, Bp = shards.shape
    return torch.full((n_obj, rows, Bp), -1, dtype=torch.int32, device=device or shards.device)


# ---------------------------------------------------------------------------
# the CPU: the ticks of the chain's schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l,rows", [(16, 1), (16, 11), (16, 13), (8, 1), (8, 12)])
@pytest.mark.parametrize("h", [1, 2, 11])
@pytest.mark.parametrize("batch,stagger", [(False, 0), (True, 0), (True, 1), (True, 4)])
def test_repair_chain_on_the_cpu_matches_the_oracle(l, rows, h, batch, stagger):
    rng = np.random.default_rng(1000 * l + 10 * rows + h)
    n_obj = 3 if batch else 1
    words, shards, shard_rows, D, tables = chain_case(rng, l, rows, h, n_obj, 5, batch)
    out = out_like(shards, rows)
    ops.repair_chain(shards, shard_rows, out, tables, l, CHUNKS, stagger)
    np.testing.assert_array_equal(gf.unpack_u32(out, l).numpy(),
                                  oracle(words, shard_rows, D, l))


@pytest.mark.parametrize("n_obj,stagger", [(1, 0), (3, 0), (3, 1), (3, 2)])
def test_repair_chain_on_the_cpu_runs_the_ticks_of_its_schedule(monkeypatch, n_obj, stagger):
    """One ``ops.repair_tick`` a tick, looked up at each tick, over the
    chain's schedule with head_zero, passing the caller's shards and row
    table; two fresh wires zeroed."""
    rng = np.random.default_rng(7)
    l, rows, h = 16, 2, 5
    words, shards, shard_rows, D, tables = chain_case(rng, l, rows, h, n_obj, 4, False)
    calls = collections.Counter()
    tick = ops.repair_tick

    def spy(wire_in, wire_out, packed, rows_table, out, tabs, *rest, **kw):
        assert packed is shards and tabs is tables and tuple(rows_table) == tuple(shard_rows)
        assert kw["head_zero"] and kw.get("stagger", 0) == stagger
        calls[rest[1]] += 1                           # the tick t
        return tick(wire_in, wire_out, packed, rows_table, out, tabs, *rest, **kw)

    monkeypatch.setattr(ops, "repair_tick", spy)
    before = pipeline.stats()["wire_bytes_zeroed"]
    out = out_like(shards, rows)
    ops.repair_chain(shards, shard_rows, out, tables, l, CHUNKS, stagger)
    S = shards.shape[-1] // CHUNKS
    if stagger:
        ticks = pipeline.num_ticks_many(CHUNKS, h, n_obj, stagger)
        W = pipeline.window_size(CHUNKS, n_obj, stagger)
    else:
        ticks, W = pipeline.num_ticks(CHUNKS, h), n_obj
    assert calls == {t: 1 for t in range(ticks)}
    assert pipeline.stats()["wire_bytes_zeroed"] - before == 2 * 4 * h * W * rows * S
    np.testing.assert_array_equal(gf.unpack_u32(out, l).numpy(),
                                  oracle(words, shard_rows, D, l))


def _bad_operands():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    rows = np.arange(3, dtype=np.int32)
    good = dict(shards=z(4, 2, 6), shard_rows=rows, out=z(2, 2, 6), tables=z(3, 1, 2, 256),
                l=16)
    yield "field", {**good, "l": 12}
    yield "shards", {**good, "shards": z(4, 12)}
    yield "out", {**good, "out": z(2, 3, 6)}
    yield "out objects", {**good, "out": z(1, 2, 6)}
    yield "tables", {**good, "tables": z(3, 2, 2, 256)}
    yield "tables positions", {**good, "tables": z(2, 1, 2, 256)}
    yield "tables field", {**good, "l": 8}
    yield "no rows", {**good, "out": z(2, 0, 6), "tables": z(3, 0, 2, 256)}
    yield "no lanes", {**good, "shards": z(4, 2, 0), "out": z(2, 2, 0)}
    yield "shard rows", {**good, "shard_rows": np.array([0, 1, 4], np.int32)}
    yield "shard rows shape", {**good, "shard_rows": rows[None]}
    yield "no positions", {**good, "shard_rows": np.array([], np.int32),
                           "tables": z(0, 1, 2, 256)}


@pytest.mark.parametrize("what,operands", list(_bad_operands()), ids=lambda x: str(x)[:20])
def test_repair_chain_refuses_bad_operands(what, operands):
    """The plain route refuses what the card's wrapper refuses, before any
    tick; the card's wrapper refuses CPU tensors and launches nothing."""
    before = kernel.launch_counts()
    with pytest.raises(ValueError):
        ops.repair_chain(operands["shards"], operands["shard_rows"], operands["out"],
                         operands["tables"], operands["l"], 2)
    with pytest.raises(ValueError):
        kernel.repair_chain(operands["shards"], operands["shard_rows"], operands["out"],
                            operands["tables"], operands["l"])
    assert kernel.launch_counts() == before


def test_repair_chain_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(2)
    _, shards, shard_rows, _, tables = chain_case(rng, 16, 2, 3, 1, 4, False)
    before = kernel.repair_chain.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.repair_chain(shards, shard_rows, out_like(shards, 2), tables, 16)
    assert kernel.repair_chain.launches == before


def _code_case(l):
    code = codes.make("rapidraid", 8, 4, l=l, seed=3)
    lost = next(list(m) for m in itertools.combinations(range(8), 4)
                if code.decodable([i for i in range(8) if i not in m]))
    return code, lost, [i for i in range(8) if i not in lost]


def test_unplaced_sums_programs_keep_no_wires():
    """An unplaced decode or repair program keeps no wires (the card's
    launch has none to keep, the CPU's ticks make theirs); a placed one
    keeps its positions' wires. Encode programs alike since the unplaced
    encode is one ``encode_chain``: none unplaced, n rows placed."""
    code, lost, ids = _code_case(16)
    B = gf.LANES[16] * CHUNKS * 4
    assert chain.decode_program(code, ids, B, CHUNKS, device="cpu").wire_shape is None
    mesh = chain.make_chain_mesh(len(ids), devices=["cpu"] * len(ids))
    placed = chain.decode_program(code, ids, B, CHUNKS, mesh=mesh)
    assert placed.wire_shape == (len(ids), 1, code.k, B // gf.LANES[16] // CHUNKS)
    assert chain.encode_program(code, B, CHUNKS, device="cpu").wire_shape is None
    encode_mesh = chain.make_chain_mesh(code.n, devices=["cpu"] * code.n)
    assert (chain.encode_program(code, B, CHUNKS, mesh=encode_mesh).wire_shape
            == (code.n, 1, B // gf.LANES[16] // CHUNKS))
    cpu = torch.device("cpu")

    def plan(B_obj, stagger):
        return chain.call_plan(code, "test", "sums", B, CHUNKS, stagger, chain_len=len(ids),
                               B_obj=B_obj, device=cpu)
    decode = (chain.identity_rows(len(ids)), chain.decode_operands(code, ids, cpu), len(ids),
              code.k)
    rebuild = (*repair.repair_operands(code, lost, ids, cpu), len(ids), len(lost))
    builds = [lambda: chain.build_sums(16, *decode, plan(3, 1)),
              lambda: chain.build_sums(16, *rebuild, plan(None, None)),
              lambda: chain.build_sums(16, *rebuild, plan(3, 1))]
    assert [build().wire_shape for build in builds] == [None] * 3


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _ticks_on_the_card(shards, shard_rows, tables, l, rows, stagger):
    """The same chain as ``kernel.repair_tick`` ticks on the card, and the
    launches it took."""
    out = out_like(shards, rows)
    before = kernel.repair_tick.launches
    ops._repair_chain_ticks(shards, shard_rows, out, tables, l, CHUNKS, stagger)
    return out, kernel.repair_tick.launches - before


def _check_against_ticks(cuda, l, rows, h, n_obj, S, batch, launches=1):
    rng = np.random.default_rng(100 * h + 10 * rows + l + S)
    words, shards, shard_rows, D, tables = chain_case(rng, l, rows, h, n_obj, S, batch)
    shards, tables = shards.to(cuda), tables.to(cuda)
    want, ticks = _ticks_on_the_card(shards, shard_rows, tables, l, rows, 1 if batch else 0)
    assert ticks > 0
    out = out_like(shards, rows)
    before = kernel.launch_counts()
    kernel.repair_chain(shards, shard_rows, out, tables, l)
    after = kernel.launch_counts()
    torch.cuda.synchronize()
    assert after["repair_chain"] - before["repair_chain"] == launches
    assert after["repair_tick"] == before["repair_tick"]
    assert torch.equal(out, want)
    if h <= 16:
        np.testing.assert_array_equal(gf.unpack_u32(out.cpu(), l).numpy(),
                                      oracle(words, shard_rows, D, l))


@pytest.mark.gpu
@pytest.mark.parametrize("l,rows", FIELD_ROWS)
@pytest.mark.parametrize("h", [1, 2, 11, 16])
@pytest.mark.parametrize("S", [64, 37])                # 16-byte lanes, 4-byte lanes
@pytest.mark.parametrize("batch", [False, True])
def test_repair_chain_kernel_matches_the_ticks(cuda, l, rows, h, S, batch):
    _check_against_ticks(cuda, l, rows, h, 3 if batch else 1, S, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("l,rows,h,launches", [
    (16, 25, 100, 1),      # 333 KB of tables: position groups, three row groups
    (16, 8, 256, 1),       # 262 KB of tables: position groups, one row group
    (8, 49, 256, 1),       # 327 KB of tables at GF(2^8)
    (16, 11, 300, 2),      # past a launch's 256 positions
    (8, 1, 513, 3)])
def test_repair_chain_kernel_past_its_caps_matches_the_ticks(cuda, l, rows, h, launches):
    _check_against_ticks(cuda, l, rows, h, 2, 8, True, launches)


@pytest.mark.gpu
def test_repair_chain_kernel_reads_unaligned_shards(cuda):
    """Shards whose rows start one lane past a 16-byte boundary take the
    4-byte lanes, with the same result."""
    rng = np.random.default_rng(3)
    l, rows, h = 16, 11, 11
    words, shards, shard_rows, D, tables = chain_case(rng, l, rows, h, 2, 16, False)
    R, n_obj, Bp = shards.shape
    host = torch.zeros((R, n_obj, Bp + 1), dtype=torch.int32)
    host[..., 1:] = shards
    moved = host.to(cuda)[..., 1:]
    assert moved.data_ptr() % 16
    out = out_like(moved, rows)
    kernel.repair_chain(moved, shard_rows, out, tables.to(cuda), l)
    np.testing.assert_array_equal(gf.unpack_u32(out.cpu(), l).numpy(),
                                  oracle(words, shard_rows, D, l))


@pytest.mark.gpu
@pytest.mark.parametrize("l", [8, 16])
def test_unplaced_entry_points_on_the_card_launch_one_chain(cuda, l):
    """Each unplaced decode or repair entry point on the card == the numpy
    oracles, in one ``repair_chain`` launch and no tick, zeroing no wire."""
    code, lost, ids = _code_case(l)
    rng = np.random.default_rng(l)
    n_obj, B = 3, gf.LANES[l] * CHUNKS * 40
    data = rng.integers(0, 1 << l, size=(n_obj, code.k, B)).astype(gf.WORD_DTYPE[l])
    cw = np.stack([code.encode_np(x) for x in data])
    calls = {
        "decode": (lambda: chain.pipelined_decode(code, ids, cw[0][ids], CHUNKS), data[0]),
        "decode_many": (lambda: multi.pipelined_decode_many(code, ids, cw[:, ids], CHUNKS, 1),
                        data),
        "repair": (lambda: repair.pipelined_repair(code, ids, cw[0][ids], lost, CHUNKS),
                   cw[0][lost]),
        "repair_many": (lambda: repair.pipelined_repair_many(code, ids, cw[:, ids], lost,
                                                             CHUNKS, 2), cw[:, lost]),
    }
    for name, (call, want) in calls.items():
        for _ in range(2):                            # the program built, then warm
            kernel.reset_launch_counts()
            zeroed = pipeline.stats()["wire_bytes_zeroed"]
            got = call()
            torch.cuda.synchronize()
            assert got.device.type == "cuda"
            assert kernel.launch_counts()["repair_chain"] == 1, name
            assert kernel.launch_counts()["repair_tick"] == 0, name
            assert pipeline.stats()["wire_bytes_zeroed"] == zeroed, name
            np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=name)


@pytest.mark.gpu
def test_streamed_decode_and_repair_launch_one_chain_a_stripe(cuda):
    """A streamed run replays one ``repair_chain`` launch a stripe (its
    graphs captured over no wires), equal to the oracles."""
    code, lost, ids = _code_case(16)
    rng = np.random.default_rng(5)
    sc = gf.LANES[16] * CHUNKS * 16
    data = rng.integers(0, 1 << 16, size=(2, code.k, 4 * sc - 6)).astype(np.uint16)
    cw = np.stack([code.encode_np(x) for x in data])
    stripes = 4
    runs = {
        "decode": (lambda: chain.pipelined_decode(code, ids, cw[0][ids], CHUNKS,
                                                  superchunk_words=sc), data[0]),
        "repair_many": (lambda: repair.pipelined_repair_many(
            code, ids, cw[:, ids], lost, CHUNKS, 1, superchunk_words=sc), cw[:, lost]),
    }
    for name, (run, want) in runs.items():
        zeroed = pipeline.stats()["wire_bytes_zeroed"]
        np.testing.assert_array_equal(run().numpy(), want, err_msg=name)
        kernel.reset_launch_counts()
        np.testing.assert_array_equal(run().numpy(), want, err_msg=name)
        assert kernel.launch_counts()["repair_chain"] == stripes, name
        assert kernel.launch_counts()["repair_tick"] == 0, name
        assert pipeline.stats()["wire_bytes_zeroed"] == zeroed, name
