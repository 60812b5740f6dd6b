"""A whole unplaced encode chain in one call (``ops.encode_chain``).

On the CPU ``ops.encode_chain`` runs the ticks of the chain's schedule
through ``ops.chain_tick``, over fresh wires, and is held against
``encode_np``, a numpy oracle of the chain's recurrence (Eqs. 3-4) for slot
tables of any width, and the JAX package's encode answers kept in
``data/repair_chain_jax.npz``. Tests marked ``gpu`` hold
``kernel.encode_chain``, one launch, bit for bit against the same chain run
as ``kernel.chain_tick`` ticks on the card, across both fields, 1 to 5
slots a node, chains of 1 to 300 nodes (tables staged in slot groups),
16-byte and 4-byte lanes and the single and batch layouts of the output;
and the unplaced entry points on the card in one ``encode_chain`` launch a
run or stripe, with no tick launched and no wire zeroed, while placed
chains and card layouts keep their ticks. A program makes its
``kernel.EncodePlan`` once and holds it: its captured graphs still replay
to the same rows after other plans are made and freed.
"""
import collections
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codes, gf, jitcache, pipeline  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops  # noqa: E402
from repro_torch.storage import chain, multi  # noqa: E402

CHUNKS = 3
CODES = [(8, 4, 8), (8, 4, 16), (16, 11, 16)]     # (n, k, l), as the npz's
NPZ = pathlib.Path(__file__).parent / "data" / "repair_chain_jax.npz"
NPZ_SEED = 3                                      # the npz's codes' seed


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


@pytest.fixture(scope="module")
def saved():
    with np.load(NPZ) as f:
        return {name: f[name] for name in f.files}


def chain_case(rng, l, n, max_b, n_obj, S, chunks=CHUNKS, R=None):
    """A chain of n nodes over R blocks an object, read through a random
    slot table with empty slots: (block words (n_obj, R, B), their lanes
    (n_obj, R, Bp), the slot table, psi, xi (n, max_b), the tables)."""
    R = max_b + 3 if R is None else R
    B = gf.LANES[l] * S * chunks
    words = rng.integers(0, 1 << l, size=(n_obj, R, B)).astype(gf.WORD_DTYPE[l])
    slots = rng.integers(-1, R, size=(n, max_b)).astype(np.int32)
    slots[0, 0] = 0                                   # node 0 holds a block
    psi = rng.integers(0, 1 << l, size=(n, max_b))
    xi = rng.integers(0, 1 << l, size=(n, max_b))
    psi[0, 0] = 0                                     # a zero coefficient
    tables = kernel.product_tables(gf.bitplane_table(psi, l), gf.bitplane_table(xi, l), l)
    return (words, gf.pack_u32(torch.from_numpy(words), l), slots, psi, xi,
            torch.from_numpy(tables.view(np.int32).copy()))


def oracle(words, slots, psi, xi, l):
    """(n, n_obj, B) words: node i's row of each object, c_i = x_i ^ sum_s
    xi[i, s] * block, x_{i+1} = x_i ^ sum_s psi[i, s] * block, x_0 = 0."""
    n_obj, _, B = words.shape
    out = np.zeros((slots.shape[0], n_obj, B), words.dtype)
    for b in range(n_obj):
        x = np.zeros(B, words.dtype)
        for i, row in enumerate(slots):
            held = row >= 0
            blocks = words[b, row[held]]
            if not held.any():
                out[i, b] = x
                continue
            out[i, b] = x ^ gf.gf_matmul_np(xi[i][held][None], blocks, l)[0]
            x = x ^ gf.gf_matmul_np(psi[i][held][None], blocks, l)[0]
    return out


def out_like(n, src, batch, device=None):
    """(n, n_obj, Bp) filled with -1: contiguous, or, for ``batch``, the
    transpose of a (n_obj, n, Bp) tensor, as the multi-object entry points
    pass it."""
    n_obj, _, Bp = src.shape
    device = device or src.device
    if batch:
        return torch.full((n_obj, n, Bp), -1, dtype=torch.int32, device=device).transpose(0, 1)
    return torch.full((n, n_obj, Bp), -1, dtype=torch.int32, device=device)


def code_case(n, k, l):
    return codes.make("rapidraid", n, k, l=l, seed=NPZ_SEED)


def code_operands(code, data, device):
    """(src lanes (B_obj, k, Bp), slots, tables) of a code on ``data``
    (B_obj, k, B) words, as the entry points pass them."""
    return chain.encode_operands(code, gf.pack_u32(torch.from_numpy(data), code.l).to(device))


# ---------------------------------------------------------------------------
# the CPU: the ticks of the chain's schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,l", CODES)
@pytest.mark.parametrize("S", [4, 5])                 # Bp 12 or 15 lanes
@pytest.mark.parametrize("batch,stagger", [(False, 0), (True, 0), (True, 1), (True, 2)])
def test_encode_chain_on_the_cpu_matches_encode_np(n, k, l, S, batch, stagger):
    code = code_case(n, k, l)
    rng = np.random.default_rng([n, k, l, S, stagger])
    n_obj = 3 if batch else 1
    data = rng.integers(0, 1 << l, size=(n_obj, k, gf.LANES[l] * S * CHUNKS))
    data = data.astype(gf.WORD_DTYPE[l])
    src, slots, tables = code_operands(code, data, "cpu")
    out = out_like(n, src, batch)
    ops.encode_chain(src, slots, out, tables, l, CHUNKS, stagger)
    got = gf.unpack_u32(out.transpose(0, 1), l).numpy()
    np.testing.assert_array_equal(got, np.stack([code.encode_np(x) for x in data]))


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("n,max_b", [(1, 1), (5, 2), (6, 3), (4, 5)])
@pytest.mark.parametrize("batch,stagger", [(False, 0), (True, 1)])
def test_encode_chain_on_the_cpu_matches_the_oracle(l, n, max_b, batch, stagger):
    """Any slot table: slots past 2, empty slots, blocks held twice."""
    rng = np.random.default_rng([l, n, max_b, stagger])
    words, src, slots, psi, xi, tables = chain_case(rng, l, n, max_b, 2 if batch else 1, 5)
    out = out_like(n, src, batch)
    ops.encode_chain(src, slots, out, tables, l, CHUNKS, stagger)
    np.testing.assert_array_equal(gf.unpack_u32(out, l).numpy(),
                                  oracle(words, slots, psi, xi, l))


@pytest.mark.parametrize("n_obj,stagger", [(1, 0), (3, 0), (3, 1), (3, 2)])
def test_encode_chain_on_the_cpu_runs_the_ticks_of_its_schedule(monkeypatch, n_obj, stagger):
    """One ``ops.chain_tick`` a tick, looked up at each tick, over the
    chain's schedule, passing the caller's blocks and slot table; two fresh
    wires of n rows zeroed."""
    rng = np.random.default_rng(7)
    l, n, max_b = 16, 5, 2
    words, src, slots, psi, xi, tables = chain_case(rng, l, n, max_b, n_obj, 4)
    calls = collections.Counter()
    tick = ops.chain_tick

    def spy(wire_in, wire_out, blocks, slot_table, out, tabs, *rest):
        assert blocks is src and tabs is tables and np.array_equal(slot_table, slots)
        assert wire_out.shape[0] == n and rest[-1] == stagger
        calls[rest[1]] += 1                           # the tick t
        return tick(wire_in, wire_out, blocks, slot_table, out, tabs, *rest)

    monkeypatch.setattr(ops, "chain_tick", spy)
    before = pipeline.stats()["wire_bytes_zeroed"]
    out = out_like(n, src, False)
    ops.encode_chain(src, slots, out, tables, l, CHUNKS, stagger)
    S = src.shape[-1] // CHUNKS
    if stagger:
        ticks = pipeline.num_ticks_many(CHUNKS, n, n_obj, stagger)
        W = pipeline.window_size(CHUNKS, n_obj, stagger)
    else:
        ticks, W = pipeline.num_ticks(CHUNKS, n), n_obj
    assert calls == {t: 1 for t in range(ticks)}
    assert pipeline.stats()["wire_bytes_zeroed"] - before == 2 * 4 * n * W * S
    np.testing.assert_array_equal(gf.unpack_u32(out, l).numpy(),
                                  oracle(words, slots, psi, xi, l))


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("batch,stagger", [(False, 0), (True, 1)])
def test_encode_chain_on_the_cpu_takes_a_plan(l, batch, stagger):
    """A slot table's ``kernel.EncodePlan`` in its place gives the same rows."""
    rng = np.random.default_rng([l, stagger, 11])
    words, src, slots, psi, xi, tables = chain_case(rng, l, 6, 3, 2 if batch else 1, 5)
    plan = kernel.EncodePlan(slots, src.shape[1], "cpu")
    assert np.array_equal(plan.slots, slots) and plan.terms.dtype == torch.int32
    out = out_like(6, src, batch)
    ops.encode_chain(src, plan, out, tables, l, CHUNKS, stagger)
    np.testing.assert_array_equal(gf.unpack_u32(out, l).numpy(),
                                  oracle(words, slots, psi, xi, l))


@pytest.mark.parametrize("many", [False, True])
def test_unplaced_encode_program_makes_its_plan_once(monkeypatch, many):
    """An unplaced encode program makes its ``kernel.EncodePlan`` when it is
    built and passes that plan to every run: a captured graph reads the
    plan at its address, so the program keeps it alive, not a cache."""
    made, seen = [], []
    encode_plan, encode_chain = kernel.encode_plan, ops.encode_chain

    def count_plans(slots):
        made.append(slots)
        return encode_plan(slots)

    def spy(src, plan, *rest):
        seen.append(plan)
        return encode_chain(src, plan, *rest)

    monkeypatch.setattr(kernel, "encode_plan", count_plans)
    monkeypatch.setattr(ops, "encode_chain", spy)
    code = code_case(8, 4, 16)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 1 << 16, size=(2, code.k, gf.LANES[16] * CHUNKS * 4))
    data = data.astype(np.uint16)
    want = np.stack([code.encode_np(x) for x in data])
    for _ in range(3):
        if many:
            got = multi.pipelined_encode_many(code, data, CHUNKS, 1, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            got = chain.pipelined_encode(code, data[0], CHUNKS, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want[0])
    assert len(made) == 1 and len(seen) == 3
    assert all(isinstance(p, kernel.EncodePlan) and p is seen[0] for p in seen)


def walk_plan(plan, words, psi, xi, l, max_b):
    """The chain as ``encode_chain`` walks its plan, on words: (n, n_obj, B)
    rows and the blocks read from global memory, in order."""
    n_obj, _, B = words.shape
    rows, reads = [], []
    x = np.zeros((n_obj, B), words.dtype)
    kept, fwd = np.zeros_like(x), np.zeros_like(x)
    caches = {}
    for table, block, src, dst, last in plan.tolist():
        if block >= 0:
            if src >= 0:
                v = caches[src]
                assert v[0] == block                  # kept by an earlier read of it
            else:
                v = (block, words[:, block])
                reads.append(block)
            if dst >= 0:
                caches[dst] = v
            i, s = divmod(table, max_b)
            for b in range(n_obj):
                kept[b] ^= gf.gf_matmul_np(np.array([[xi[i, s]]]), v[1][b][None], l)[0]
                fwd[b] ^= gf.gf_matmul_np(np.array([[psi[i, s]]]), v[1][b][None], l)[0]
        if last:
            rows.append(x ^ kept)
            x = x ^ fwd
            kept, fwd = np.zeros_like(x), np.zeros_like(x)
    return np.stack(rows), reads


@pytest.mark.parametrize("l,n,max_b", [(16, 6, 2), (8, 5, 3), (16, 7, 5)])
def test_encode_plan_walks_the_chain(l, n, max_b):
    """Walked as the kernel walks it, a plan of any slot table (empty
    slots, a node with no block, a block held twice by one node) gives the
    chain's rows, every cache it reads kept by an earlier read of the same
    block, every block it reads more than once read from global memory
    once while a cache is free."""
    rng = np.random.default_rng([l, n, max_b])
    words, _, slots, psi, xi, _ = chain_case(rng, l, n, max_b, 2, 2)
    slots[1] = -1
    slots[2, :2] = slots[2, 0]
    plan, caches = kernel.encode_plan(slots)
    assert plan.shape == (int((slots >= 0).sum()) + 1, 5) and plan[:, 4].sum() == n
    got, reads = walk_plan(plan, words, psi, xi, l, max_b)
    np.testing.assert_array_equal(got, oracle(words, slots, psi, xi, l))
    assert sorted(reads) == sorted(set(reads)) and caches <= kernel.ENCODE_CACHES


@pytest.mark.parametrize("n,k", [(16, 11), (8, 4)])
def test_encode_plan_of_rapidraid_reads_each_block_once(n, k):
    """Block j is held by nodes j and j + n - k: k reads from global memory,
    n - k caches."""
    slots = chain.placement_slots(code_case(n, k, 16))
    plan, caches = kernel.encode_plan(slots)
    assert plan.shape[0] == int((slots >= 0).sum())
    assert sorted(plan[plan[:, 2] < 0, 1].tolist()) == list(range(k))
    assert caches == n - k


def _bad_operands():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    slots = np.array([[0, -1], [1, 2], [3, -1]], np.int32)
    good = dict(src=z(2, 4, 6), slots=slots, out=z(3, 2, 6), tables=z(3, 2, 2, 256), l=16)
    yield "field", {**good, "l": 12}
    yield "src", {**good, "src": z(4, 12)}
    yield "out", {**good, "out": z(3, 3, 6)}
    yield "out nodes", {**good, "out": z(2, 2, 6)}
    yield "tables", {**good, "tables": z(3, 1, 2, 256)}
    yield "tables nodes", {**good, "tables": z(2, 2, 2, 256)}
    yield "tables field", {**good, "l": 8}
    yield "no blocks", {**good, "src": z(2, 0, 6), "slots": np.full((3, 2), -1, np.int32)}
    yield "no lanes", {**good, "src": z(2, 4, 0), "out": z(3, 2, 0)}
    yield "slots", {**good, "slots": np.array([[0, 4], [1, 2], [3, -1]], np.int32)}
    yield "slots shape", {**good, "slots": slots.ravel()}
    yield "no nodes", {**good, "slots": np.zeros((0, 2), np.int32), "out": z(0, 2, 6),
                       "tables": z(0, 2, 2, 256)}
    yield "plan past src", {**good, "slots": kernel.EncodePlan(slots, 5, "cpu")}


@pytest.mark.parametrize("what,operands", list(_bad_operands()), ids=lambda x: str(x)[:20])
def test_encode_chain_refuses_bad_operands(what, operands):
    """The plain route refuses what the card's wrapper refuses, before any
    tick; the card's wrapper refuses CPU tensors and launches nothing."""
    before = kernel.launch_counts()
    with pytest.raises(ValueError):
        ops.encode_chain(operands["src"], operands["slots"], operands["out"],
                         operands["tables"], operands["l"], 2)
    with pytest.raises(ValueError):
        kernel.encode_chain(operands["src"], operands["slots"], operands["out"],
                            operands["tables"], operands["l"])
    assert kernel.launch_counts() == before


def test_encode_chain_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(2)
    _, src, slots, _, _, tables = chain_case(rng, 16, 3, 2, 1, 4)
    before = kernel.encode_chain.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.encode_chain(src, slots, out_like(3, src, False), tables, 16)
    assert kernel.encode_chain.launches == before


def test_unplaced_encode_many_programs_keep_no_wires():
    """An unplaced batch encode program keeps no wires; a placed one keeps
    its positions' wires of W slots."""
    code = code_case(8, 4, 16)
    B = gf.LANES[16] * CHUNKS * 4

    def plan(**where):
        return chain.call_plan(code, "test", "encode_many", B, CHUNKS, 1, chain_len=code.n,
                               B_obj=3, **where)
    assert chain.build_encode(code, plan(device="cpu")).wire_shape is None
    placed = chain.build_encode(code, plan(mesh=chain.make_chain_mesh(
        code.n, devices=["cpu"] * code.n)))
    assert placed.placement == pipeline.position_devices([torch.device("cpu")] * code.n)
    assert placed.wire_shape == (code.n, pipeline.window_size(CHUNKS, 3, 1), B // 2 // CHUNKS)


@pytest.mark.parametrize("n,k,l", CODES)
@pytest.mark.parametrize("batch,stagger", [(False, 0), (True, 0), (True, 1)])
def test_plain_route_matches_the_jax_package(saved, n, k, l, batch, stagger):
    """``ops.encode_chain`` on the CPU == the JAX package's ``encode_np``
    kept in the npz, one object or the three as a batch."""
    name = f"c_n{n}_k{k}_l{l}"
    data, want = saved[name + "_data"], saved[name + "_cw"]
    if not batch:
        data, want = data[:1], want[:1]
    src, slots, tables = code_operands(code_case(n, k, l), data, "cpu")
    out = out_like(n, src, batch)
    ops.encode_chain(src, slots, out, tables, l, CHUNKS, stagger)
    np.testing.assert_array_equal(gf.unpack_u32(out.transpose(0, 1), l).numpy(), want)


@pytest.mark.parametrize("n,k,l", CODES)
def test_entry_points_on_the_cpu_match_the_jax_package(saved, n, k, l):
    name = f"c_n{n}_k{k}_l{l}"
    data, want = saved[name + "_data"], saved[name + "_cw"]
    code = code_case(n, k, l)
    got = chain.pipelined_encode(code, data[0], CHUNKS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want[0])
    got = multi.pipelined_encode_many(code, data, CHUNKS, 1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _ticks_on_the_card(src, slots, tables, l, n, batch, stagger):
    """The same chain as ``kernel.chain_tick`` ticks on the card, and the
    launches it took."""
    out = out_like(n, src, batch)
    before = kernel.chain_tick.launches
    ops._encode_chain_ticks(src, slots, out, tables, l, CHUNKS, stagger)
    return out, kernel.chain_tick.launches - before


def _check_against_ticks(cuda, l, n, max_b, n_obj, S, batch):
    rng = np.random.default_rng([l, n, max_b, n_obj, S])
    words, src, slots, psi, xi, tables = chain_case(rng, l, n, max_b, n_obj, S)
    src, tables = src.to(cuda), tables.to(cuda)
    want, ticks = _ticks_on_the_card(src, slots, tables, l, n, batch, 1 if batch else 0)
    assert ticks > 0
    out = out_like(n, src, batch)
    before = kernel.launch_counts()
    kernel.encode_chain(src, slots, out, tables, l)
    after = kernel.launch_counts()
    torch.cuda.synchronize()
    assert after["encode_chain"] - before["encode_chain"] == 1
    assert after["chain_tick"] == before["chain_tick"]
    assert torch.equal(out, want)
    if n <= 16:
        np.testing.assert_array_equal(gf.unpack_u32(out.cpu(), l).numpy(),
                                      oracle(words, slots, psi, xi, l))


@pytest.mark.gpu
@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("n,max_b", [(1, 1), (5, 1), (16, 2), (8, 2), (6, 3), (4, 5)])
@pytest.mark.parametrize("S", [64, 37])                # 16-byte lanes, 4-byte lanes
@pytest.mark.parametrize("batch", [False, True])
def test_encode_chain_kernel_matches_the_ticks(cuda, l, n, max_b, S, batch):
    _check_against_ticks(cuda, l, n, max_b, 3 if batch else 1, S, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("l,n,max_b", [
    (16, 300, 3),          # 234 KB of nibble tables: staged in slot groups
    (8, 300, 4),           # 300 nodes, every slot staged at once
    (16, 2, 512)])         # the most slots a node takes
def test_encode_chain_kernel_past_its_caps_matches_the_ticks(cuda, l, n, max_b):
    _check_against_ticks(cuda, l, n, max_b, 2, 8, True)


@pytest.mark.gpu
def test_encode_chain_kernel_reads_unaligned_blocks(cuda):
    """Blocks whose rows start one lane past a 16-byte boundary take the
    4-byte lanes, with the same result."""
    rng = np.random.default_rng(3)
    l, n, max_b = 16, 16, 2
    words, src, slots, psi, xi, tables = chain_case(rng, l, n, max_b, 2, 16)
    n_obj, R, Bp = src.shape
    host = torch.zeros((n_obj * R * Bp + 1,), dtype=torch.int32)
    host[1:] = src.reshape(-1)
    moved = host.to(cuda)[1:].view(n_obj, R, Bp)
    assert moved.data_ptr() % 16
    out = out_like(n, moved, False)
    kernel.encode_chain(moved, slots, out, tables.to(cuda), l)
    np.testing.assert_array_equal(gf.unpack_u32(out.cpu(), l).numpy(),
                                  oracle(words, slots, psi, xi, l))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,l", CODES)
@pytest.mark.parametrize("batch", [False, True])
def test_encode_chain_kernel_matches_the_jax_package(cuda, saved, n, k, l, batch):
    name = f"c_n{n}_k{k}_l{l}"
    data, want = saved[name + "_data"], saved[name + "_cw"]
    if not batch:
        data, want = data[:1], want[:1]
    src, slots, tables = code_operands(code_case(n, k, l), data, cuda)
    out = out_like(n, src, batch)
    before = kernel.encode_chain.launches
    kernel.encode_chain(src, slots, out, tables, l)
    torch.cuda.synchronize()
    assert kernel.encode_chain.launches == before + 1
    np.testing.assert_array_equal(gf.unpack_u32(out.transpose(0, 1).cpu(), l).numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,l", CODES)
def test_unplaced_entry_points_on_the_card_launch_one_chain(cuda, saved, n, k, l):
    """``pipelined_encode`` and ``pipelined_encode_many`` on the card == the
    JAX package's codewords, in one ``encode_chain`` launch and no tick,
    zeroing no wire."""
    name = f"c_n{n}_k{k}_l{l}"
    data, want = saved[name + "_data"], saved[name + "_cw"]
    code = code_case(n, k, l)
    calls = {
        "encode": (lambda: chain.pipelined_encode(code, data[0], CHUNKS), want[0]),
        "encode_many": (lambda: multi.pipelined_encode_many(code, data, CHUNKS, 1), want),
    }
    for what, (call, answer) in calls.items():
        for _ in range(2):                            # the program built, then warm
            kernel.reset_launch_counts()
            zeroed = pipeline.stats()["wire_bytes_zeroed"]
            got = call()
            torch.cuda.synchronize()
            assert got.device.type == "cuda"
            assert kernel.launch_counts()["encode_chain"] == 1, what
            assert kernel.launch_counts()["chain_tick"] == 0, what
            assert pipeline.stats()["wire_bytes_zeroed"] == zeroed, what
            np.testing.assert_array_equal(got.cpu().numpy(), answer, err_msg=what)


@pytest.mark.gpu
def test_streamed_encode_launches_one_chain_a_stripe(cuda):
    """A streamed run replays one ``encode_chain`` launch a stripe (its
    graphs captured over no wires), equal to ``encode_np``."""
    code = code_case(16, 11, 16)
    rng = np.random.default_rng(5)
    sc = gf.LANES[16] * CHUNKS * 16
    data = rng.integers(0, 1 << 16, size=(2, code.k, 4 * sc - 6)).astype(np.uint16)
    want = np.stack([code.encode_np(x) for x in data])
    stripes = 4
    runs = {
        "encode": (lambda: chain.pipelined_encode(code, data[0], CHUNKS, superchunk_words=sc),
                   want[0]),
        "encode_many": (lambda: multi.pipelined_encode_many(code, data, CHUNKS, 1,
                                                           superchunk_words=sc), want),
    }
    for what, (run, answer) in runs.items():
        zeroed = pipeline.stats()["wire_bytes_zeroed"]
        np.testing.assert_array_equal(run().numpy(), answer, err_msg=what)
        kernel.reset_launch_counts()
        np.testing.assert_array_equal(run().numpy(), answer, err_msg=what)
        assert kernel.launch_counts()["encode_chain"] == stripes, what
        assert kernel.launch_counts()["chain_tick"] == 0, what
        assert pipeline.stats()["wire_bytes_zeroed"] == zeroed, what


@pytest.mark.gpu
def test_streamed_graphs_outlive_other_plans(cuda):
    """A streamed program's captured graphs read the plan the program holds:
    after more than a thousand one-off plans of frozen slot tables are made
    and freed and the freed memory is written over, a later run replays the
    same graphs to the same rows."""
    code = code_case(16, 11, 16)
    rng = np.random.default_rng(6)
    sc = gf.LANES[16] * CHUNKS * 16
    data = rng.integers(0, 1 << 16, size=(code.k, 3 * sc)).astype(np.uint16)
    want = code.encode_np(data)

    def run():
        return chain.pipelined_encode(code, data, CHUNKS, superchunk_words=sc).numpy()
    np.testing.assert_array_equal(run(), want)
    _, src, _, _, _, tables = chain_case(rng, 16, 16, 2, 1, 1)
    src, tables = src.to(cuda), tables.to(cuda)
    out = out_like(16, src, False)
    for _ in range(1100):
        slots = rng.integers(-1, src.shape[1], size=(16, 2)).astype(np.int32)
        slots.flags.writeable = False
        kernel.encode_chain(src, slots, out, tables, 16)
    litter = [torch.full((256,), -1, dtype=torch.int32, device=cuda) for _ in range(4096)]
    kernel.reset_launch_counts()
    np.testing.assert_array_equal(run(), want)
    assert kernel.launch_counts()["encode_chain"] == 3
    del litter


@pytest.mark.gpu
def test_placed_and_layout_encodes_keep_their_ticks(cuda):
    """``mesh=`` on ``[cuda:0] * n`` and ``layout=`` on ``[cuda:0] * 4``
    still launch ``chain_tick``, over wires, and no ``encode_chain``."""
    n, k, l = 16, 11, 16
    code = code_case(n, k, l)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 1 << l, size=(3, k, gf.LANES[l] * CHUNKS * 64)).astype(np.uint16)
    want = np.stack([code.encode_np(x) for x in data])
    mesh = chain.make_chain_mesh(n, devices=[cuda] * n)
    layout = chain.CardLayout(code, [cuda] * 4)
    resident = [torch.from_numpy(data[:, list(b)]).contiguous().to(cuda) for b in layout.blocks]
    calls = {
        "mesh": lambda: chain.pipelined_encode(code, data[0], CHUNKS, mesh=mesh).cpu().numpy(),
        "layout": lambda: np.concatenate(
            [rows.cpu().numpy() for rows in multi.pipelined_encode_many(
                code, resident, CHUNKS, 1, layout=layout)], axis=1),
    }
    wants = {"mesh": want[0], "layout": want}
    for what, call in calls.items():
        kernel.reset_launch_counts()
        zeroed = pipeline.stats()["wire_bytes_zeroed"]
        got = call()
        assert kernel.launch_counts()["chain_tick"] > 0, what
        assert kernel.launch_counts()["encode_chain"] == 0, what
        assert pipeline.stats()["wire_bytes_zeroed"] > zeroed, what
        np.testing.assert_array_equal(got, wants[what], err_msg=what)
