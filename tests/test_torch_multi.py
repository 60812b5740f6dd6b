"""Staggered multi-object encode, decode and repair of the PyTorch/CUDA port.

On the CPU the entry points (``storage.multi.pipelined_encode_many`` /
``pipelined_decode_many``, ``storage.repair.pipelined_repair_many``) run
the tick kernels' plain versions and are held bit for bit against what
runs here of the JAX package: the staggered numpy oracle
``pipeline_encode_local_many`` (codewords and tick count), ``decode_np`` /
``repair_np`` per object, its ``window_size`` / ``num_ticks_many``, and,
for cells of a staggered tick, its single-device ``chain_step`` /
``repair_step`` ops in interpret mode. Tests marked ``gpu`` hold the
staggered CUDA ticks against their plain versions and skip without a card.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codes, gf, pipeline, rapidraid as rr  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp
    from repro.core import pipeline as jpipeline
    from repro.core import rapidraid as jrr
    from repro.kernels.gf_encode import ops as jops
except ImportError:
    jnp = None

GEOMETRIES = [(8, 4), (6, 4), (16, 11)]
CHUNKS = 4


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


def lanes(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def t32(x: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(device)


def u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).view(np.uint32)


def block_words(l: int, chunks: int = CHUNKS, lanes_per_chunk: int = 3) -> int:
    return gf.LANES[l] * chunks * lanes_per_chunk


def first_loss(code, count: int, seed: int) -> list[int]:
    """A decodable ``count``-node loss pattern, the first in a seeded order."""
    combos = list(itertools.combinations(range(code.n), count))
    for j in np.random.default_rng(seed).permutation(len(combos)):
        if code.decodable([i for i in range(code.n) if i not in combos[j]]):
            return list(combos[j])
    raise AssertionError("no decodable loss pattern")


class TickSpy:
    """Counts the ticks an entry point runs and records their operands."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("chain_tick", "repair_tick"):
            real = getattr(ops, name)

            def spy(*args, _real=real, **kwargs):
                self.calls.append((args, kwargs))
                return _real(*args, **kwargs)
            monkeypatch.setattr(ops, name, spy)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_objects", [1, 2, 5, 16])
@pytest.mark.parametrize("num_chunks", [1, 4, 8])
def test_window_and_ticks_match_jax(num_chunks, num_objects):
    for stagger in range(1, num_chunks + 3):
        assert (pipeline.window_size(num_chunks, num_objects, stagger)
                == jpipeline.window_size(num_chunks, num_objects, stagger))
        for n in (1, 4, 16):
            assert (pipeline.num_ticks_many(num_chunks, n, num_objects, stagger)
                    == jpipeline.num_ticks_many(num_chunks, n, num_objects, stagger))


@pytest.mark.parametrize("stagger", [1, 2, 3, 4, 5, 9])
@pytest.mark.parametrize("num_objects", [1, 3, 7])
def test_window_slots_are_consistent(num_objects, stagger):
    """Over a whole staggered run: every (node, object, chunk) is worked
    exactly once, by a tick whose node range holds the node; no two active
    objects of a node share a slot; and object b at node i + 1 reads the
    slot node i wrote it to one tick before."""
    n, C = 5, 4
    W = pipeline.window_size(C, num_objects, stagger)
    seen = {}
    for t in range(pipeline.num_ticks_many(C, n, num_objects, stagger)):
        lo, count = pipeline.active_nodes_many(t, n, C, num_objects, stagger)
        assert count >= 1
        nodes, b, ch, active = ref._tick_objects(t, lo, count, W, num_objects, C, stagger,
                                                 "cpu")
        for a, w in zip(*active.nonzero(as_tuple=True)):
            i, obj, c = int(nodes[a]), int(b[a, w]), int(ch[a, w])
            assert obj % W == int(w)
            assert (i, obj, c) not in seen
            seen[(i, obj, c)] = t
    assert sorted(seen) == sorted(itertools.product(range(n), range(num_objects), range(C)))
    for (i, obj, c), t in seen.items():
        assert t == i + obj * stagger + c
        if i:
            assert seen[(i - 1, obj, c)] == t - 1


# ---------------------------------------------------------------------------
# the entry points against the JAX package's oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stagger", range(1, CHUNKS + 2))
@pytest.mark.parametrize("num_objects", [1, 2, 5])
@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("n,k", GEOMETRIES)
def test_encode_many_matches_staggered_oracle(n, k, l, num_objects, stagger, monkeypatch):
    """Codewords and tick count == ``pipeline_encode_local_many`` of the
    JAX package, one tick launch per tick."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=5)
    jcode = jrr.RapidRAIDCode.make(n, k, l=l, seed=5)
    objects = words(np.random.default_rng(stagger + 10 * num_objects),
                    (num_objects, k, block_words(l)), l)
    want, ticks = jrr.pipeline_encode_local_many(jcode, objects, num_chunks=CHUNKS,
                                                 stagger=stagger)
    spy = TickSpy(monkeypatch)
    got = multi.pipelined_encode_many(code, objects, CHUNKS, stagger, device="cpu")
    assert got.dtype == gf.TORCH_WORD_DTYPE[l]
    np.testing.assert_array_equal(got.numpy(), want)
    assert ticks == pipeline.num_ticks_many(CHUNKS, n, num_objects, stagger)
    assert len(spy.calls) == ticks
    assert all(kw == {} and args[-1] == stagger for args, kw in spy.calls)


@pytest.mark.parametrize("stagger", [1, 2, CHUNKS, CHUNKS + 1])
@pytest.mark.parametrize("num_objects", [1, 2, 5])
@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("n,k", GEOMETRIES)
def test_decode_and_repair_many_match_per_object_oracles(n, k, l, num_objects, stagger,
                                                         monkeypatch):
    """``pipelined_decode_many`` returns the objects (== ``decode_np`` of
    each), ``pipelined_repair_many`` == ``repair_np`` of each, each in
    ``num_ticks_many`` ticks of its chain."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=6)
    jcode = jrr.RapidRAIDCode.make(n, k, l=l, seed=6)
    objects = words(np.random.default_rng(stagger), (num_objects, k, block_words(l)), l)
    cw = np.stack([code.encode_np(o) for o in objects])
    lost = first_loss(code, n - k, seed=stagger)
    ids = [i for i in range(n) if i not in lost]
    spy = TickSpy(monkeypatch)
    dec = multi.pipelined_decode_many(code, ids, cw[:, ids], CHUNKS, stagger, device="cpu")
    for b in range(num_objects):
        np.testing.assert_array_equal(dec[b].numpy(), jcode.decode_np(ids, cw[b, ids]))
    np.testing.assert_array_equal(dec.numpy(), objects)
    assert len(spy.calls) == pipeline.num_ticks_many(CHUNKS, len(ids), num_objects, stagger)
    spy.calls.clear()
    rep = repair.pipelined_repair_many(code, ids, torch.from_numpy(cw[:, ids]), lost, CHUNKS,
                                       stagger, device="cpu")
    helpers = jcode.repair_plan(lost, ids)[0]
    assert len(spy.calls) == pipeline.num_ticks_many(CHUNKS, len(helpers), num_objects,
                                                     stagger)
    for b in range(num_objects):
        np.testing.assert_array_equal(rep[b].numpy(), jcode.repair_np(lost, ids, cw[b, ids]))
    np.testing.assert_array_equal(rep.numpy(), cw[:, lost])


def test_defaults_are_eight_chunks_and_stagger_one(monkeypatch, tmp_path):
    """``num_chunks=None`` / ``stagger=None`` run 8 chunks at stagger 1
    under an empty tuning cache."""
    from repro_torch.core import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.delenv(autotune.TUNE_ENV, raising=False)
    autotune.reset()
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=7)
    objects = words(np.random.default_rng(0), (3, 4, 2 * 8 * 2), 16)
    seen = []
    real = pipeline.staggered_pipeline

    def spy(step, n, num_chunks, slot_shape, **kw):
        seen.append((num_chunks, kw["stagger"]))
        return real(step, n, num_chunks, slot_shape, **kw)

    monkeypatch.setattr(pipeline, "staggered_pipeline", spy)
    cw = multi.pipelined_encode_many(code, objects, device="cpu")
    ids = list(range(1, 8))
    multi.pipelined_decode_many(code, ids, cw[:, ids], device="cpu")
    repair.pipelined_repair_many(code, ids, cw[:, ids], [0], device="cpu")
    assert seen == [(8, 1)] * 3
    want, _ = jrr.pipeline_encode_local_many(jrr.RapidRAIDCode.make(8, 4, l=16, seed=7),
                                             objects, num_chunks=8, stagger=1)
    np.testing.assert_array_equal(cw.numpy(), want)


def test_batches_are_read_and_written_in_place(monkeypatch):
    """No entry point transposes or gathers its batch: every tick reads the
    caller's packed objects or shards and writes the output tensor that is
    returned, through views."""
    code = rr.RapidRAIDCode.make(6, 4, l=16, seed=8)
    objects = torch.from_numpy(words(np.random.default_rng(1), (3, 4, 48), 16))
    spy = TickSpy(monkeypatch)
    cw = multi.pipelined_encode_many(code, objects, 4, 2, device="cpu")
    srcs = {args[2].data_ptr() for args, _ in spy.calls}
    outs = {(args[4].data_ptr(), args[4].stride()) for args, _ in spy.calls}
    assert srcs == {objects.data_ptr()}
    assert outs == {(cw.data_ptr(), (48 // 2, 6 * 48 // 2, 1))}
    shards = cw[:, 1:].contiguous()
    for run in (lambda: multi.pipelined_decode_many(code, range(1, 6), shards, 4, 2,
                                                    device="cpu"),
                lambda: repair.pipelined_repair_many(code, range(1, 6), shards, [0], 4, 2,
                                                     device="cpu")):
        spy.calls.clear()
        got = run()
        assert {args[2].data_ptr() for args, _ in spy.calls} == {shards.data_ptr()}
        assert {args[2].stride() for args, _ in spy.calls} == {(24, 5 * 24, 1)}
        assert {args[4].data_ptr() for args, _ in spy.calls} == {got.data_ptr()}


@pytest.mark.parametrize("stagger", [1, 3, 8])
@pytest.mark.parametrize("l", [8, 16])
def test_staggered_tick_cells_match_jax_ops(l, stagger):
    """Cells of one staggered tick of the plain versions == the JAX
    package's single-device ``chain_step`` / ``repair_step`` (interpret
    mode) on the same object's blocks, chunk and wire slot; a slot without
    an object at that tick is not written."""
    rng = np.random.default_rng(3 + stagger)
    n, C, n_obj, S, max_b, R = 6, 4, 5, 32, 2, 4
    W = pipeline.window_size(C, n_obj, stagger)
    t = n + stagger                 # the last node works object 1's chunk 1
    lo, count = pipeline.active_nodes_many(t, n, C, n_obj, stagger)
    slots = rng.integers(0, R, size=(n, max_b)).astype(np.int32)
    psi, xi = rng.integers(1, 1 << l, size=(2, n, max_b))
    bp_psi, bp_xi = gf.bitplane_table(psi, l), gf.bitplane_table(xi, l)
    tables = t32(kernel.product_tables(bp_psi, bp_xi, l))
    src, wire_in = lanes(rng, (n_obj, R, S * C)), lanes(rng, (n + 1, W, S))
    out = torch.zeros((n_obj, n, S * C), dtype=torch.int32)
    wire_out = torch.zeros((n + 1, W, S), dtype=torch.int32)
    ops.chain_tick(t32(wire_in), wire_out, t32(src), slots, out.transpose(0, 1), tables, l,
                   t, C, lo, count, stagger)
    rows = 3
    bp = gf.bitplane_table(rng.integers(1, 1 << l, size=(n, rows)), l)
    shards = lanes(rng, (n_obj, n, S * C))
    shard_rows = rng.permutation(n).astype(np.int32)
    rwire_in = lanes(rng, (n, W, rows, S))
    rout = torch.zeros((n_obj, rows, S * C), dtype=torch.int32)
    rwire_out = torch.zeros((n, W, rows, S), dtype=torch.int32)
    ops.repair_tick(t32(rwire_in), rwire_out, t32(shards).transpose(0, 1), shard_rows, rout,
                    t32(kernel.repair_tables(bp, l)), l, t, C, lo, count, False, stagger)
    cells = []
    for i in range(lo, lo + count):
        for w in range(W):
            active = [b for b in range(n_obj) if b % W == w and 0 <= t - i - b * stagger < C]
            if active:
                cells.append((i, w, active[0]))
            else:
                assert not u32(wire_out[i + 1, w]).any()
    # the JAX steps run in interpret mode: hold three cells, the last node's among them
    last = [c for c in cells if c[0] == n - 1]
    assert len(cells) >= 3 and last
    for i, w, b in {cells[0], cells[len(cells) // 2], last[0]}:
        sl = slice((t - i - b * stagger) * S, (t - i - b * stagger + 1) * S)
        local = np.where(slots[i][:, None] >= 0, src[b, slots[i].clip(0), sl], 0)
        jc, jxo = jops.chain_step(jnp.asarray(wire_in[i, w][None]), jnp.asarray(local),
                                  jnp.asarray(bp_psi[i]), jnp.asarray(bp_xi[i]), l, block=S)
        np.testing.assert_array_equal(u32(out)[b, i, sl], np.asarray(jc)[0])
        np.testing.assert_array_equal(u32(wire_out)[i + 1, w], np.asarray(jxo)[0])
        acc = jops.repair_step(jnp.asarray(rwire_in[i, w]),
                               jnp.asarray(shards[b, shard_rows[i], sl][None]),
                               jnp.asarray(bp[i]), l, block=S)
        got = u32(rout)[b, :, sl] if i == n - 1 else u32(rwire_out)[i + 1, w]
        np.testing.assert_array_equal(got, np.asarray(acc))


def test_gaps_between_objects_keep_one_launch_a_tick(monkeypatch):
    """At a stagger above num_chunks a node may fall between two objects:
    the tick still covers the run's span in one launch, the idle nodes
    write nothing, and the codewords are right."""
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=9)
    objects = words(np.random.default_rng(2), (3, 4, 4 * 2 * 3), 8)
    spy = TickSpy(monkeypatch)
    got = multi.pipelined_encode_many(code, objects, 2, 5, device="cpu")
    want, ticks = jrr.pipeline_encode_local_many(jrr.RapidRAIDCode.make(8, 4, l=8, seed=9),
                                                 objects, num_chunks=2, stagger=5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(spy.calls) == ticks
    spans = [(args[9], args[10]) for args, _ in spy.calls]
    assert spans == [pipeline.active_nodes_many(t, 8, 2, 3, 5) for t in range(ticks)]
    gaps = [t for t, (lo, count) in enumerate(spans)
            if any(not any(0 <= t - i - b * 5 < 2 for b in range(3))
                   for i in range(lo, lo + count))]
    assert gaps


def test_frozen_host_tables_are_checked_once():
    """The ticks' host tables (slots, shard rows) are checked once when
    frozen (read-only arrays that own their data: the entry points' cached
    tables), on every call otherwise; a bad table raises either way."""
    calls = []

    def check(name, table, bound):
        calls.append(name)
        return kernel._check_shard_rows(name, table, bound)

    frozen = chain.identity_rows(5)
    for _ in range(3):
        assert kernel._checked_table(check, "a", frozen, 5) is frozen
    kernel._checked_table(check, "b", frozen, 6)         # another bound: checked again
    loose = np.arange(5, dtype=np.int32)
    view = np.arange(5, dtype=np.int32)[:]
    view.setflags(write=False)                            # frozen, but its base is not
    for _ in range(2):
        kernel._checked_table(check, "c", loose, 5)
        kernel._checked_table(check, "d", view, 5)
    assert calls == ["a", "b", "c", "d", "c", "d"]
    bad = np.array([0, 7], dtype=np.int32)
    bad.setflags(write=False)
    for _ in range(2):
        with pytest.raises(ValueError, match="shard_rows"):
            kernel._checked_table(kernel._check_shard_rows, "repair_tick", bad, 5)


def test_check_tick_takes_the_staggered_span():
    """``kernel._check_tick``: nodes inside the staggered span pass, nodes
    past it and wires of the wrong window raise."""
    ok = dict(l=16, num_chunks=4, n=6, S=3, Bp=12)
    kernel._check_tick("t", t=9, node_lo=2, node_count=4, n_obj=3, W=2, stagger=2, **ok)
    kernel._check_tick("t", t=2, node_lo=0, node_count=3, n_obj=3, W=3, stagger=0, **ok)
    for bad in (dict(t=9, node_lo=0, node_count=6, n_obj=2, W=2, stagger=2),   # node 0 done
                dict(t=2, node_lo=0, node_count=4, n_obj=3, W=2, stagger=2),   # node 3 not begun
                dict(t=4, node_lo=0, node_count=5, n_obj=3, W=3, stagger=2),   # W != window
                dict(t=2, node_lo=0, node_count=3, n_obj=3, W=2, stagger=0),   # lockstep W
                dict(t=2, node_lo=0, node_count=3, n_obj=3, W=2, stagger=-1)):
        with pytest.raises(ValueError):
            kernel._check_tick("t", **bad, **ok)


def test_errors_like_jax():
    """The JAX entry points' checks: a family without a chain schedule,
    sub-packetized shards, wrong shapes; plus bad staggers and word types."""
    lrc, mbr = codes.make("lrc", 8, 4, l=16), codes.make("mbr", 8, 4, l=16)
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=1)
    objects = words(np.random.default_rng(0), (2, 4, 32), 16)
    for fam in (lrc, mbr):
        with pytest.raises(ValueError, match="has no chain schedule"):
            multi.pipelined_encode_many(fam, objects, device="cpu")
    shards = np.stack([code.encode_np(o) for o in objects])
    with pytest.raises(ValueError, match="sub-packetized"):
        multi.pipelined_decode_many(mbr, range(5), shards[:, :5], device="cpu")
    with pytest.raises(ValueError, match="sub-packetized"):
        repair.pipelined_repair_many(mbr, range(1, 8), shards[:, 1:], [0], device="cpu")
    with pytest.raises(ValueError, match=r"must be \(B_obj, k=4, B\)"):
        multi.pipelined_encode_many(code, objects[0], device="cpu")
    with pytest.raises(ValueError, match=r"must be \(B_obj, len\(ids\)=5, B\)"):
        multi.pipelined_decode_many(code, range(5), shards[:, :6], device="cpu")
    with pytest.raises(ValueError, match=r"must be \(B_obj, len\(ids\)=7, B\)"):
        repair.pipelined_repair_many(code, range(1, 8), shards[0, 1:], [0], device="cpu")
    for bad in (0, -2):
        with pytest.raises(ValueError, match="stagger"):
            multi.pipelined_encode_many(code, objects, 4, bad, device="cpu")
    with pytest.raises(ValueError):       # wrong word type for GF(2^16)
        multi.pipelined_encode_many(code, objects.astype(np.uint8), device="cpu")
    with pytest.raises(ValueError):       # 30 words are no 8 chunks of lanes
        multi.pipelined_encode_many(code, objects[:, :, :30], device="cpu")
    with pytest.raises(ValueError, match="not decodable"):
        repair.pipelined_repair_many(code, [0], shards[:, :1], [1], 1, device="cpu")


def test_entry_points_default_to_cuda():
    """Without a card, an entry point called without ``device`` raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=1)
    objects = words(np.random.default_rng(0), (2, 4, 32), 16)
    shards = np.stack([code.encode_np(o) for o in objects])[:, 1:]
    before = kernel.launch_counts()
    for call in (lambda: multi.pipelined_encode_many(code, objects),
                 lambda: multi.pipelined_decode_many(code, range(1, 8), shards),
                 lambda: repair.pipelined_repair_many(code, range(1, 8), shards, [0])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert kernel.launch_counts() == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("stagger", [1, 2, 4, 5])
@pytest.mark.parametrize("max_b", [1, 2, 3])
@pytest.mark.parametrize("l", [8, 16])
def test_chain_tick_staggered_matches_plain(cuda, l, max_b, stagger):
    """A whole staggered run, tick by tick, at stagger 1, 2, C and C + 1,
    5 objects (not a multiple of the window), ``out`` laid out (B_obj, n,
    Bp) and passed as its (n, B_obj, Bp) view: the kernel == the plain
    version in every tick's wire and in the codewords."""
    rng = np.random.default_rng(31 + stagger + max_b)
    n, C, n_obj, R, S = 6, 4, 5, 4, 1000
    W = pipeline.window_size(C, n_obj, stagger)
    slots = rng.integers(0, R, size=(n, max_b)).astype(np.int32)
    slots[2, max_b - 1] = -1
    psi, xi = rng.integers(1, 1 << l, size=(2, n, max_b))
    psi[n - 1] = 0
    tables = t32(kernel.product_tables(gf.bitplane_table(psi, l), gf.bitplane_table(xi, l),
                                       l), cuda)
    src = t32(lanes(rng, (n_obj, R, S * C)), cuda)
    outs, wires = {}, {}
    for fn in (kernel.chain_tick, ref.chain_tick_ref):
        outs[fn] = torch.zeros((n_obj, n, S * C), dtype=torch.int32, device=cuda)
        wires[fn] = [torch.zeros((n, W, S), dtype=torch.int32, device=cuda) for _ in range(2)]
    for t in range(pipeline.num_ticks_many(C, n, n_obj, stagger)):
        lo, count = pipeline.active_nodes_many(t, n, C, n_obj, stagger)
        for fn in outs:
            w = wires[fn]
            fn(w[(t + 1) % 2], w[t % 2], src, slots, outs[fn].transpose(0, 1), tables, l, t,
               C, lo, count, stagger)
        torch.cuda.synchronize()
        assert torch.equal(wires[kernel.chain_tick][t % 2], wires[ref.chain_tick_ref][t % 2]), t
    assert torch.equal(outs[kernel.chain_tick], outs[ref.chain_tick_ref])


@pytest.mark.gpu
@pytest.mark.parametrize("stagger", [1, 2, 4, 5])
@pytest.mark.parametrize("rows", [3, 11])
@pytest.mark.parametrize("l", [8, 16])
def test_repair_tick_staggered_matches_plain(cuda, l, rows, stagger):
    """The same for the repair tick: survivors' shards laid out (B_obj, R,
    Bp) and passed as their (R, B_obj, Bp) view, read through a row table
    that is not the identity, node 0's head row skipped."""
    rng = np.random.default_rng(37 + stagger + rows)
    n, C, n_obj, S = 5, 4, 5, 1002
    W = pipeline.window_size(C, n_obj, stagger)
    shards = t32(lanes(rng, (n_obj, n + 2, S * C)), cuda).transpose(0, 1)
    shard_rows = rng.permutation(n + 2)[:n].astype(np.int32)
    bp = gf.bitplane_table(rng.integers(1, 1 << l, size=(n, rows)), l)
    tables = t32(kernel.repair_tables(bp, l), cuda)
    outs, wires = {}, {}
    for fn in (kernel.repair_tick, ref.repair_tick_ref):
        outs[fn] = torch.zeros((n_obj, rows, S * C), dtype=torch.int32, device=cuda)
        wires[fn] = [torch.zeros((n, W, rows, S), dtype=torch.int32, device=cuda)
                     for _ in range(2)]
    for t in range(pipeline.num_ticks_many(C, n, n_obj, stagger)):
        lo, count = pipeline.active_nodes_many(t, n, C, n_obj, stagger)
        for fn in outs:
            w = wires[fn]
            fn(w[(t + 1) % 2], w[t % 2], shards, shard_rows, outs[fn], tables, l, t, C, lo,
               count, True, stagger)
        torch.cuda.synchronize()
        assert torch.equal(wires[kernel.repair_tick][t % 2], wires[ref.repair_tick_ref][t % 2])
    assert torch.equal(outs[kernel.repair_tick], outs[ref.repair_tick_ref])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["chain", "repair"])
def test_staggered_tick_over_300_nodes_matches_plain(cuda, which):
    """A staggered tick over more than 256 nodes with a window of 3 objects
    is two launches and == the plain version."""
    rng = np.random.default_rng(41)
    n, C, n_obj, stagger, S, l = 310, 300, 3, 1, 4, 16
    W = pipeline.window_size(C, n_obj, stagger)
    t = 305
    lo, count = pipeline.active_nodes_many(t, n, C, n_obj, stagger)
    assert count == 302 and W == 3          # the span: (3 - 1) * 1 + 300 nodes
    results = []
    if which == "chain":
        slots = rng.integers(0, 3, size=(n, 2)).astype(np.int32)
        psi, xi = rng.integers(1, 1 << l, size=(2, n, 2))
        tables = t32(kernel.product_tables(gf.bitplane_table(psi, l),
                                           gf.bitplane_table(xi, l), l), cuda)
        src = t32(lanes(rng, (n_obj, 3, S * C)), cuda)
        wire_in = t32(lanes(rng, (n, W, S)), cuda)
        for fn in (kernel.chain_tick, ref.chain_tick_ref):
            out = torch.zeros((n_obj, n, S * C), dtype=torch.int32, device=cuda)
            wire_out = torch.zeros_like(wire_in)
            before = kernel.chain_tick.launches
            fn(wire_in, wire_out, src, slots, out.transpose(0, 1), tables, l, t, C, lo, count,
               stagger)
            results.append((out, wire_out, kernel.chain_tick.launches - before))
    else:
        rows = 3
        shards = t32(lanes(rng, (n_obj, n, S * C)), cuda).transpose(0, 1)
        shard_rows = rng.permutation(n).astype(np.int32)
        tables = t32(kernel.repair_tables(
            gf.bitplane_table(rng.integers(1, 1 << l, size=(n, rows)), l), l), cuda)
        wire_in = t32(lanes(rng, (n, W, rows, S)), cuda)
        for fn in (kernel.repair_tick, ref.repair_tick_ref):
            out = torch.zeros((n_obj, rows, S * C), dtype=torch.int32, device=cuda)
            wire_out = torch.zeros_like(wire_in)
            before = kernel.repair_tick.launches
            fn(wire_in, wire_out, shards, shard_rows, out, tables, l, t, C, lo, count, False,
               stagger)
            results.append((out, wire_out, kernel.repair_tick.launches - before))
    torch.cuda.synchronize()
    assert results[0][2] == 2 and results[1][2] == 0
    for got, want in zip(results[0][:2], results[1][:2]):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("stagger", [1, 3, 9])
@pytest.mark.parametrize("n,k,l", [(8, 4, 8), (16, 11, 16)])
def test_entry_points_many_on_cuda_match_cpu(cuda, n, k, l, stagger):
    """The three staggered entry points on the card == on the CPU, each in
    ``num_ticks_many`` launches of its tick kernel."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=11)
    C, n_obj = 8, 5
    objects = words(np.random.default_rng(stagger), (n_obj, k, gf.LANES[l] * C * 33), l)
    want = multi.pipelined_encode_many(code, objects, C, stagger, device="cpu")
    kernel.reset_launch_counts()
    got = multi.pipelined_encode_many(code, objects, C, stagger, device=cuda)
    assert kernel.launch_counts()["chain_tick"] == pipeline.num_ticks_many(C, n, n_obj, stagger)
    assert torch.equal(gf.pack_u32(got, l).cpu(), gf.pack_u32(want, l))
    lost = first_loss(code, n - k, seed=1)
    ids = [i for i in range(n) if i not in lost]
    shards = want.numpy()[:, ids]
    for run, chain_len in (
            (lambda dev: multi.pipelined_decode_many(code, ids, shards, C, stagger, device=dev),
             len(ids)),
            (lambda dev: repair.pipelined_repair_many(code, ids, shards, lost, C, stagger,
                                                      device=dev), k)):
        cpu = run("cpu")
        kernel.reset_launch_counts()
        dev = run(cuda)
        assert kernel.launch_counts()["repair_tick"] == pipeline.num_ticks_many(
            C, chain_len, n_obj, stagger)
        assert torch.equal(gf.pack_u32(dev, l).cpu(), gf.pack_u32(cpu, l))
    np.testing.assert_array_equal(cpu.numpy(), want.numpy()[:, lost])
