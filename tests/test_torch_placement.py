"""Chain positions placed on the devices of a mesh (``mesh=`` / ``order=``).

On the CPU every position sits on a mesh of ``["cpu"] * n`` (the JAX
package's tests build n host devices out of one CPU the same way): encode,
decode, repair and their staggered forms are held bit for bit against the
JAX package's numpy oracles and against the same call with no mesh, with
the cases of ``tests/test_storage_distributed.py`` and
``tests/test_multi_object.py`` and the identity, reversed and
``order_chain`` orders. A placed run is one tick launch a position (n x
num_chunks) over ``num_chunks + n - 1`` ticks. ``repair_tick``'s
``last_forwards`` is held against the JAX ``repair_step`` sums, and every
position is also run as one on another device than the call's (its blocks
or shard gathered onto it, its output copied back). ``gpu`` tests run the
kernels with placement on ``[cuda:0] * n``, and over the cards of a host
with several, against the CPU.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fault_tolerance, gf, pipeline, rapidraid as rr  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp

    from repro.core import rapidraid as jrr
    from repro.kernels.gf_encode import ref as jref
    from repro.storage import repair as jrepair
except ImportError:
    jrr = None

CHAIN_CASES = [(8, 4, 8, 4), (8, 4, 16, 4), (6, 4, 16, 3), (16, 11, 16, 8)]
MANY_CASES = [(8, 4, 8, 4, 3, 1), (8, 4, 16, 4, 3, 4), (6, 4, 16, 3, 4, 2)]
ORDERS = ["identity", "reversed", "order_chain"]


@pytest.fixture(autouse=True)
def _reference(request):
    if jrr is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def words(rng, shape, l):
    return rng.integers(0, 1 << l, size=shape).astype(gf.WORD_DTYPE[l])


def order_of(kind: str, n: int, k: int):
    if kind == "identity":
        return None
    if kind == "reversed":
        return list(range(n))[::-1]
    return chain.order_chain(np.random.default_rng(n).random(n), n, k)


def mesh_of(n: int, order=None, device="cpu") -> DeviceMesh:
    return chain.make_chain_mesh(n, order, devices=[device] * n)


def launches(monkeypatch):
    """Counts of the ops' tick calls, and the ticks each pipeline run took."""
    calls = collections.Counter()
    for name in ("chain_tick", "repair_tick"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    for name in ("software_pipeline", "staggered_pipeline"):
        real = getattr(pipeline, name)

        def run(*a, _real=real, **kw):
            calls["ticks"] += _real(*a, **kw)
            calls["placed"] += kw.get("placement") is not None
        monkeypatch.setattr(pipeline, name, run)
    return calls


def survivors(code):
    n, k = code.n, code.k
    for lost in ([0, n - 1], [1, n - 2], [0, 1], [n - 2, n - 1]):
        lost = sorted(set(lost))[:n - k]
        ids = [i for i in range(n) if i not in lost]
        if code.decodable(ids):
            return lost, ids
    raise AssertionError("no decodable loss among the candidates")


# ---------------------------------------------------------------------------
# the mesh and its placement
# ---------------------------------------------------------------------------


def test_position_devices_follow_the_chain_direction():
    devs = [torch.device("cpu")] * 3
    assert pipeline.position_devices(devs) == tuple(devs)
    meta = [torch.device("meta"), torch.device("cpu"), torch.device("cpu")]
    assert pipeline.position_devices(meta, reverse=True)[-1] == torch.device("meta")
    assert [w[1].shape[0] for w in pipeline.placed_wires((3, 1, 4), devs)] == [2, 2, 1]


def test_mesh_and_order_are_exclusive_and_checked():
    code = rr.RapidRAIDCode.make(8, 4, l=8, seed=13)
    data = words(np.random.default_rng(0), (4, 32), 8)
    with pytest.raises(ValueError, match="either mesh or order"):
        chain.pipelined_encode(code, data, 4, mesh=mesh_of(8), order=list(range(8)))
    with pytest.raises(ValueError, match="either mesh or order"):
        multi.pipelined_encode_many(code, data[None], 4, 1, mesh=mesh_of(8), order=[0] * 8)
    with pytest.raises(ValueError, match="either mesh or device"):
        chain.pipelined_encode(code, data, 4, device="cpu", mesh=mesh_of(8))
    with pytest.raises(ValueError, match="a mesh of 7 devices"):
        chain.pipelined_encode(code, data, 4, mesh=mesh_of(7))
    with pytest.raises(TypeError, match="DeviceMesh"):
        chain.pipelined_decode(code, range(4, 8), data, 4, mesh=object())
    with pytest.raises(ValueError, match=r"need 8 devices for an n=8 chain, have 1"):
        chain.pipelined_encode(code, data, 4, device="cpu", order=list(range(8)))


def test_archive_orders_the_device_chain_only_over_distinct_devices():
    """The scheduler's order reaches ``order=`` only where it names distinct
    visible devices: never for n > 1 on the host's one CPU device."""
    from repro_torch.storage import archive
    assert archive._device_order(np.arange(8)[::-1], True, "cpu") is None
    assert archive._device_order(np.arange(1), True, "cpu") == [0]
    assert archive._device_order(np.arange(1), False, "cpu") is None
    assert archive._device_order(np.zeros(2, int), True, "cpu") is None


# ---------------------------------------------------------------------------
# single objects
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ORDERS)
@pytest.mark.parametrize("n,k,l,chunks", CHAIN_CASES)
def test_placed_encode_matches_oracle(n, k, l, chunks, kind, monkeypatch):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=13), jrr.RapidRAIDCode.make(n, k, l=l,
                                                                                    seed=13)
    data = words(np.random.default_rng(0), (k, chunks * gf.LANES[l] * 8), l)
    unplaced = chain.pipelined_encode(code, data, chunks, device="cpu")
    calls = launches(monkeypatch)
    got = chain.pipelined_encode(code, data, chunks, mesh=mesh_of(n, order_of(kind, n, k)))
    assert calls == {"chain_tick": n * chunks, "ticks": chunks + n - 1, "placed": 1}
    np.testing.assert_array_equal(got.numpy(), jcode.encode_np(data))
    assert torch.equal(got, unplaced)


@pytest.mark.parametrize("kind", ORDERS)
@pytest.mark.parametrize("n,k,l,chunks", CHAIN_CASES)
def test_placed_decode_matches_oracle(n, k, l, chunks, kind, monkeypatch):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=13), jrr.RapidRAIDCode.make(n, k, l=l,
                                                                                    seed=13)
    data = words(np.random.default_rng(1), (k, chunks * gf.LANES[l] * 8), l)
    _, ids = survivors(code)
    cw = code.encode_np(data)
    h = len(ids)
    mesh = mesh_of(h, order_of(kind, h, min(k, h - 1)))
    calls = launches(monkeypatch)
    got = chain.pipelined_decode(code, ids, cw[ids], chunks, mesh=mesh)
    assert calls == {"repair_tick": h * chunks, "ticks": chunks + h - 1, "placed": 1}
    np.testing.assert_array_equal(got.numpy(), jcode.decode_np(ids, cw[ids]))
    np.testing.assert_array_equal(got.numpy(), data)


@pytest.mark.parametrize("kind", ORDERS)
@pytest.mark.parametrize("n,k,l,chunks", CHAIN_CASES)
def test_placed_repair_matches_oracle(n, k, l, chunks, kind, monkeypatch):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=13), jrr.RapidRAIDCode.make(n, k, l=l,
                                                                                    seed=13)
    data = words(np.random.default_rng(2), (k, chunks * gf.LANES[l] * 8), l)
    lost, ids = survivors(code)
    cw = code.encode_np(data)
    h = len(fault_tolerance.repair_plan(code, lost, ids)[0])
    unplaced = repair.pipelined_repair(code, ids, cw[ids], lost, chunks, device="cpu")
    calls = launches(monkeypatch)
    got = repair.pipelined_repair(code, ids, cw[ids], lost, chunks,
                                  mesh=mesh_of(h, order_of(kind, h, min(k, h - 1))))
    assert calls == {"repair_tick": h * chunks, "ticks": chunks + h - 1, "placed": 1}
    np.testing.assert_array_equal(got.numpy(), jrepair.repair_np(jcode, lost, ids, cw[ids]))
    np.testing.assert_array_equal(got.numpy(), cw[lost])
    assert torch.equal(got, unplaced)


@pytest.mark.parametrize("n,k,l,chunks", CHAIN_CASES)
def test_placed_paths_stream_superchunks(n, k, l, chunks):
    """``superchunk_words`` / ``sink`` with a mesh: stripes concatenate to
    the monolithic placed result."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    granule = chunks * gf.LANES[l]
    data = words(np.random.default_rng(3), (k, granule * 5 + granule // 2), l)
    want = code.encode_np(data)
    got = chain.pipelined_encode(code, data, chunks, mesh=mesh_of(n), superchunk_words=granule * 2)
    np.testing.assert_array_equal(got.numpy(), want)
    _, ids = survivors(code)
    stripes = {}
    assert chain.pipelined_decode(code, ids, want[ids], chunks, mesh=mesh_of(len(ids)),
                                  superchunk_words=granule * 2,
                                  sink=lambda s, w: stripes.update({s: w.copy()})) is None
    np.testing.assert_array_equal(np.concatenate([stripes[s] for s in sorted(stripes)], -1),
                                  data)


@pytest.mark.parametrize("n,k,l", [(8, 4, 8), (16, 11, 16)])
def test_placed_classical_distributed_encode_matches_oracle(n, k, l, monkeypatch):
    """The classical baseline on a mesh: the data rows, then each parity
    node's row from the parities computed on its device, as the JAX
    package's ``encode_np``; one ``gf_encode`` launch a device holding
    parity nodes."""
    from repro_torch.core import classical
    from repro_torch.storage import atomic
    code = classical.make_code(n, k, l=l)
    data = words(np.random.default_rng(1), (k, 64), l)
    calls = launches(monkeypatch)
    real = ops.encode_packed
    monkeypatch.setattr(ops, "encode_packed",
                        lambda *a, **kw: calls.update(["encode_packed"]) or real(*a, **kw))
    got = atomic.classical_distributed_encode(code, data, mesh=mesh_of(n))
    assert calls == {"encode_packed": 1}
    from repro.core import classical as jclassical
    want = np.concatenate([data, jclassical.encode_np(jclassical.make_code(n, k, l=l), data)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, atomic.classical_distributed_encode(code, data, device="cpu"))


def test_programs_key_on_the_mesh():
    """The mesh joins the program key: a placed and an unplaced call, or
    two orders, build separate programs; a repeated placed call builds none."""
    from repro_torch.core import jitcache
    jitcache.clear()
    code = rr.RapidRAIDCode.make(6, 4, l=16, seed=13)
    data = words(np.random.default_rng(4), (4, 48), 16)
    chain.pipelined_encode(code, data, 3, device="cpu")
    chain.pipelined_encode(code, data, 3, mesh=mesh_of(6))
    chain.pipelined_encode(code, data, 3, mesh=mesh_of(6))
    chain.pipelined_encode(code, data, 3, mesh=mesh_of(6, list(range(6))[::-1]))
    assert len(jitcache.entry_counts("encode")) == 3
    assert chain.encode_program(code, 48, 3, mesh=mesh_of(6)) is \
        chain.encode_program(code, 48, 3, mesh=mesh_of(6))
    jitcache.clear()


# ---------------------------------------------------------------------------
# staggered batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ORDERS)
@pytest.mark.parametrize("n,k,l,chunks,b_obj,stagger", MANY_CASES)
def test_placed_encode_many_matches_oracle(n, k, l, chunks, b_obj, stagger, kind, monkeypatch):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=13), jrr.RapidRAIDCode.make(n, k, l=l,
                                                                                    seed=13)
    objs = words(np.random.default_rng(0), (b_obj, k, chunks * gf.LANES[l] * 8), l)
    unplaced = multi.pipelined_encode_many(code, objs, chunks, stagger, device="cpu")
    calls = launches(monkeypatch)
    got = multi.pipelined_encode_many(code, objs, chunks, stagger,
                                      mesh=mesh_of(n, order_of(kind, n, k)))
    ticks = pipeline.num_ticks_many(chunks, n, b_obj, stagger)
    assert calls["ticks"] == ticks and calls["placed"] == 1
    assert calls["chain_tick"] == sum(pipeline.active_nodes_many(t, n, chunks, b_obj, stagger)[1]
                                      for t in range(ticks))
    for b in range(b_obj):
        np.testing.assert_array_equal(got[b].numpy(), jcode.encode_np(objs[b]))
    assert torch.equal(got, unplaced)


@pytest.mark.parametrize("n,k,l,chunks,b_obj,stagger", MANY_CASES)
def test_placed_decode_and_repair_many_match_oracle(n, k, l, chunks, b_obj, stagger):
    code, jcode = rr.RapidRAIDCode.make(n, k, l=l, seed=13), jrr.RapidRAIDCode.make(n, k, l=l,
                                                                                    seed=13)
    objs = words(np.random.default_rng(5), (b_obj, k, chunks * gf.LANES[l] * 8), l)
    cws = np.stack([code.encode_np(o) for o in objs])
    lost, ids = survivors(code)
    got = multi.pipelined_decode_many(code, ids, cws[:, ids], chunks, stagger,
                                      mesh=mesh_of(len(ids), list(range(len(ids)))[::-1]))
    np.testing.assert_array_equal(got.numpy(), objs)
    h = len(fault_tolerance.repair_plan(code, lost, ids)[0])
    got = repair.pipelined_repair_many(code, ids, cws[:, ids], lost, chunks, stagger,
                                       mesh=mesh_of(h))
    for b in range(b_obj):
        np.testing.assert_array_equal(got[b].numpy(),
                                      jrepair.repair_np(jcode, lost, ids, cws[b, ids]))
    assert torch.equal(got, repair.pipelined_repair_many(code, ids, cws[:, ids], lost, chunks,
                                                         stagger, device="cpu"))


# ---------------------------------------------------------------------------
# positions on other devices than the call's
# ---------------------------------------------------------------------------


PATHS = ["encode", "decode", "repair", "encode_many", "decode_many", "repair_many",
         "encode_streamed"]


def run_path(name, code, data, objs, lost, ids, chunks, mesh_of_n):
    """One entry point on its placed chain (``mesh_of_n(n)`` a mesh of n
    positions) and the same call with no mesh."""
    cw = code.encode_np(data)
    cws = np.stack([code.encode_np(o) for o in objs])
    h = len(fault_tolerance.repair_plan(code, lost, ids)[0])
    calls = {
        "encode": lambda **kw: chain.pipelined_encode(code, data, chunks, **kw),
        "decode": lambda **kw: chain.pipelined_decode(code, ids, cw[ids], chunks, **kw),
        "repair": lambda **kw: repair.pipelined_repair(code, ids, cw[ids], lost, chunks, **kw),
        "encode_many": lambda **kw: multi.pipelined_encode_many(code, objs, chunks, 2, **kw),
        "decode_many": lambda **kw: multi.pipelined_decode_many(code, ids, cws[:, ids],
                                                                chunks, 2, **kw),
        "repair_many": lambda **kw: repair.pipelined_repair_many(code, ids, cws[:, ids], lost,
                                                                 chunks, 2, **kw),
        "encode_streamed": lambda **kw: chain.pipelined_encode(
            code, data, chunks, superchunk_words=data.shape[1] // 4, **kw),
    }
    n = {"decode": len(ids), "decode_many": len(ids), "repair": h, "repair_many": h}.get(
        name, code.n)
    return calls[name](mesh=mesh_of_n(n)), calls[name](device="cpu")


@pytest.mark.parametrize("name", PATHS)
def test_positions_on_other_devices_hold_their_own_operands(name, monkeypatch):
    """With every position taken for one on another device than the call's
    (``chain.positions`` given a home none of them is on), each gathers its
    replica blocks or shard onto its device and writes its own output,
    copied back: the same words as the unplaced call."""
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=13)
    rng = np.random.default_rng(7)
    data = words(rng, (4, 4 * gf.LANES[16] * 16), 16)
    objs = words(rng, (3, 4, 4 * gf.LANES[16] * 8), 16)
    lost, ids = survivors(code)
    real, seen = chain.positions, []

    def foreign(placement, home, table, tables):
        out = real(placement, torch.device("meta"), table, tables)
        seen.extend(q.take for q in out)
        return out
    monkeypatch.setattr(chain, "positions", foreign)
    got, want = run_path(name, code, data, objs, lost, ids, 4, mesh_of)
    assert torch.equal(got, want) and seen and all(t is not None for t in seen)


# ---------------------------------------------------------------------------
# repair_tick's last_forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l,rows,n", [(8, 5, 3), (16, 11, 4), (16, 3, 1)])
def test_last_forwards_plain_version_matches_repair_step(l, rows, n):
    """With ``last_forwards`` the last node's sums go to ``wire_out[n]`` (the
    JAX ``repair_step`` sums) and ``out`` is untouched; every other row is
    the tick without the flag."""
    rng = np.random.default_rng(l + rows)
    C, S = 3, 8
    coeffs = rng.integers(0, 1 << l, size=(n, rows))
    tables = torch.from_numpy(kernel.repair_tables(gf.bitplane_table(coeffs, l), l)
                              .view(np.int32).copy())
    shards = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, 1, C * S), dtype=np.int32))
    wire_in = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, 1, rows, S), dtype=np.int32))
    rows_table = np.arange(n, dtype=np.int32)
    t = n - 1 + 1                                     # every node has chunk t - i
    out = torch.zeros((1, rows, C * S), dtype=torch.int32)
    fwd = torch.zeros((n + 1, 1, rows, S), dtype=torch.int32)
    ref.repair_tick_ref(wire_in, fwd, shards, rows_table, None, tables, l, t, C, 0, n,
                        last_forwards=True)
    plain = torch.zeros((n, 1, rows, S), dtype=torch.int32)
    ref.repair_tick_ref(wire_in, plain, shards, rows_table, out, tables, l, t, C, 0, n)
    assert torch.equal(fwd[1:n], plain[1:n])
    ch = t - (n - 1)
    last = jref.repair_step_ref(jnp.asarray(wire_in[n - 1, 0].numpy().view(np.uint32)),
                                jnp.asarray(shards[n - 1, 0, ch * S:(ch + 1) * S].numpy()
                                            .view(np.uint32)), coeffs[n - 1], l)
    np.testing.assert_array_equal(fwd[n, 0].numpy().view(np.uint32), np.asarray(last))
    assert torch.equal(out[0, :, ch * S:(ch + 1) * S], fwd[n, 0])


def test_last_forwards_shapes_are_checked():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    tables = torch.from_numpy(kernel.repair_tables(gf.bitplane_table(np.ones((1, 2)), 8), 8)
                              .view(np.int32).copy())
    with pytest.raises(ValueError, match="out is needed"):
        kernel.repair_tick(z(1, 1, 2, 4), z(2, 1, 2, 4), z(1, 1, 8), np.zeros(1, np.int32),
                           None, tables, 8, 0, 2, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):   # shapes pass: only the device is refused
        kernel.repair_tick(z(1, 1, 2, 4), z(2, 1, 2, 4), z(1, 1, 8), np.zeros(1, np.int32),
                           None, tables, 8, 0, 2, 0, 1, last_forwards=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,l,chunks", CHAIN_CASES)
def test_placed_paths_on_the_card(cuda, n, k, l, chunks):
    """Every placed entry point on ``[cuda:0] * n``: one kernel launch a
    position, bit for bit the CPU's placed and unplaced results."""
    code = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    rng = np.random.default_rng(6)
    data = words(rng, (k, chunks * gf.LANES[l] * 64), l)
    want = code.encode_np(data)
    kernel.reset_launch_counts()
    got = chain.pipelined_encode(code, data, chunks, mesh=mesh_of(n, order_of("order_chain", n, k),
                                                                  cuda))
    assert kernel.launch_counts()["chain_tick"] == n * chunks
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    lost, ids = survivors(code)
    kernel.reset_launch_counts()
    got = chain.pipelined_decode(code, ids, want[ids], chunks, mesh=mesh_of(len(ids), None, cuda))
    assert kernel.launch_counts()["repair_tick"] == len(ids) * chunks
    np.testing.assert_array_equal(got.cpu().numpy(), data)
    h = len(fault_tolerance.repair_plan(code, lost, ids)[0])
    got = repair.pipelined_repair(code, ids, want[ids], lost, chunks, mesh=mesh_of(h, None, cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want[lost])
    objs = words(rng, (3, k, chunks * gf.LANES[l] * 16), l)
    got = multi.pipelined_encode_many(code, objs, chunks, 2, mesh=mesh_of(n, None, cuda))
    for b in range(3):
        np.testing.assert_array_equal(got[b].cpu().numpy(), code.encode_np(objs[b]))
    cws = np.stack([code.encode_np(o) for o in objs])
    got = multi.pipelined_decode_many(code, ids, cws[:, ids], chunks, 2,
                                      mesh=mesh_of(len(ids), None, cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), objs)
    got = repair.pipelined_repair_many(code, ids, cws[:, ids], lost, chunks, 2,
                                       mesh=mesh_of(h, None, cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), cws[:, lost])
    got = chain.pipelined_encode(code, data, chunks, mesh=mesh_of(n, None, cuda),
                                 superchunk_words=chunks * gf.LANES[l] * 16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", PATHS)
def test_placed_paths_across_cards(name):
    """On a host with several cards, position p on card p % count: wires
    cross by peer copies, blocks and shards are copied to their positions'
    cards, and every entry point gives the unplaced result."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA cards")
    code = rr.RapidRAIDCode.make(16, 11, l=16, seed=13)
    rng = np.random.default_rng(8)
    data = words(rng, (11, 8 * gf.LANES[16] * 1024), 16)
    objs = words(rng, (3, 11, 8 * gf.LANES[16] * 256), 16)
    lost, ids = survivors(code)
    kernel.reset_launch_counts()
    got, want = run_path(name, code, data, objs, lost, ids, 8, lambda n: chain.make_chain_mesh(
        n, devices=[torch.device("cuda", p % count) for p in range(n)]))
    assert sum(kernel.launch_counts().values()) > 0
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("across", [False, True], ids=["one_card", "across_cards"])
def test_placed_classical_on_the_cards(across):
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < (2 if across else 1):
        pytest.skip("needs two or more CUDA cards" if across else "needs a CUDA card")
    from repro_torch.core import classical
    from repro_torch.storage import atomic
    code = classical.make_code(16, 11, l=16)
    data = words(np.random.default_rng(9), (11, 1 << 14), 16)
    mesh = chain.make_chain_mesh(16, devices=[torch.device("cuda", i % count if across else 0)
                                              for i in range(16)])
    got = atomic.classical_distributed_encode(code, data, mesh=mesh)
    assert torch.equal(got.cpu(), atomic.classical_distributed_encode(code, data, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("stagger", [0, 1, 2])
@pytest.mark.parametrize("l,rows", [(8, 5), (16, 11), (16, 30)])
def test_repair_tick_last_forwards_on_the_card(cuda, l, rows, stagger):
    """The kernel with ``last_forwards``, lockstep and staggered, writes what
    its plain version writes and leaves ``out`` alone."""
    rng = np.random.default_rng(rows)
    n, C, S, n_obj = 3, 4, 64, 3
    W = n_obj if stagger == 0 else pipeline.window_size(C, n_obj, stagger)
    coeffs = rng.integers(0, 1 << l, size=(n, rows))
    tables = torch.from_numpy(kernel.repair_tables(gf.bitplane_table(coeffs, l), l)
                              .view(np.int32).copy())
    shards = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, n_obj, C * S),
                                           dtype=np.int32))
    wire_in = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, W, rows, S),
                                            dtype=np.int32))
    rows_table = np.arange(n, dtype=np.int32)
    t = n
    outs = {}
    for fn, dev in ((kernel.repair_tick, cuda), (ref.repair_tick_ref, torch.device("cpu"))):
        wo = torch.zeros((n + 1, W, rows, S), dtype=torch.int32, device=dev)
        fn(wire_in.to(dev), wo, shards.to(dev), rows_table, None, tables.to(dev), l, t, C, 0, n,
           False, stagger, True)
        outs[fn] = wo.cpu()
    assert torch.equal(outs[kernel.repair_tick], outs[ref.repair_tick_ref])
