"""Store, archive and lifecycle of the PyTorch/CUDA port against the JAX package.

``repro_torch.storage.object_store`` and ``storage.archive`` keep the JAX
package's on-disk format, so on the CPU (``device="cpu"``, the kernels'
plain versions) every archive entry point run on the same inputs through
both packages must leave store trees that are byte-identical file by file:
``hot_save``, ``archive_step`` (monolithic and streamed, the chain and the
host route), ``archive_many`` (the chain and the ``gf_encode`` route of the
LRC and MBR families), ``archive_classical``, ``repair`` and
``repair_many``, ``publish_device_archive`` and
``publish_streaming_archive``. An archive written by either package is
restored, repaired and range-read by the other. The in-process cases of the
JAX package's ``tests/test_streaming.py`` run here against the port. Tests
marked ``gpu`` run the archive on the card and skip without one.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.storage import archive as arc  # noqa: E402
from repro_torch.storage import object_store as obj  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    from repro.storage import archive as jarc
    from repro.storage import object_store as jobj
except ImportError:
    jarc = None

GEOMS = [(8, 4, 8), (6, 4, 16), (8, 4, 16)]


@pytest.fixture(autouse=True)
def _reference(request):
    if jarc is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def configs(n, k, l, family="rapidraid", seed=5, num_chunks=4):
    return (arc.ArchiveConfig(n=n, k=k, l=l, seed=seed, num_chunks=num_chunks, family=family),
            jarc.ArchiveConfig(n=n, k=k, l=l, seed=seed, num_chunks=num_chunks, family=family))


def blocks_for(k, nbytes, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(k, nbytes), dtype=np.uint8)


def tree(root) -> dict[str, bytes]:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_same_tree(a_root, b_root):
    a, b = tree(a_root), tree(b_root)
    assert sorted(a) == sorted(b)
    assert [f for f in a if a[f] != b[f]] == []
    return a


class Pair:
    """The same cluster twice: one driven by the port, one by the JAX package."""

    def __init__(self, tmp_path, acfg, jacfg):
        self.acfg, self.jacfg = acfg, jacfg
        self.root, self.jroot = str(tmp_path / "port"), str(tmp_path / "jax")
        self.store = obj.NodeStore(self.root, acfg.n)
        self.jstore = jobj.NodeStore(self.jroot, acfg.n)

    def hot_save(self, step, blocks):
        assert arc.hot_save(self.store, step, blocks, self.acfg) == \
            jarc.hot_save(self.jstore, step, blocks, self.jacfg)

    def fail(self, *nodes):
        for i in nodes:
            self.store.fail_node(i)
            self.jstore.fail_node(i)

    def same(self):
        return assert_same_tree(self.root, self.jroot)


# ---------------------------------------------------------------------------
# object store: the block codec and the store's framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 11])
def test_block_codec_equals_reference(k):
    rng = np.random.default_rng(k)
    for blob_len in (0, 1, 7, 8, 100, 1001):
        blob = rng.integers(0, 256, blob_len, dtype=np.uint8).tobytes()
        for lane in (4, 8):
            assert obj.block_bytes_for(blob_len, k, lane) == jobj.block_bytes_for(blob_len, k, lane)
            got, want = obj.split_blocks(blob, k, lane), jobj.split_blocks(blob, k, lane)
            np.testing.assert_array_equal(got, want)
            assert obj.join_blocks(got, blob_len) == blob
    assert obj.digest(b"abc") == jobj.digest(b"abc")


def test_leaf_metas_equal_reference():
    leaves = [np.zeros((3, 4), np.float32), np.int64(7), np.arange(5, dtype=np.uint16),
              np.zeros((2, 0), np.float64), True, np.zeros((), np.int8)]
    assert obj.leaf_metas(leaves) == jobj.leaf_metas(leaves)
    tensors = [torch.zeros((3, 4)), torch.zeros(5, dtype=torch.bfloat16),
               torch.zeros(2, dtype=torch.bool), torch.zeros(1, dtype=torch.int64)]
    metas = obj.leaf_metas(tensors)
    assert [m["dtype"] for m in metas] == ["float32", "bfloat16", "bool", "int64"]
    assert [m["offset"] for m in metas] == [0, 48, 58, 60]
    assert metas[:1] == jobj.leaf_metas([np.zeros((3, 4), np.float32)])
    with pytest.raises(TypeError, match="dtype object"):
        obj.leaf_metas([np.array([object()])])


def test_stream_writer_atomic_publish_and_digest(tmp_path):
    store = obj.NodeStore(str(tmp_path), 2)
    frames = [b"alpha", b"beta", b"gamma-" * 100]
    w = store.put_stream(0, "archive/obj.bin")
    for f in frames:
        w.write(f)
        assert not store.has(0, "archive/obj.bin")   # nothing until close
    w.close()
    whole = b"".join(frames)
    assert store.get(0, "archive/obj.bin") == whole
    assert w.digest() == obj.digest(whole) == jobj.digest(whole)
    assert w.nbytes == len(whole)


def test_stream_writer_abort_leaves_nothing(tmp_path):
    store = obj.NodeStore(str(tmp_path), 1)
    w = store.put_stream(0, "archive/x.bin")
    w.write(b"partial")
    w.abort()
    assert not store.has(0, "archive/x.bin")
    assert not os.path.exists(store.path(0, "archive/x.bin") + ".tmp")
    with pytest.raises(RuntimeError):
        with store.put_stream(0, "archive/y.bin") as w2:
            w2.write(b"doomed")
            raise RuntimeError("boom")
    assert not store.has(0, "archive/y.bin")
    with store.put_stream(0, "archive/z.bin") as w3:
        w3.write(b"kept")
    assert store.get(0, "archive/z.bin") == b"kept"


def test_stream_get_frames_and_ranges(tmp_path):
    store = obj.NodeStore(str(tmp_path), 1)
    payload = bytes(range(256)) * 5
    store.put(0, "a/b.bin", payload)
    frames = list(store.get_stream(0, "a/b.bin", 300))
    assert b"".join(frames) == payload
    assert all(len(f) == 300 for f in frames[:-1])
    assert store.get_range(0, "a/b.bin", 250, 20) == payload[250:270]
    assert store.size(0, "a/b.bin") == len(payload)
    with pytest.raises(ValueError, match="frame_bytes"):
        list(store.get_stream(0, "a/b.bin", 0))


def test_churn_store_drops_writes_to_down_nodes(tmp_path):
    store = obj.ChurnNodeStore(str(tmp_path), 2)
    store.fail(1)
    assert not store.is_up(1)
    store.put(1, "hot/x.bin", b"lost")
    w = store.put_stream(1, "archive/lost.bin")
    w.write(b"into the void")
    w.close()
    assert not obj.NodeStore.has(store, 1, "archive/lost.bin")
    assert not obj.NodeStore.has(store, 1, "hot/x.bin")
    assert w.digest() == obj.digest(b"into the void")  # what WOULD have been written
    for read in (lambda: list(store.get_stream(1, "archive/lost.bin", 4)),
                 lambda: store.get(1, "hot/x.bin"), lambda: store.size(1, "hot/x.bin"),
                 lambda: store.get_range(1, "hot/x.bin", 0, 1)):
        with pytest.raises(FileNotFoundError):
            read()
    store.rejoin(1)
    w2 = store.put_stream(1, "archive/ok.bin")
    w2.write(b"landed")
    w2.close()
    assert store.get(1, "archive/ok.bin") == b"landed" and store.has(1, "archive/ok.bin")


# ---------------------------------------------------------------------------
# byte-identical store trees, entry point by entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,l", GEOMS)
def test_hot_save_and_load_trees_identical(tmp_path, n, k, l):
    p = Pair(tmp_path, *configs(n, k, l))
    blocks = blocks_for(k, 8 * 13)
    p.hot_save(1, blocks)
    p.same()
    np.testing.assert_array_equal(arc.hot_load(p.store, 1, arc.get_manifest(p.store, 1)),
                                  blocks)
    assert arc.list_steps(p.store) == jarc.list_steps(p.jstore) == [1]


@pytest.mark.parametrize("n,k,l", GEOMS)
@pytest.mark.parametrize("superchunk_bytes", [None, 16, 64, 96, 10 ** 6])
def test_archive_step_trees_identical(tmp_path, n, k, l, superchunk_bytes):
    """The chain on the CPU against the JAX package's host route, monolithic
    and streamed (a padded tail at 96 bytes), and the one-stripe plan,
    which writes no ``streaming`` record."""
    p = Pair(tmp_path, *configs(n, k, l))
    p.hot_save(1, blocks_for(k, 8 * 41))
    m = arc.archive_step(p.store, 1, p.acfg, device="cpu", superchunk_bytes=superchunk_bytes)
    jm = jarc.archive_step(p.jstore, 1, p.jacfg, use_devices=False,
                           superchunk_bytes=superchunk_bytes)
    assert m == jm
    assert ("streaming" in m) == (superchunk_bytes is not None and superchunk_bytes < 8 * 41)
    p.same()


@pytest.mark.parametrize("use_devices", [False, True])
@pytest.mark.parametrize("superchunk_bytes", [None, 64])
def test_archive_step_routes_and_options_identical(tmp_path, use_devices, superchunk_bytes):
    """Both routes of the port (the host oracle and the chain), with
    ``node_speeds`` and ``reclaim_hot=False``, against the JAX package."""
    p = Pair(tmp_path, *configs(8, 4, 16))
    p.hot_save(1, blocks_for(4, 8 * 20, seed=1))
    speeds = np.array([3.0, 1.0, 2.0, 5.0, 4.0, 0.5, 6.0, 7.0])
    m = arc.archive_step(p.store, 1, p.acfg, node_speeds=speeds, use_devices=use_devices,
                         reclaim_hot=False, superchunk_bytes=superchunk_bytes, device="cpu")
    assert m == jarc.archive_step(p.jstore, 1, p.jacfg, node_speeds=speeds,
                                  use_devices=False, reclaim_hot=False,
                                  superchunk_bytes=superchunk_bytes)
    assert m["hot_retained"] and m["perm"] != list(range(8))
    p.same()
    assert arc.reclaim_replicas(p.store, 1) == jarc.reclaim_replicas(p.jstore, 1)
    p.same()


@pytest.mark.parametrize("n,k,l", GEOMS)
@pytest.mark.parametrize("stagger", [1, 2])
def test_archive_many_trees_identical(tmp_path, n, k, l, stagger):
    """Three steps of one block length and one of another: the staggered
    chain on the CPU against the JAX package's fused route."""
    p = Pair(tmp_path, *configs(n, k, l))
    for s, nbytes in ((1, 8 * 12), (2, 8 * 12), (3, 8 * 20), (4, 8 * 12)):
        p.hot_save(s, blocks_for(k, nbytes, seed=s))
    got = arc.archive_many(p.store, [4, 1, 3, 2], p.acfg, stagger=stagger, device="cpu")
    assert got == jarc.archive_many(p.jstore, [4, 1, 3, 2], p.jacfg, stagger=stagger)
    assert got[0]["batched_with"] == [4, 1, 2]
    p.same()


@pytest.mark.parametrize("family,n,k,l", [("lrc", 8, 4, 16), ("mbr", 6, 4, 8)])
@pytest.mark.parametrize("use_devices", [None, False])
def test_archive_many_static_route_identical(tmp_path, family, n, k, l, use_devices):
    """Families without a chain archive through one batched ``gf_encode``
    launch (the JAX package's through its fused kernel)."""
    p = Pair(tmp_path, *configs(n, k, l, family=family))
    for s in (1, 2):
        p.hot_save(s, blocks_for(k, 8 * 12, seed=s))
    got = arc.archive_many(p.store, [1, 2], p.acfg, use_devices=use_devices, device="cpu")
    assert got == jarc.archive_many(p.jstore, [1, 2], p.jacfg)
    p.same()
    np.testing.assert_array_equal(arc.restore_blocks(p.store, 2, p.acfg),
                                  blocks_for(k, 8 * 12, seed=2))


def test_archive_classical_trees_identical(tmp_path):
    p = Pair(tmp_path, *configs(8, 4, 8))
    p.hot_save(1, blocks_for(4, 8 * 9))
    assert arc.archive_classical(p.store, 1, p.acfg) == \
        jarc.archive_classical(p.jstore, 1, p.jacfg)
    p.same()
    p.fail(0, 5)
    res = arc.restore_blocks_ex(p.store, 1, p.acfg)
    assert res.served_from == "degraded"
    np.testing.assert_array_equal(res.data, jarc.restore_blocks(p.jstore, 1, p.jacfg))
    assert arc.read_range(p.store, 1, p.acfg, 3, 50) == \
        jarc.read_range(p.jstore, 1, p.jacfg, 3, 50)


@pytest.mark.parametrize("n,k,l", GEOMS)
@pytest.mark.parametrize("use_devices", [None, False])
@pytest.mark.parametrize("superchunk_bytes", [None, 32])
def test_repair_trees_identical(tmp_path, n, k, l, use_devices, superchunk_bytes):
    """n-k lost nodes, repaired through the reverse chain (streamed or not)
    or one ``gf_encode`` launch, onto replacement nodes for one row."""
    p = Pair(tmp_path, *configs(n, k, l))
    p.hot_save(1, blocks_for(k, 8 * 16, seed=3))
    m = arc.archive_step(p.store, 1, p.acfg, device="cpu", superchunk_bytes=superchunk_bytes)
    assert m == jarc.archive_step(p.jstore, 1, p.jacfg, use_devices=False,
                                  superchunk_bytes=superchunk_bytes)
    lost = [1, n - 2][:n - k]
    p.fail(*lost)
    got = arc.repair(p.store, 1, p.acfg, replacement_nodes={lost[0]: 0},
                     use_devices=use_devices, superchunk_bytes=superchunk_bytes, device="cpu")
    assert got == jarc.repair(p.jstore, 1, p.jacfg, replacement_nodes={lost[0]: 0},
                              use_devices=False, superchunk_bytes=superchunk_bytes) == lost
    p.same()
    np.testing.assert_array_equal(arc.restore_blocks(p.store, 1, p.acfg),
                                  blocks_for(k, 8 * 16, seed=3))


@pytest.mark.parametrize("n,k,l", GEOMS)
@pytest.mark.parametrize("use_devices", [None, False])
def test_repair_many_trees_identical(tmp_path, n, k, l, use_devices):
    """Five steps, one streamed and one batch-archived, share a loss; a
    corrupt helper of one step is demoted to missing and healed too."""
    p = Pair(tmp_path, *configs(n, k, l))
    for s in range(1, 6):
        p.hot_save(s, blocks_for(k, 8 * 12, seed=10 + s))
    for s in (1, 2):
        assert arc.archive_step(p.store, s, p.acfg, device="cpu") == \
            jarc.archive_step(p.jstore, s, p.jacfg, use_devices=False)
    assert arc.archive_step(p.store, 3, p.acfg, device="cpu", superchunk_bytes=32) == \
        jarc.archive_step(p.jstore, 3, p.jacfg, use_devices=False, superchunk_bytes=32)
    assert arc.archive_many(p.store, [4, 5], p.acfg, device="cpu") == \
        jarc.archive_many(p.jstore, [4, 5], p.jacfg)
    p.fail(0)
    m = arc.get_manifest(p.store, 2)
    for store in (p.store, p.jstore):
        path = store.path(m["perm"][3], arc.ARC.format(step=2, i=3))
        raw = bytearray(open(path, "rb").read())
        raw[2] ^= 0x40
        open(path, "wb").write(bytes(raw))
    got = arc.repair_many(p.store, [1, 2, 3, 4, 5], p.acfg, use_devices=use_devices,
                          stagger=2, device="cpu")
    assert got == jarc.repair_many(p.jstore, [1, 2, 3, 4, 5], p.jacfg, use_devices=False,
                                   stagger=2)
    assert got[1] == [0, 3] and got[0] == [0]
    p.same()


@pytest.mark.parametrize("superchunk_bytes", [16, 64, 10 ** 6])
def test_publish_archives_identical(tmp_path, superchunk_bytes):
    p = Pair(tmp_path, *configs(8, 4, 16))
    blocks = blocks_for(4, 8 * 10, seed=4)
    code = p.acfg.code()
    coded = code.encode_np(blocks.view(np.uint16)).view(np.uint8)
    assert arc.publish_device_archive(p.store, 1, p.acfg, blocks, coded, 300, "s") == \
        jarc.publish_device_archive(p.jstore, 1, p.jacfg, blocks, coded, 300, "s")
    assert arc.publish_streaming_archive(p.store, 2, p.acfg, blocks, 310, superchunk_bytes,
                                         "t", device="cpu") == \
        jarc.publish_streaming_archive(p.jstore, 2, p.jacfg, blocks, 310, superchunk_bytes,
                                       "t", use_devices=False)
    p.same()
    np.testing.assert_array_equal(arc.restore_blocks(p.store, 2, p.acfg), blocks)


# ---------------------------------------------------------------------------
# each package reads, repairs and range-reads the other's archives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("superchunk_bytes", [None, 48])
def test_archives_cross_the_packages(tmp_path, writer, superchunk_bytes):
    acfg, jacfg = configs(8, 4, 16)
    blocks = blocks_for(4, 8 * 30, seed=6)
    store = obj.NodeStore(str(tmp_path / "s"), 8)
    if writer == "jax":
        jarc.hot_save(store, 1, blocks, jacfg)
        jarc.archive_step(store, 1, jacfg, use_devices=False, superchunk_bytes=superchunk_bytes)
        reader, rcfg, kw = arc, acfg, {"device": "cpu"}
    else:
        arc.hot_save(store, 1, blocks, acfg)
        arc.archive_step(store, 1, acfg, device="cpu", superchunk_bytes=superchunk_bytes)
        reader, rcfg, kw = jarc, jacfg, {}
    blob = blocks.reshape(-1).tobytes()
    res = reader.restore_blocks_ex(store, 1, rcfg, **kw)
    assert res.served_from == "coded"
    np.testing.assert_array_equal(res.data, blocks)
    m = reader.get_manifest(store, 1)
    for pos in (0, 3, 5, 7):
        store.fail_node(m["perm"][pos])
    assert reader.read_range(store, 1, rcfg, 230, 300, **kw) == blob[230:530]
    res = reader.restore_blocks_ex(store, 1, rcfg, **kw)
    assert res.served_from == "degraded"
    np.testing.assert_array_equal(res.data, blocks)
    assert sorted(reader.repair(store, 1, rcfg, **kw)) == [0, 3, 5, 7]
    other = jarc if reader is arc else arc
    ocfg, okw = (jacfg, {}) if other is jarc else (acfg, {"device": "cpu"})
    res = other.restore_blocks_ex(store, 1, ocfg, **okw)
    assert res.served_from == "coded"
    np.testing.assert_array_equal(res.data, blocks)


# ---------------------------------------------------------------------------
# the JAX package's in-process streaming and lifecycle cases, on the port
# ---------------------------------------------------------------------------

N, K, L = 8, 4, 8
ACFG = arc.ArchiveConfig(n=N, k=K, l=L, seed=5, num_chunks=4)


def _store_with(tmp, blocks, acfg=ACFG, step=1):
    store = obj.NodeStore(str(tmp), acfg.n)
    arc.hot_save(store, step, blocks, acfg)
    return store


def test_streaming_rejects_subpacketized_families(tmp_path):
    acfg = arc.ArchiveConfig(n=5, k=3, l=8, seed=2, family="mbr")
    store = _store_with(tmp_path, blocks_for(3, 24 * 8, seed=3), acfg=acfg)
    with pytest.raises(ValueError, match="sub-packetized"):
        arc.archive_step(store, 1, acfg, device="cpu", superchunk_bytes=16)


def test_streamed_archive_aborts_on_corrupt_hot_block(tmp_path):
    store = _store_with(tmp_path, blocks_for(K, 8 * 32, seed=4))
    manifest = arc.get_manifest(store, 1)
    rel = arc.HOT.format(step=1, j=2)
    for node, held in enumerate(manifest["placement"]):
        if 2 in held:
            raw = bytearray(store.get(node, rel))
            raw[17] ^= 0xFF
            store.put(node, rel, bytes(raw))
    with pytest.raises(ValueError, match="hot block 2"):
        arc.archive_step(store, 1, ACFG, device="cpu", superchunk_bytes=64)
    for pos in range(N):
        assert not store.has(pos, arc.ARC.format(step=1, i=pos))
        assert not os.path.exists(store.path(pos, arc.ARC.format(step=1, i=pos)) + ".tmp")
    assert arc.get_manifest(store, 1)["tier"] == "hot"


def test_streamed_restore_routes_around_corruption(tmp_path):
    blocks = blocks_for(K, 8 * 32, seed=5)
    store = _store_with(tmp_path, blocks)
    m = arc.archive_step(store, 1, ACFG, device="cpu", superchunk_bytes=64)
    p = store.path(m["perm"][0], arc.ARC.format(step=1, i=0))
    raw = bytearray(open(p, "rb").read())
    raw[5] ^= 0x01
    open(p, "wb").write(bytes(raw))
    res = arc.restore_blocks_ex(store, 1, ACFG)
    assert res.served_from == "degraded" and m["perm"][0] not in res.nodes
    np.testing.assert_array_equal(res.data, blocks)


def test_restore_heal_and_hot_retained_fallback(tmp_path):
    blocks = blocks_for(K, 8 * 16, seed=8)
    store = _store_with(tmp_path, blocks)
    arc.archive_step(store, 1, ACFG, device="cpu", reclaim_hot=False)
    for node in range(N - K + 1):              # too many coded blocks lost
        store.delete(node, arc.ARC.format(step=1, i=node))
    res = arc.restore_blocks_ex(store, 1, ACFG, heal=True, device="cpu")
    assert res.served_from == "hot"
    np.testing.assert_array_equal(res.data, blocks)
    assert arc.reclaim_replicas(store, 1) is None          # unverified: keep replicas
    store2 = _store_with(tmp_path / "b", blocks)
    arc.archive_step(store2, 1, ACFG, device="cpu")
    store2.fail_node(2)
    res = arc.restore_blocks_ex(store2, 1, ACFG, heal=True, device="cpu")
    assert res.healed and res.served_from == "coded"


@pytest.mark.parametrize("streaming_sc", [None, 128])
def test_read_range_rejects_bad_ranges(tmp_path, streaming_sc):
    blocks = blocks_for(K, 8 * 64, seed=7)
    store = _store_with(tmp_path, blocks)
    arc.archive_step(store, 1, ACFG, device="cpu", superchunk_bytes=streaming_sc)
    size = K * blocks.shape[1]
    for off, nb, what in [(-1, 4, "out of bounds"), (size, 1, "out of bounds"),
                          (size - 1, 2, "out of bounds"), (10, -5, "inverted")]:
        with pytest.raises(ValueError, match=what) as ei:
            arc.read_range(store, 1, ACFG, off, nb)
        assert str(size) in str(ei.value)
    assert arc.read_range(store, 1, ACFG, 5, 0) == b""
    assert arc.read_range(store, 1, ACFG, size - 4, 4) == blocks.reshape(-1)[-4:].tobytes()


@pytest.mark.parametrize("streaming_sc", [None, 128])
def test_read_range_degraded_on_streamed_archive(tmp_path, streaming_sc):
    blocks = blocks_for(K, 8 * 64, seed=7)
    store = _store_with(tmp_path, blocks)
    arc.archive_step(store, 1, ACFG, device="cpu", superchunk_bytes=streaming_sc)
    blob = blocks.reshape(-1).tobytes()
    m = arc.get_manifest(store, 1)
    for pos in (0, 3, 5, 7):
        store.fail_node(m["perm"][pos])
    B = blocks.shape[1]
    for off, nb in [(0, 16), (B - 3, 7), (2 * B + 5, 300), (4 * B - 9, 9)]:
        res = arc.read_range_ex(store, 1, ACFG, off, nb)
        assert res.data == blob[off:off + nb] and res.served_from == "degraded"


def test_manifest_replicas_and_validation(tmp_path):
    store = _store_with(tmp_path, blocks_for(K, 64))
    rel = arc.MANIFEST.format(step=1)
    store.put(0, rel, b"{not json")
    assert arc.get_manifest(store, 1)["tier"] == "hot"     # next replica
    for i in range(N):
        store.put(i, rel, b'{"tier": "hot"}')
    with pytest.raises(ValueError, match="every manifest replica is corrupt"):
        arc.get_manifest(store, 1)
    with pytest.raises(FileNotFoundError):
        arc.get_manifest(store, 2)
    store.put(3, arc.MANIFEST.format(step=9) + ".tmp", b"{}")
    with pytest.raises(ValueError, match="partially-written"):
        arc.list_steps(store)


def test_topology_is_not_ported_yet(tmp_path):
    """``topology=`` (ported with the scheduler) writes the JAX package's
    trees: ``archive_step`` on a slowed topology with spare nodes, and
    ``archive_many`` on one shared chain and on two disjoint chains; every
    manifest carries the same ``sched`` and ``topology``."""
    from repro.core import topology as jtopo
    from repro_torch.core import topology as topo
    for case, (n_nodes, steps) in enumerate([(N + 2, [1]), (N, [1, 2, 3]), (2 * N, [1, 2, 3])]):
        t, jt = (lib.Topology.uniform(n_nodes).with_slow(1, 4.0).with_slow(5, 2.0)
                 for lib in (topo, jtopo))
        pair = Pair(tmp_path / str(case), ACFG, jarc.ArchiveConfig(n=N, k=K, l=L, seed=5,
                                                                   num_chunks=4))
        for s in steps:
            pair.hot_save(s, blocks_for(K, 256, seed=s))
        if len(steps) == 1:
            got = [arc.archive_step(pair.store, 1, ACFG, topology=t, device="cpu")]
            want = [jarc.archive_step(pair.jstore, 1, pair.jacfg, topology=jt)]
        else:
            got = arc.archive_many(pair.store, steps, ACFG, topology=t, device="cpu")
            want = jarc.archive_many(pair.jstore, steps, pair.jacfg, topology=jt)
        assert got == want and all("sched" in m and "topology" in m["sched"] for m in got)
        pair.same()
    with pytest.raises(ValueError, match="topology has"):
        arc.archive_step(_store_with(tmp_path / "small", blocks_for(K, 64)), 1, ACFG,
                         topology=topo.Topology.uniform(N - 1), device="cpu")


def test_read_result_rejects_unknown_route():
    with pytest.raises(ValueError, match="served_from"):
        arc.ReadResult(data=b"", served_from="cache", nodes=(), healed=False, step=1)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("superchunk_bytes", [None, 8 * 1024])
def test_archive_lifecycle_on_card_matches_host_route(cuda, tmp_path, superchunk_bytes):
    """``archive_step`` and ``repair`` on the card write the host route's
    bytes; the restore from survivors is the object."""
    acfg = arc.ArchiveConfig(n=16, k=11, l=16, seed=0, num_chunks=8)
    blocks = blocks_for(11, 16 * 8 * 2 * 40, seed=2)
    card = _store_with(tmp_path / "card", blocks, acfg=acfg)
    host = _store_with(tmp_path / "host", blocks, acfg=acfg)
    m = arc.archive_step(card, 1, acfg, superchunk_bytes=superchunk_bytes)
    assert m == arc.archive_step(host, 1, acfg, use_devices=False,
                                 superchunk_bytes=superchunk_bytes)
    assert_same_tree(card.root, host.root)
    for i in (5, 6, 7, 8, 14):
        card.fail_node(i)
    assert arc.repair(card, 1, acfg, superchunk_bytes=superchunk_bytes) == [5, 6, 7, 8, 14]
    assert_same_tree(card.root, host.root)
    res = arc.restore_blocks_ex(card, 1, acfg)
    assert res.served_from == "coded"
    np.testing.assert_array_equal(res.data, blocks)


@pytest.mark.gpu
def test_archive_many_and_repair_many_on_card(cuda, tmp_path):
    acfg = arc.ArchiveConfig(n=16, k=11, l=16, seed=0, num_chunks=8)
    """The staggered chains and the ``gf_encode`` route write the same bytes."""
    chained = obj.NodeStore(str(tmp_path / "chain"), 16)
    static = obj.NodeStore(str(tmp_path / "static"), 16)
    for s in range(1, 5):
        for store in (chained, static):
            arc.hot_save(store, s, blocks_for(11, 16 * 8 * 2 * 8, seed=s), acfg)
    assert arc.archive_many(chained, [1, 2, 3, 4], acfg) == \
        arc.archive_many(static, [1, 2, 3, 4], acfg, use_devices=False)
    for store in (chained, static):
        store.fail_node(3)
        store.fail_node(9)
    assert arc.repair_many(chained, [1, 2, 3, 4], acfg) == \
        arc.repair_many(static, [1, 2, 3, 4], acfg, use_devices=False)
    assert_same_tree(chained.root, static.root)
