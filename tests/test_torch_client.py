"""The StorageClient facade of the PyTorch/CUDA port (``repro_torch.storage.client``).

The in-process cases of the JAX package's ``tests/test_client.py`` run here
against the port, on the CPU (``device="cpu"``): every method is bit-exact
with the free function it wraps, drifted kwarg spellings raise naming the
accepted one, and ``ReadResult`` reports how each read was served. Each
facade call is also held against the JAX package's facade on the same
inputs: the same manifests, results and store trees.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.storage import archive as arc  # noqa: E402
from repro_torch.storage import object_store as obj  # noqa: E402
from repro_torch.storage.client import StorageClient  # noqa: E402

try:
    from repro.storage import archive as jarc
    from repro.storage import object_store as jobj
    from repro.storage.client import StorageClient as JStorageClient
except ImportError:
    jarc = None

ACFG = arc.ArchiveConfig(n=8, k=4, l=16, num_chunks=4)


@pytest.fixture(autouse=True)
def _reference():
    if jarc is None:
        pytest.skip("the JAX reference package is not installed")


def _blocks(seed=0, nbytes=512):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(ACFG.k, nbytes), dtype=np.uint8)


def _pair(tmp_path):
    """Two identical empty clusters: one driven by free functions, one by
    the facade."""
    free = obj.NodeStore(str(tmp_path / "free"), ACFG.n)
    store = obj.NodeStore(str(tmp_path / "facade"), ACFG.n)
    return free, StorageClient(store, ACFG, device="cpu")


# ---------------------------------------------------------------------------
# parity: every method is bit-exact with the free function it wraps
# ---------------------------------------------------------------------------


def test_put_hot_and_read_parity(tmp_path):
    free, cli = _pair(tmp_path)
    blocks = _blocks()
    assert arc.hot_save(free, 1, blocks, ACFG) == cli.put_hot(1, blocks)
    res = cli.read(1)
    np.testing.assert_array_equal(res.data, arc.restore_blocks(free, 1, ACFG))
    np.testing.assert_array_equal(res.data, blocks)


@pytest.mark.parametrize("superchunk_bytes", [None, 128])
def test_archive_and_manifest_parity(tmp_path, superchunk_bytes):
    free, cli = _pair(tmp_path)
    blocks = _blocks(1)
    arc.hot_save(free, 1, blocks, ACFG)
    cli.put_hot(1, blocks)
    m_free = arc.archive_step(free, 1, ACFG, device="cpu", superchunk_bytes=superchunk_bytes)
    assert m_free == cli.archive(1, superchunk_bytes=superchunk_bytes)
    assert cli.manifest(1) == arc.get_manifest(free, 1)
    np.testing.assert_array_equal(cli.read(1).data, arc.restore_blocks(free, 1, ACFG))


def test_archive_many_and_steps_parity(tmp_path):
    free, cli = _pair(tmp_path)
    for s in (1, 2, 3):
        blocks = _blocks(s)
        arc.hot_save(free, s, blocks, ACFG)
        cli.put_hot(s, blocks)
    assert cli.archive_many([1, 2, 3]) == arc.archive_many(free, [1, 2, 3], ACFG, device="cpu")
    assert cli.steps() == arc.list_steps(free) == [1, 2, 3]


def test_read_range_parity(tmp_path):
    free, cli = _pair(tmp_path)
    blocks = _blocks(2)
    arc.hot_save(free, 1, blocks, ACFG)
    cli.put_hot(1, blocks)
    arc.archive_step(free, 1, ACFG, device="cpu")
    cli.archive(1)
    for off, n in ((0, 64), (100, 700), (2047, 1)):
        res = cli.read_range(1, off, n)
        assert res.data == arc.read_range(free, 1, ACFG, off, n)
        assert res.data == blocks.reshape(-1)[off:off + n].tobytes()


def test_repair_parity(tmp_path):
    free, cli = _pair(tmp_path)
    blocks = _blocks(3)
    arc.hot_save(free, 1, blocks, ACFG)
    cli.put_hot(1, blocks)
    arc.archive_step(free, 1, ACFG, device="cpu")
    cli.archive(1)
    free.fail_node(0)
    cli.store.fail_node(0)
    assert cli.repair(1) == arc.repair(free, 1, ACFG, device="cpu") == [0]
    np.testing.assert_array_equal(cli.read(1).data, blocks)


def test_repair_many_parity(tmp_path):
    free, cli = _pair(tmp_path)
    for s in (1, 2):
        blocks = _blocks(s + 10)
        arc.hot_save(free, s, blocks, ACFG)
        cli.put_hot(s, blocks)
        arc.archive_step(free, s, ACFG, device="cpu")
        cli.archive(s)
    free.fail_node(1)
    cli.store.fail_node(1)
    assert (cli.repair_many([1, 2])
            == arc.repair_many(free, [1, 2], ACFG, device="cpu") == [[1], [1]])


def test_reclaim_parity(tmp_path):
    free, cli = _pair(tmp_path)
    blocks = _blocks(4)
    arc.hot_save(free, 1, blocks, ACFG)
    cli.put_hot(1, blocks)
    arc.archive_step(free, 1, ACFG, reclaim_hot=False, device="cpu")
    cli.archive(1, reclaim_hot=False)
    assert cli.manifest(1)["hot_retained"]
    m_free = arc.reclaim_replicas(free, 1)
    m_cli = cli.reclaim(1)
    assert m_free == m_cli
    assert not m_cli.get("hot_retained")


# ---------------------------------------------------------------------------
# the kwarg vocabulary: drifted spellings name the accepted one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,kwargs,accepted", [
    ("archive", {"topo": None}, "topology"),
    ("archive", {"order": [0, 1]}, "topology"),
    ("archive_many", {"superchunk_words": 64}, "superchunk_bytes"),
    ("repair", {"sc_bytes": 64}, "superchunk_bytes"),
    ("repair_many", {"replacements": {}}, "replacement_nodes"),
    ("read", {"mesh": True}, "use_devices"),
    ("read_range", {"speeds": [1.0]}, "node_speeds"),
])
def test_drifted_kwargs_name_accepted_spelling(tmp_path, method, kwargs, accepted):
    _, cli = _pair(tmp_path)
    args = {"archive": (1,), "archive_many": ([1],), "repair": (1,),
            "repair_many": ([1],), "read": (1,),
            "read_range": (1, 0, 8)}[method]
    with pytest.raises(ValueError, match=accepted):
        getattr(cli, method)(*args, **kwargs)
    # the JAX package's facade says the same
    jcli = JStorageClient(jobj.NodeStore(str(tmp_path / "j"), ACFG.n),
                          jarc.ArchiveConfig(n=8, k=4, l=16, num_chunks=4))
    with pytest.raises(ValueError, match=accepted):
        getattr(jcli, method)(*args, **kwargs)


def test_unknown_kwarg_rejected_everywhere(tmp_path):
    _, cli = _pair(tmp_path)
    for call in (lambda: cli.put_hot(1, _blocks(), frobnicate=True),
                 lambda: cli.steps(frobnicate=True),
                 lambda: cli.manifest(1, frobnicate=True),
                 lambda: cli.reclaim(1, frobnicate=True)):
        with pytest.raises(ValueError, match="unknown keyword"):
            call()
    with pytest.raises(ValueError, match="topology"):
        StorageClient(obj.NodeStore(str(tmp_path / "x"), ACFG.n), ACFG, topo=None)


def test_topology_raises_until_the_scheduler_is_ported(tmp_path):
    """The client's ``topology`` default reaches the scheduler (ported): its
    archive equals the free function's with the same topology."""
    from repro_torch.core import topology
    free, cli = _pair(tmp_path)
    blocks = _blocks()
    arc.hot_save(free, 1, blocks, ACFG)
    cli.put_hot(1, blocks)
    cli.topology = topology.Topology.uniform(ACFG.n).with_slow(2, 3.0)
    got = cli.archive(1)
    assert got == arc.archive_step(free, 1, ACFG, topology=cli.topology, device="cpu")
    assert got["sched"]["topology"] == cli.topology.to_dict()
    np.testing.assert_array_equal(cli.read(1).data, blocks)


# ---------------------------------------------------------------------------
# ReadResult: served_from / nodes / healed over the object lifecycle
# ---------------------------------------------------------------------------


def test_read_result_temperature_routing(tmp_path):
    _, cli = _pair(tmp_path)
    blocks = _blocks(5)
    cli.put_hot(1, blocks)
    hot = cli.read(1)
    assert hot.served_from == "hot" and not hot.healed
    assert hot.nodes == tuple(sorted(set(hot.nodes)))
    cli.archive(1)
    coded = cli.read(1)
    assert coded.served_from == "coded"
    assert ACFG.k <= len(coded.nodes) <= ACFG.n
    cli.store.fail_node(coded.nodes[0])
    degraded = cli.read(1)
    assert degraded.served_from == "degraded"
    assert coded.nodes[0] not in degraded.nodes
    np.testing.assert_array_equal(degraded.data, blocks)
    np.testing.assert_array_equal(degraded.data, coded.data)


def test_read_result_heal_flag_and_range(tmp_path):
    _, cli = _pair(tmp_path)
    blocks = _blocks(6)
    cli.put_hot(1, blocks)
    cli.archive(1)
    cli.store.fail_node(0)
    res = cli.read(1, heal=True)
    assert res.healed and res.served_from == "coded"
    rr = cli.read_range(1, 10, 300)
    assert rr.served_from == "coded"
    assert rr.data == blocks.reshape(-1)[10:310].tobytes()


def test_raw_shims_match_ex_results(tmp_path):
    _, cli = _pair(tmp_path)
    cli.put_hot(1, _blocks(7))
    cli.archive(1)
    np.testing.assert_array_equal(arc.restore_blocks(cli.store, 1, ACFG),
                                  arc.restore_blocks_ex(cli.store, 1, ACFG).data)
    assert (arc.read_range(cli.store, 1, ACFG, 5, 99)
            == arc.read_range_ex(cli.store, 1, ACFG, 5, 99).data)


# ---------------------------------------------------------------------------
# the two packages' facades on the same inputs
# ---------------------------------------------------------------------------


def test_facades_agree_with_the_jax_package(tmp_path):
    """One lifecycle through both facades: equal manifests, reads, repairs
    and ReadResults, and byte-identical store trees."""
    cli = StorageClient(obj.NodeStore(str(tmp_path / "port"), 8), ACFG, device="cpu")
    jcli = JStorageClient(jobj.NodeStore(str(tmp_path / "jax"), 8),
                          jarc.ArchiveConfig(n=8, k=4, l=16, num_chunks=4), use_devices=False)
    for s in (1, 2, 3):
        assert cli.put_hot(s, _blocks(20 + s)) == jcli.put_hot(s, _blocks(20 + s))
    assert cli.archive(1, superchunk_bytes=96) == jcli.archive(1, superchunk_bytes=96)
    assert cli.archive_many([2, 3]) == jcli.archive_many([2, 3])
    for c in (cli, jcli):
        c.store.fail_node(2)
        c.store.fail_node(5)
    for step in (1, 2):
        assert fields(cli.read(step)) == fields(jcli.read(step))
        assert fields(cli.read_range(step, 33, 700)) == fields(jcli.read_range(step, 33, 700))
    assert cli.repair_many([1, 2, 3]) == jcli.repair_many([1, 2, 3])
    assert cli.steps() == jcli.steps()
    port, jax = tree(cli.store.root), tree(jcli.store.root)
    assert port == jax


def fields(res) -> tuple:
    """A ReadResult of either package as plain values."""
    data = res.data.tobytes() if isinstance(res.data, np.ndarray) else res.data
    return data, res.served_from, res.nodes, res.healed, res.step


def tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out
