"""The live cluster of the PyTorch/CUDA port against the JAX package: churn.

``repro_torch.core.churn`` draws the JAX package's traces and Monte Carlo
results draw for draw, and ``repro_torch.storage.lifecycle`` runs the JAX
package's engine on the port's archive. On the CPU (``device="cpu"``, the
kernels' plain versions) the same configs and trace through both engines
give equal per-tick rows and summaries and store trees that are equal file
by file; the JAX engine encodes on the host (``use_devices=False``), the
port through its chain (``use_devices=None``), as it does on the card. The
rest are the counterparts of ``tests/test_lifecycle.py`` against the port.
Tests marked ``gpu`` run the engine on the card and skip without one.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import autotune, churn, jitcache  # noqa: E402
from repro_torch.kernels.gf_encode import kernel  # noqa: E402
from repro_torch.storage import archive as arc  # noqa: E402
from repro_torch.storage import object_store as obj  # noqa: E402
from repro_torch.storage.lifecycle import ClusterLifecycle, LifecycleConfig  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    from repro.core import churn as jchurn
    from repro.storage import archive as jarc
    from repro.storage import lifecycle as jlife
except ImportError:
    jchurn = None

N, K = 6, 4


@pytest.fixture(autouse=True)
def _isolated(request, tmp_path, monkeypatch):
    """A private tuning cache and a clean program cache for every test."""
    if jchurn is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setenv(autotune.TUNE_ENV, "cached")
    autotune.reset()
    jitcache.clear()
    yield
    jitcache.clear()
    autotune.reset()


def _acfg(n=N, k=K, **kw):
    return arc.ArchiveConfig(n=n, k=k, l=16, num_chunks=4, **kw)


def _lcfg(**kw):
    base = dict(arrival_rate=0.5, block_bytes=128, archive_age=2,
                batch_max=4, seed=0)
    base.update(kw)
    return LifecycleConfig(**base)


def _engine(root, ticks, seed=0, fail_rate=0.03, device="cpu", **lkw):
    trace = churn.bounded_trace(N, K, ticks, fail_rate=fail_rate, seed=seed)
    return ClusterLifecycle(str(root), _acfg(), _lcfg(**lkw), trace,
                            device=device), trace


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


@pytest.fixture
def routes(monkeypatch):
    """Counts the port's calls into its chain and repair-chain entry points
    (on the CPU the kernels' plain versions run, which count no launches)."""
    calls = {"encode_many": 0, "repair_many": 0}
    for mod, name, key in ((arc.multi_lib, "pipelined_encode_many", "encode_many"),
                           (arc.repair_lib, "pipelined_repair_many", "repair_many")):
        def spy(*a, _fn=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


def engines(tmp_path, n, k, ticks, fail_rate, seed, admission=None, jadmission=None, **lkw):
    """The same cluster twice: the port's engine on the CPU through its chain,
    the JAX package's on the host oracle."""
    trace = churn.bounded_trace(n, k, ticks, fail_rate=fail_rate, seed=seed)
    jtrace = jchurn.bounded_trace(n, k, ticks, fail_rate=fail_rate, seed=seed)
    assert trace.to_dict() == jtrace.to_dict()
    base = dict(arrival_rate=0.7, block_bytes=128, archive_age=2, batch_max=4, seed=seed)
    base.update(lkw)
    port = ClusterLifecycle(str(tmp_path / "port"), _acfg(n, k), LifecycleConfig(**base),
                            trace, admission=admission, device="cpu")
    ref = jlife.ClusterLifecycle(
        str(tmp_path / "jax"), jarc.ArchiveConfig(n=n, k=k, l=16, num_chunks=4),
        jlife.LifecycleConfig(**base, use_devices=False), jtrace, admission=jadmission)
    return port, ref


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,ticks,l_seed", [(6, 4, 200, 3), (6, 4, 50, 11), (16, 11, 40, 0)])
def test_traces_equal_reference(tmp_path, n, k, ticks, l_seed):
    """synthetic_trace and bounded_trace equal as JSON, through the round trip."""
    b, jb = (churn.bounded_trace(n, k, ticks, fail_rate=0.08, seed=l_seed),
             jchurn.bounded_trace(n, k, ticks, fail_rate=0.08, seed=l_seed))
    assert b.to_dict() == jb.to_dict() and b.events
    assert churn.replica_pairs(n, k) == jchurn.replica_pairs(n, k)
    cfg = dict(n_nodes=n, fail_rate=0.05, mean_down_ticks=3, max_down=3, heal_ticks=2,
               protect=((0, 1),), seed=l_seed)
    s = churn.synthetic_trace(churn.ChurnConfig(**cfg), ticks)
    js = jchurn.synthetic_trace(jchurn.ChurnConfig(**cfg), ticks)
    assert s.to_dict() == js.to_dict()
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    churn.save_trace(path, s)
    jchurn.save_trace(jpath, js)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    want = json.loads(json.dumps(s.to_dict()))    # JSON gives lists for tuples
    assert churn.load_trace(jpath).to_dict() == jchurn.load_trace(path).to_dict() == want


def test_trace_validation_errors_equal_reference():
    base = churn.bounded_trace(N, K, 50, seed=1).to_dict()
    cases = [lambda d: d.update(version=99),
             lambda d: d["events"].append({"tick": 999, "op": "fail", "node": N}),
             lambda d: d["events"].append({"tick": 999, "op": "explode", "node": 0}),
             lambda d: d["events"].append({"tick": 999}),
             lambda d: d.update(events=[{"tick": 0, "op": "join", "node": 1}]),
             lambda d: d.update(events=[{"tick": 3, "op": "fail", "node": 1},
                                        {"tick": 2, "op": "join", "node": 1}]),
             lambda d: d.update(events=[{"tick": 0, "op": "fail", "node": 1},
                                        {"tick": 1, "op": "fail", "node": 1}]),
             lambda d: d.pop("n_nodes"), lambda d: d.clear()]
    for mutate in cases:
        d = json.loads(json.dumps(base))
        mutate(d)
        with pytest.raises(ValueError) as got:
            churn.trace_from_dict(d)
        with pytest.raises(ValueError) as want:
            jchurn.trace_from_dict(d)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="JSON object"):
        churn.trace_from_dict([])


def test_monte_carlo_equal_reference():
    kw = dict(ticks=120, trials=200, fail_rate=0.01, seed=4)
    assert churn.monte_carlo_durability(**kw) == jchurn.monte_carlo_durability(**kw)
    kw = dict(ticks=80, trials=60, fail_rate=0.02, seed=2, block_words=256)
    got = churn.monte_carlo_code_compare(**kw)
    assert got == jchurn.monte_carlo_code_compare(**kw)
    assert set(got["per_family"]) == {"rapidraid", "lrc", "mbr"}


@pytest.mark.parametrize("n,k,ticks,fail_rate,seed,rate", [(6, 4, 20, 0.05, 5, 0.7),
                                                            (16, 11, 10, 0.03, 0, 1.0)])
def test_soak_equals_reference(tmp_path, routes, n, k, ticks, fail_rate, seed, rate):
    """Per-tick rows, summary, metrics JSON (but use_devices) and the stores,
    file by file."""
    port, ref = engines(tmp_path, n, k, ticks, fail_rate, seed, arrival_rate=rate)
    rows = port.run(ticks)
    assert rows == ref.run(ticks)
    assert port.summary() == ref.summary()
    assert port.scrub_errors == ref.scrub_errors
    assert port.objects == ref.objects
    assert_same_tree(port.store.root, ref.store.root)
    got, want = json.loads(port.metrics_json()), json.loads(ref.metrics_json())
    assert got["config"]["lcfg"].pop("use_devices") is None
    assert want["config"]["lcfg"].pop("use_devices") is False
    assert got == want
    # the port's migrations ran its chain
    assert sum(r["archived"] for r in rows) > 0 and routes["encode_many"] > 0
    assert port.verify_all() == ref.verify_all() == port.summary()["objects"]


def test_soak_heals_on_both_routes_equals_reference(tmp_path, routes, monkeypatch):
    """A run whose coded scrub heals shards, through the port's chain
    (``use_devices=None``) and its host route (``False``: the host oracle
    and the static-coefficient repair): both equal the JAX host oracle's
    rows and stores. Every scrub and restore hashes in parallel threads
    here (``PARALLEL_DIGEST_BYTES`` = 0), as a store of large objects does."""
    monkeypatch.setattr(obj, "PARALLEL_DIGEST_BYTES", 0)
    port, ref = engines(tmp_path, 6, 4, 18, 0.08, 7, arrival_rate=1.0)
    rows = ref.run(18)
    assert port.run(18) == rows
    assert port.summary()["total_repaired_shards"] > 0
    assert routes["encode_many"] > 0 and routes["repair_many"] > 0
    assert_same_tree(port.store.root, ref.store.root)
    host = ClusterLifecycle(str(tmp_path / "host"), port.acfg,
                            dataclasses.replace(port.lcfg, use_devices=False),
                            churn.bounded_trace(6, 4, 18, fail_rate=0.08, seed=7), device="cpu")
    before = dict(routes)
    assert host.run(18) == rows
    assert routes == before
    assert_same_tree(host.store.root, ref.store.root)


def test_code_policy_equals_reference(tmp_path):
    """A temperature policy archives young objects as LRC (the static
    route) and old ones as RapidRAID, in both packages."""
    from repro.core import scheduler as jsched

    from repro_torch.core import scheduler
    port, ref = engines(tmp_path, 6, 4, 16, 0.03, 1, arrival_rate=1.0)
    port.lcfg = dataclasses.replace(port.lcfg, code_policy=scheduler.CodePolicy(
        hot_family="lrc", cold_family="rapidraid", cold_age=3))
    ref.lcfg = dataclasses.replace(ref.lcfg, code_policy=jsched.CodePolicy(
        hot_family="lrc", cold_family="rapidraid", cold_age=3))
    assert port.run(16) == ref.run(16)
    fams = {arc.get_manifest(port.store, s).get("family") for s, st in port.objects.items()
            if st["state"] in ("archived", "sealed")}
    assert "lrc" in fams
    assert_same_tree(port.store.root, ref.store.root)


# ---------------------------------------------------------------------------
# counterparts of tests/test_lifecycle.py
# ---------------------------------------------------------------------------


def test_trace_roundtrip(tmp_path):
    trace = churn.bounded_trace(N, K, 100, seed=3)
    path = str(tmp_path / "trace.json")
    churn.save_trace(path, trace)
    back = churn.load_trace(path)
    assert back.n_nodes == trace.n_nodes
    assert back.events == trace.events


def test_trace_validation_errors(tmp_path):
    base = churn.bounded_trace(N, K, 50, seed=1).to_dict()

    def load(mutate):
        d = json.loads(json.dumps(base))
        mutate(d)
        p = str(tmp_path / "t.json")
        with open(p, "w") as f:
            json.dump(d, f)
        return churn.load_trace(p)

    with pytest.raises(ValueError, match="version"):
        load(lambda d: d.update(version=99))
    with pytest.raises(ValueError, match="outside"):
        load(lambda d: d["events"].append({"tick": 999, "op": "fail", "node": N}))
    with pytest.raises(ValueError, match="op"):
        load(lambda d: d["events"].append({"tick": 999, "op": "explode", "node": 0}))
    with pytest.raises(ValueError, match="malformed"):
        load(lambda d: d["events"].append({"tick": 999}))
    with pytest.raises(ValueError, match="not down"):
        load(lambda d: d.update(events=[{"tick": 0, "op": "join", "node": 1}]))
    p = str(tmp_path / "garbage.json")
    with open(p, "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="corrupt churn trace"):
        churn.load_trace(p)


def test_bounded_trace_respects_bounds():
    trace = churn.bounded_trace(N, K, 300, fail_rate=0.08, seed=7)
    pairs = [set(g) for g in churn.replica_pairs(N, K)]
    assert pairs and all(len(g) == 2 for g in pairs)
    down, dirty = set(), {}
    saw_fail = False
    for t in range(301):
        for ev in trace.by_tick().get(t, []):
            if ev.op == "join":
                down.discard(ev.node)
                dirty[ev.node] = t + 1
            else:
                saw_fail = True
                down.add(ev.node)
        unhealed = down | {m for m, d in dirty.items() if d > t}
        assert len(unhealed) <= N - K
        assert not any(g <= unhealed for g in pairs)
    assert saw_fail


def test_determinism_same_seed_same_metrics_and_manifests(tmp_path):
    runs = []
    for name in ("a", "b"):
        eng, _ = _engine(tmp_path / name, 30, seed=5, fail_rate=0.05)
        metrics = eng.run(30)
        manifests = {s: arc.get_manifest(eng.store, s)
                     for s, st in eng.objects.items() if st["state"] != "lost"}
        runs.append((metrics, manifests))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]


def test_soak_bounded_churn_zero_loss(tmp_path):
    """The acceptance soak on the port (the JAX package runs it at 200
    ticks; the parity soaks above hold the port to it tick by tick)."""
    eng, trace = _engine(tmp_path, 80, seed=0, fail_rate=0.03)
    metrics = eng.run(80)
    assert len(trace.events) > 5
    s = eng.summary()
    assert s["lost_objects"] == 0
    assert s["scrub_errors"] == 0
    assert s["total_repaired_shards"] > 0
    assert eng.verify_all() == s["objects"]
    assert metrics[-1]["storage_overhead"] < 1.7
    assert all(r["lost_objects"] == 0 for r in metrics)


def test_reclaim_only_after_digest_verified_archival(tmp_path):
    store = obj.NodeStore(str(tmp_path), N)
    acfg = _acfg()
    blocks = np.random.default_rng(0).integers(0, 256, size=(K, 128), dtype=np.uint8)
    arc.hot_save(store, 1, blocks, acfg)
    manifest = arc.archive_many(store, [1], acfg, reclaim_hot=False, device="cpu")[0]
    assert manifest["hot_retained"] is True

    def hot_files():
        return [(i, j) for i, held in enumerate(manifest["placement"]) for j in held
                if store.has(i, arc.HOT.format(step=1, j=j))]

    assert hot_files()
    pos = 2
    store.put(manifest["perm"][pos], arc.ARC.format(step=1, i=pos), b"corrupt!")
    assert arc.reclaim_replicas(store, 1) is None
    assert hot_files()
    assert arc.repair(store, 1, acfg, device="cpu") == [pos]
    sealed = arc.reclaim_replicas(store, 1)
    assert sealed["hot_retained"] is False
    assert not hot_files()
    assert arc.reclaim_replicas(store, 1)["hot_retained"] is False
    np.testing.assert_array_equal(arc.restore_blocks(store, 1, acfg), blocks)


def test_retained_replicas_back_unrecoverable_archive(tmp_path):
    store = obj.NodeStore(str(tmp_path), N)
    acfg = _acfg()
    blocks = np.random.default_rng(1).integers(0, 256, size=(K, 128), dtype=np.uint8)
    arc.hot_save(store, 1, blocks, acfg)
    with pytest.raises(ValueError, match="not archived"):
        arc.reclaim_replicas(store, 1)
    manifest = arc.archive_step(store, 1, acfg, reclaim_hot=False, device="cpu")
    for pos in range(N - K + 1):
        store.delete(manifest["perm"][pos], arc.ARC.format(step=1, i=pos))
    np.testing.assert_array_equal(arc.restore_blocks(store, 1, acfg), blocks)
    np.testing.assert_array_equal(
        arc.restore_blocks(store, 1, acfg, heal=True, device="cpu"), blocks)


def test_digests_parallel_equal_serial(monkeypatch):
    blobs = [bytes([i]) * (1000 + i) for i in range(9)] + [b""]
    want = [obj.digest(b) for b in blobs]
    assert obj.digests(blobs) == want
    monkeypatch.setattr(obj, "PARALLEL_DIGEST_BYTES", 0)
    assert obj.digests(blobs) == want and obj.digests([]) == []


def test_churn_store_drops_writes_and_reads_while_down(tmp_path):
    store = obj.ChurnNodeStore(str(tmp_path), 3)
    store.put(1, "x.bin", b"alive")
    store.fail(1)
    assert not store.is_up(1)
    assert not store.has(1, "x.bin")
    store.put(1, "y.bin", b"dropped")
    with pytest.raises(FileNotFoundError, match="down"):
        store.get(1, "x.bin")
    with pytest.raises(FileNotFoundError, match="down"):
        store.get_range(1, "x.bin", 0, 1)
    store.rejoin(1)
    assert store.is_up(1)
    assert not store.has(1, "y.bin")
    assert not store.has(1, "x.bin")
    store.put(1, "z.bin", b"back")
    assert store.get(1, "z.bin") == b"back"


def test_engine_reports_corrupt_manifest_as_scrub_error(tmp_path):
    eng, _ = _engine(tmp_path / "e", 6, fail_rate=0.0, arrival_rate=1.0)
    eng.run(6)
    step = next(s for s, st in eng.objects.items() if st["state"] in ("archived", "sealed"))
    rel = arc.MANIFEST.format(step=step)
    for i in range(N):
        eng.store.put(i, rel, b"{broken")
    eng.tick()
    assert any(f"step {step}" in e for e in eng.scrub_errors)
    assert eng.objects[step]["state"] == "lost"


def test_kernel_failure_raises_out_of_tick(tmp_path, monkeypatch):
    """No catch-all: a failure inside the migration's encode is not a scrub
    finding, it raises out of tick()."""
    eng, _ = _engine(tmp_path / "e", 6, fail_rate=0.0, arrival_rate=1.0)
    eng.run(2)

    def boom(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(arc.multi_lib, "pipelined_encode_many", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.run(4)
    assert eng.scrub_errors == []


def test_monte_carlo_durability_deterministic_and_ordered():
    kw = dict(ticks=200, trials=300, fail_rate=0.006, seed=0)
    a = churn.monte_carlo_durability(**kw)
    assert a == churn.monte_carlo_durability(**kw)
    assert a["p_loss_rapidraid"] <= a["p_loss_replication"]
    assert a["overhead_rapidraid"] < a["overhead_replication"]
    with pytest.raises(ValueError, match="replication"):
        churn.monte_carlo_durability(replication=0)


def test_engine_rejects_mismatched_trace_and_block_alignment(tmp_path):
    trace = churn.bounded_trace(8, 5, 10)
    with pytest.raises(ValueError, match="nodes"):
        ClusterLifecycle(str(tmp_path), _acfg(), _lcfg(), trace)
    trace = churn.bounded_trace(N, K, 10)
    with pytest.raises(ValueError, match="multiple of 8"):
        ClusterLifecycle(str(tmp_path), _acfg(), _lcfg(block_bytes=129), trace)


def test_default_device_is_the_card(tmp_path):
    """Without device= the engine's migration goes to CUDA: it launches
    the kernel there or raises, never falls back to the CPU."""
    eng = ClusterLifecycle(str(tmp_path), _acfg(), _lcfg(arrival_rate=1.0),
                           churn.bounded_trace(N, K, 6, fail_rate=0.0))
    assert eng.device is None and eng.lcfg.use_devices is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gpu test drives it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.run(6)


@pytest.mark.gpu
def test_soak_on_card_equals_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runs = []
    for name, device in (("cuda", "cuda"), ("cpu", "cpu")):
        trace = churn.bounded_trace(N, K, 30, fail_rate=0.08, seed=7)
        eng = ClusterLifecycle(str(tmp_path / name), _acfg(), _lcfg(arrival_rate=1.0), trace,
                               device=device)
        kernel.reset_launch_counts()
        runs.append((eng.run(30), eng.summary(), kernel.launch_counts(), eng))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert runs[0][2]["chain_tick"] > 0 and runs[0][2]["repair_tick"] > 0
    assert_same_tree(runs[0][3].store.root, runs[1][3].store.root)
