"""The control plane of the PyTorch/CUDA port against the JAX package.

On the CPU (``device="cpu"``, the kernels' plain versions):

* ``core/topology.py`` and ``core/scheduler.py`` give the JAX package's
  numbers on seeded topologies: makespans, stage times, read-time models,
  ``best_num_chunks``, ``plan_chain``, ``plan_many``,
  ``fit_chain_constants``; ``archive_step`` / ``archive_many`` with
  ``topology=`` write the JAX package's manifests and store trees;
* ``core/autotune.py``: mode validation, the cache's round trip and its
  corruption errors, the port's ``torch-cpu`` backend keys (a JAX-written
  entry in the same file is not read, nor the reverse), the resolution of
  ``num_chunks_for`` / ``stagger_for`` and of the entry points'
  ``num_chunks=None`` / ``stagger=None``, ``encode_auto`` on ``"vpu"`` and
  ``"mxu"`` entries, and probes: a ``ValueError`` candidate is skipped and
  recorded, a ``RuntimeError`` propagates; ``prewarm`` and the CLI, whose
  second run on a warm cache makes zero probes.

Tests marked ``gpu`` run the tuned routes on the card against the plain
versions and skip without one.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import autotune, gf, jitcache, rapidraid as rr  # noqa: E402
from repro_torch.core import scheduler, topology  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops  # noqa: E402
from repro_torch.storage import archive as arc  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402
from repro_torch.storage import object_store as obj  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    from repro.core import autotune as jautotune
    from repro.core import gf as jgf
    from repro.core import scheduler as jscheduler
    from repro.core import topology as jtopology
    from repro.storage import archive as jarc
    from repro.storage import object_store as jobj
except ImportError:
    jautotune = None


@pytest.fixture(autouse=True)
def _isolated(request, tmp_path, monkeypatch):
    """Every test gets a private tuning cache, clean counters and programs."""
    if jautotune is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setenv(autotune.TUNE_ENV, "cached")
    autotune.reset()
    jitcache.clear()
    yield
    autotune.reset()
    jitcache.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def words(rng, shape, l):
    return rng.integers(0, 1 << l, size=shape).astype(gf.WORD_DTYPE[l])


def seeded_topologies(seed, n_nodes):
    """The same random heterogeneous topology in both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(compute_rate=tuple(float(x) for x in rng.uniform(1e8, 8e8, n_nodes)),
              nic_bw=tuple(float(x) for x in rng.uniform(5e7, 5e8, n_nodes)),
              hop_latency=float(rng.uniform(0, 1e-3)),
              tick_overhead=float(rng.uniform(0, 1e-3)),
              tick_quad=float(rng.uniform(0, 1e-15)))
    return topology.Topology(**kw), jtopology.Topology(**kw)


# ---------------------------------------------------------------------------
# topology and scheduler
# ---------------------------------------------------------------------------

CHAINS = [(0, 6, 4), (1, 8, 5), (2, 12, 8), (3, 16, 11)]


@pytest.mark.parametrize("seed,n,k", CHAINS)
def test_topology_models_equal_reference(seed, n, k):
    t, jt = seeded_topologies(seed, n)
    assert t.to_dict() == jt.to_dict()
    assert topology.Topology.from_dict(jt.to_dict()) == t
    order = list(np.random.default_rng(seed).permutation(n))
    bb = float(1 << 20)
    assert topology.position_blocks(n, k) == jtopology.position_blocks(n, k)
    assert topology.chain_taus(t, order, k, 4096.0) == jtopology.chain_taus(jt, order, k, 4096.0)
    for c in (1, 2, 8, 64):
        assert topology.chain_makespan(t, order, k, bb, c) == \
            jtopology.chain_makespan(jt, order, k, bb, c)
    assert [topology.node_cost(t, i) for i in range(n)] == \
        [jtopology.node_cost(jt, i) for i in range(n)]
    assert topology.with_background(t, 2.5).to_dict() == \
        jtopology.with_background(jt, 2.5).to_dict()
    assert topology.hot_read_time(t, 1, 1e6) == jtopology.hot_read_time(jt, 1, 1e6)
    helpers = order[:k]
    assert topology.coded_read_time(t, 0, helpers, 1e6) == \
        jtopology.coded_read_time(jt, 0, helpers, 1e6)
    assert t.with_slow(2, 3.0).to_dict() == jt.with_slow(2, 3.0).to_dict()


@pytest.mark.parametrize("seed,n,k", CHAINS)
def test_scheduler_plans_equal_reference(seed, n, k):
    t, jt = seeded_topologies(seed, n)
    for bb in (4096.0, float(1 << 22)):
        assert scheduler.best_num_chunks(t, range(n), k, bb) == \
            jscheduler.best_num_chunks(jt, range(n), k, bb)
        assert scheduler.analytic_num_chunks(t, range(n), k, bb) == \
            jscheduler.analytic_num_chunks(jt, range(n), k, bb)
        assert scheduler.plan_chain(t, k, bb).to_manifest() == \
            jscheduler.plan_chain(jt, k, bb).to_manifest()
    t2, jt2 = seeded_topologies(seed + 10, 2 * n + 1)
    for objs in (1, 5):
        got = scheduler.plan_many(t2, objs, n, k, 1e6, stagger=2)
        want = jscheduler.plan_many(jt2, objs, n, k, 1e6, stagger=2)
        assert [p.to_manifest() for p in got.plans] == [p.to_manifest() for p in want.plans]
        assert (got.assignment, got.stagger) == (want.assignment, want.stagger)
    assert scheduler.CodePolicy().family_for(9) == jscheduler.CodePolicy().family_for(9)


def test_fit_chain_constants_equals_reference():
    rng = np.random.default_rng(4)
    samples = [(c, float(t)) for c, t in zip((1, 2, 4, 8, 16), rng.uniform(1e-3, 1e-2, 5))]
    topo, pred = topology.fit_chain_constants(samples, 8, 5, 4096.0)
    jtopo, jpred = jtopology.fit_chain_constants(samples, 8, 5, 4096.0)
    assert topo.to_dict() == jtopo.to_dict()
    np.testing.assert_array_equal(pred, jpred)
    with pytest.raises(ValueError, match="distinct"):
        topology.fit_chain_constants([(2, 1.0), (2, 2.0)], 8, 5, 4096.0)


def test_measure_compute_rates_on_the_cpu():
    rates = topology.measure_compute_rates(nwords=1 << 10, iters=1, devices=["cpu"])
    assert len(rates) == 1 and rates[0] > 0
    t = topology.measured(nwords=1 << 10)
    assert t.n_nodes >= 1 and t.nic_bw[0] == 250e6


@pytest.mark.parametrize("n,k,l", [(8, 4, 8), (6, 4, 16)])
def test_archive_manifests_with_topology_equal_reference(tmp_path, n, k, l):
    """``archive_step`` on a slowed topology (the chunk count the plan asks
    for clamped to the block), then ``archive_many`` on a cluster of two
    chains; repair reads the recorded placement. Trees equal the JAX
    package's, manifests included."""
    acfg = arc.ArchiveConfig(n=n, k=k, l=l, seed=2, num_chunks=4)
    jacfg = jarc.ArchiveConfig(n=n, k=k, l=l, seed=2, num_chunks=4)
    rng = np.random.default_rng(n)
    store, jstore = obj.NodeStore(str(tmp_path / "p"), n), jobj.NodeStore(str(tmp_path / "j"), n)
    for step in (1, 2, 3, 4):
        blocks = rng.integers(0, 256, (k, 192), dtype=np.uint8)
        assert arc.hot_save(store, step, blocks, acfg) == jarc.hot_save(jstore, step, blocks, jacfg)
    t, jt = (lib.Topology.uniform(n).with_slow(1, 4.0).with_slow(3, 4.0)
             for lib in (topology, jtopology))
    m = arc.archive_step(store, 1, acfg, topology=t, device="cpu")
    assert m == jarc.archive_step(jstore, 1, jacfg, topology=jt)
    assert m["sched"]["num_chunks"] <= 4 * 16 and m["perm"] == m["sched"]["order"]
    t2, jt2 = (lib.Topology.uniform(2 * n).with_slow(0, 3.0) for lib in (topology, jtopology))
    got = arc.archive_many(store, [2, 3, 4], acfg, topology=t2, stagger=2, device="cpu")
    assert got == jarc.archive_many(jstore, [2, 3, 4], jacfg, topology=jt2, stagger=2)
    assert {x["sched"]["chain_group"] for x in got} == {0, 1}
    for i in (m["perm"][0], m["perm"][2]):
        store.fail_node(i)
        jstore.fail_node(i)
    assert arc.repair(store, 1, acfg, device="cpu") == jarc.repair(jstore, 1, jacfg)
    from tests.test_torch_archive import assert_same_tree
    assert_same_tree(tmp_path / "p", tmp_path / "j")


# ---------------------------------------------------------------------------
# the tuning cache
# ---------------------------------------------------------------------------


def test_mode_validation(monkeypatch):
    for m in ("off", "cached", "search"):
        monkeypatch.setenv(autotune.TUNE_ENV, m)
        assert autotune.mode() == m == jautotune.mode()
    monkeypatch.delenv(autotune.TUNE_ENV)
    assert autotune.mode() == "cached"
    monkeypatch.setenv(autotune.TUNE_ENV, "fastest")
    with pytest.raises(ValueError, match="fastest"):
        autotune.mode()


def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "rt.json")
    c = autotune.TuningCache(path)
    assert c.entries == {}
    c.put("k1", {"value": 256, "timings_s": {"256": 0.001}})
    c.save()
    assert autotune.TuningCache(path).get("k1") == {"value": 256, "timings_s": {"256": 0.001}}
    assert jautotune.TuningCache(path).get("k1") == {"value": 256, "timings_s": {"256": 0.001}}
    assert json.loads((tmp_path / "rt.json").read_text())["version"] == autotune.CACHE_VERSION


@pytest.mark.parametrize("payload,match", [
    ("{not json", "not valid JSON"),
    ('["a", "b"]', "entries"),
    ('{"version": 999, "entries": {}}', "version"),
    ('{"version": 1, "entries": {"k": 5}}', "config dicts"),
])
def test_cache_corruption_value_errors(tmp_path, monkeypatch, payload, match):
    path = tmp_path / "bad.json"
    path.write_text(payload)
    with pytest.raises(ValueError, match=match) as ei:
        autotune.TuningCache(str(path))
    assert "bad.json" in str(ei.value)
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.reset()
    with pytest.raises(ValueError, match=match):      # surfaces through a lookup
        autotune.kernel_block("encode_packed", 16, 1024, heuristic=256)
    monkeypatch.setenv(autotune.TUNE_ENV, "off")      # off never opens the file
    autotune.reset()
    assert autotune.kernel_block("encode_packed", 16, 1024, heuristic=256) == 256


def test_backend_keys_are_the_ports_own():
    """The port keys ``torch-cpu`` / ``torch-cuda``; the JAX package keys
    ``cpu``. In one shared file neither reads the other's entry."""
    code = rr.RapidRAIDCode.make(8, 5, l=16, seed=0)
    key = autotune._key("encode", code.spec, "B=4096", "chain=8", "num_chunks")
    jkey = jautotune._key("encode", code.spec, "B=4096", "chain=8", "num_chunks")
    assert key.split("|")[1] == "torch-cpu" and jkey.split("|")[1] == "cpu"
    assert key.replace("torch-cpu", "cpu") == jkey          # the reference's layout
    assert autotune._key("x", device="cuda").split("|")[1] == "torch-cuda"
    jautotune.reset()
    jautotune.cache().put(jkey, {"value": 16})
    jautotune.cache().save()
    autotune.reset()
    assert autotune.num_chunks_for("encode", code, 4096) == 8      # JAX's 16 not read
    autotune.cache().put(key, {"value": 2})
    autotune.cache().save()
    jautotune.reset()
    assert jautotune.num_chunks_for("encode", code, 4096) == 16    # nor the reverse
    autotune.reset()
    assert autotune.num_chunks_for("encode", code, 4096) == 2
    assert sorted(json.loads(open(autotune.cache_path()).read())["entries"]) == \
        sorted([key, jkey])
    jautotune.reset()


def test_stats_and_reset():
    code = rr.RapidRAIDCode.make(6, 4, l=16, seed=0)
    jautotune.reset()
    autotune.num_chunks_for("encode", code, 1024)
    jautotune.num_chunks_for("encode", code, 1024)     # its entry and the calibration: 2
    assert autotune.stats() == jautotune.stats() == {"hits": 0, "misses": 2, "probes": 0}
    jautotune.reset()
    autotune.reset()
    assert autotune.stats() == {"hits": 0, "misses": 0, "probes": 0}


# ---------------------------------------------------------------------------
# resolution: num_chunks, stagger, dispatch, blocks
# ---------------------------------------------------------------------------


def test_num_chunks_resolution_matches_reference():
    code = rr.RapidRAIDCode.make(8, 5, l=16, seed=0)
    assert autotune.num_chunks_for("encode", code, 4096) == 8        # no cache, no calibration
    key = autotune._key("encode", code.spec, "B=4096", "chain=8", "num_chunks")
    autotune.cache().put(key, {"value": 16})
    assert autotune.num_chunks_for("encode", code, 4096) == 16
    autotune.cache().put(key, {"value": 3})                           # no longer divides
    assert autotune.num_chunks_for("encode", code, 4096) == 8
    # the model fallback engages only with a measured calibration, and
    # picks what the reference's model picks from the same calibration
    calib = {"compute_rate": 1e9, "tick_overhead": 1e-2}
    autotune.cache().put(autotune._key("chain_calib", "l=16"), calib)
    jautotune.cache().put(jautotune._key("chain_calib", "l=16"), calib)
    assert autotune.num_chunks_for("decode", code, 4096, chain_len=6) == \
        jautotune.num_chunks_for("decode", code, 4096, chain_len=6) == 1
    assert autotune.calibrated_topology(6).to_dict() == \
        jautotune.calibrated_topology(6).to_dict()
    plan = scheduler.plan_chain(None, 4, 1 << 20, n=6)
    assert plan.to_manifest() == jscheduler.plan_chain(None, 4, 1 << 20, n=6).to_manifest()
    assert autotune.stats()["probes"] == 0
    jautotune.reset()


def test_stagger_and_mode_off(monkeypatch):
    code = rr.RapidRAIDCode.make(6, 4, l=16, seed=0)
    assert autotune.stagger_for(code, 4, 8) == 1
    key = autotune._key("stagger", code.spec, "b=4", "nc=8")
    autotune.cache().put(key, {"value": 8})
    assert autotune.stagger_for(code, 4, 8) == 8
    autotune.cache().put(key, {"value": 40})
    assert autotune.stagger_for(code, 4, 8) == 1
    monkeypatch.setenv(autotune.TUNE_ENV, "off")
    autotune.reset()
    assert autotune.num_chunks_for("encode", code, 4096) == 8
    assert autotune.stagger_for(code, 4, 8) == 1
    assert autotune.stats() == {"hits": 0, "misses": 0, "probes": 0}


def test_entry_points_take_tuned_values_and_equal_explicit_calls():
    """``num_chunks=None`` / ``stagger=None`` in chain, multi and repair
    resolve through the cache (the program key shows the value used), and
    a tuned call's words equal the explicit call's."""
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=1)
    rng = np.random.default_rng(0)
    B = 256
    data = words(rng, (code.k, B), 16)
    objs = words(rng, (3, code.k, B), 16)
    cw = code.encode_np(data)
    ids = [0, 2, 3, 5, 6, 7]
    missing = (1, 4)
    helpers, _ = repair._repair_plan_cached(code, missing, tuple(ids))
    tuned = {("encode", code.n, ()): 4, ("decode", len(ids), ()): 2,
             ("encode_many", code.n, (3,)): 16, ("repair", len(helpers), ()): 32,
             ("repair_many", len(helpers), (3,)): 2}
    for (entry, chain_len, extra), value in tuned.items():
        autotune.cache().put(autotune._key(
            entry, code.spec, f"B={B}", f"chain={chain_len}",
            *[f"x{i}={v}" for i, v in enumerate(extra)], "num_chunks"), {"value": value})
    autotune.cache().put(autotune._key("stagger", code.spec, "b=3", "nc=16"), {"value": 8})
    dev = "cpu"
    got = chain.pipelined_encode(code, data, device=dev)
    assert torch.equal(got, chain.pipelined_encode(code, data, num_chunks=4, device=dev))
    np.testing.assert_array_equal(got.numpy(), cw)
    dec = chain.pipelined_decode(code, ids, cw[ids], device=dev)
    np.testing.assert_array_equal(dec.numpy(), data)
    many = multi.pipelined_encode_many(code, objs, device=dev)
    assert torch.equal(many, multi.pipelined_encode_many(code, objs, num_chunks=16, stagger=8,
                                                         device=dev))
    rep = repair.pipelined_repair(code, ids, cw[ids], missing, device=dev)
    np.testing.assert_array_equal(rep.numpy(), cw[list(missing)])
    cws = np.stack([code.encode_np(o) for o in objs])
    rep_many = repair.pipelined_repair_many(code, ids, cws[:, ids], missing, device=dev)
    np.testing.assert_array_equal(rep_many.numpy(), cws[:, list(missing)])
    keys = jitcache.compile_counts()
    for want in ("('encode', ", "('decode', ", "('encode_many', ", "('repair', ",
                 "('repair_many', "):
        assert any(k.startswith(want) for k in keys), want
    assert any(k.startswith("('encode', ") and ", 4, device(" in k for k in keys)
    assert any(k.startswith("('encode_many', ") and ", 16, 8, device(" in k for k in keys)
    assert any(k.startswith("('repair', ") and ", 32, device(" in k for k in keys)
    assert autotune.stats()["probes"] == 0


def test_search_mode_probes_persist_and_warm_runs_make_none(monkeypatch):
    monkeypatch.setenv(autotune.TUNE_ENV, "search")
    autotune.reset()
    code = rr.RapidRAIDCode.make(6, 4, l=8, seed=0)
    data = words(np.random.default_rng(1), (code.k, 512), 8)
    calls = []

    def probe(c):
        calls.append(c)
        return chain.pipelined_encode(code, data, num_chunks=c, device="cpu")
    nc = autotune.num_chunks_for("encode", code, 512, probe=probe)
    assert nc in autotune.chunk_candidates_for(8, 512) and autotune.stats()["probes"] == 1
    entry = autotune.cache().get(autotune._key("encode", code.spec, "B=512", "chain=6",
                                               "num_chunks"))
    assert entry["value"] == nc and set(entry["timings_s"]) == \
        {str(c) for c in autotune.chunk_candidates_for(8, 512)}
    autotune.reset()
    calls.clear()
    assert autotune.num_chunks_for("encode", code, 512, probe=probe) == nc
    assert calls == [] and autotune.stats()["probes"] == 0


def test_probe_value_errors_are_skipped_and_runtime_errors_raise(monkeypatch):
    monkeypatch.setenv(autotune.TUNE_ENV, "search")
    autotune.reset()

    def too_big():
        raise ValueError("needs 300000 bytes of shared memory")
    got = autotune.dispatch_for(16, 16, 11, 4096, probes={"vpu": lambda: None, "mxu": too_big})
    assert got == "vpu"
    entry = autotune.cache().get(autotune._key("dispatch", "l=16", "rows=16", "k=11",
                                               "B=4096"))
    assert entry["skipped"] == {"mxu": "needs 300000 bytes of shared memory"}

    def broken():
        raise RuntimeError("gf_encode_mxu: launch failed with CUDA driver error 719")
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.dispatch_for(16, 16, 11, 8192, probes={"vpu": lambda: None, "mxu": broken})
    assert autotune.cache().get(autotune._key("dispatch", "l=16", "rows=16", "k=11",
                                              "B=8192")) is None
    with pytest.raises(RuntimeError, match="nvcc"):
        autotune.num_chunks_for("encode", rr.RapidRAIDCode.make(6, 4, l=16), 1024,
                                probe=lambda c: (_ for _ in ()).throw(RuntimeError("nvcc")))


@pytest.mark.parametrize("dispatch", ["vpu", "mxu"])
@pytest.mark.parametrize("l", [8, 16])
def test_encode_auto_parity(dispatch, l):
    rng = np.random.default_rng(l)
    code = rr.RapidRAIDCode.make(8, 4, l=l, seed=2)
    for shape in ((code.k, 64), (3, code.k, 64)):
        x = words(rng, shape, l)
        autotune.cache().put(autotune._key("dispatch", f"l={l}", f"rows={code.n}",
                                           f"k={code.k}", "B=64"), {"value": dispatch})
        assert ops.dispatch_for_data(code.G, torch.from_numpy(x), l) == dispatch
        got = ops.encode_auto(code.G, torch.from_numpy(x), l).numpy()
        want = (jgf.gf_matmul_np(code.G, x, l) if x.ndim == 2
                else np.stack([jgf.gf_matmul_np(code.G, o, l) for o in x]))
        np.testing.assert_array_equal(got, want)


def test_archive_many_routes_families_without_a_chain_through_encode_auto(tmp_path):
    acfg = arc.ArchiveConfig(n=6, k=4, l=8, seed=2, family="mbr")
    jacfg = jarc.ArchiveConfig(n=6, k=4, l=8, seed=2, family="mbr")
    rng = np.random.default_rng(3)
    store, jstore = obj.NodeStore(str(tmp_path / "p"), 6), jobj.NodeStore(str(tmp_path / "j"), 6)
    for s in (1, 2):
        b = rng.integers(0, 256, (4, 96), dtype=np.uint8)
        arc.hot_save(store, s, b, acfg)
        jarc.hot_save(jstore, s, b, jacfg)
    code = acfg.code()
    W = code.to_message(np.zeros((4, 96), np.uint8)).shape[-1]
    autotune.cache().put(autotune._key("dispatch", "l=8", f"rows={code.G.shape[0]}",
                                       f"k={code.G.shape[1]}", f"B={-(-W // 4) * 4}"),
                         {"value": "mxu"})
    autotune.stats()
    assert arc.archive_many(store, [1, 2], acfg, device="cpu") == \
        jarc.archive_many(jstore, [1, 2], jacfg)
    assert autotune.stats()["hits"] >= 1            # the dispatch was read
    from tests.test_torch_archive import assert_same_tree
    assert_same_tree(tmp_path / "p", tmp_path / "j")


def test_tick_and_mxu_widths_are_the_kernels():
    assert ops.pick_tick_block(4096) == 1024 and ops.pick_tick_block(4097) == 256
    assert autotune.tick_block(16, 4096, heuristic=ops.pick_tick_block(4096)) == 1024
    assert autotune.tune_tick_block(16, 4096) == 1024                # cached mode: no write
    assert autotune.cache().entries == {}
    x = torch.zeros((4, 64), dtype=torch.uint16)
    assert ops.mxu_block_for(np.ones((8, 4), np.int64), x, 16) == ops.MXU_TILE_WORDS == 64
    assert ops.encode_block_for(np.ones((8, 4), np.int64), x, 16) == kernel.ENCODE_THREADS


def test_prewarm_and_cli(tmp_path, monkeypatch, capsys):
    code = rr.RapidRAIDCode.make(6, 4, l=16, seed=0)
    with pytest.raises(ValueError, match="search"):
        autotune.prewarm(code, nwords=1024, device="cpu")
    monkeypatch.setenv(autotune.TUNE_ENV, "search")
    autotune.reset()
    rep = autotune.prewarm(code, nwords=1024, b_obj=2, chunk_counts=(1, 2, 4), device="cpu")
    assert rep["backend"] == "torch-cpu" and rep["stats"]["probes"] >= 4
    assert rep["dispatch"] in ("vpu", "mxu") and rep["encode_mxu_block"] == 64
    assert set(rep["calibration"]) >= {"compute_rate", "tick_overhead", "max_rel_err", "samples"}
    entries = json.loads(open(autotune.cache_path()).read())["entries"]
    assert all(k.split("|")[1] == "torch-cpu" for k in entries)
    from repro_torch import autotune as cli
    autotune.reset()
    assert cli.main(["--n", "6", "--k", "4", "--nwords", "1024", "--b-obj", "2",
                     "--chunk-counts", "1,2,4", "--device", "cpu", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["stats"]["probes"] == 0                             # warm: nothing probed
    for key in ("num_chunks_encode", "num_chunks_encode_many", "stagger", "dispatch"):
        assert report[key] == rep[key]
    monkeypatch.setenv(autotune.TUNE_ENV, "off")
    assert cli.main(["--device", "cpu"]) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("l", [8, 16])
def test_encode_auto_launches_the_dispatched_kernel(cuda, l):
    code = rr.RapidRAIDCode.make(16, 11, l=l, seed=3)
    rng = np.random.default_rng(l)
    for shape in ((code.k, 4096), (3, code.k, 4096)):
        x = torch.from_numpy(words(rng, shape, l)).to(cuda)
        want = ops.encode_auto(code.G, x.cpu(), l)           # the plain versions
        for dispatch, name in (("vpu", "gf_encode"), ("mxu", "gf_encode_mxu")):
            autotune.cache().put(autotune._key("dispatch", f"l={l}", f"rows={code.n}",
                                               f"k={code.k}", "B=4096", device=cuda),
                                 {"value": dispatch})
            kernel.reset_launch_counts()
            got = ops.encode_auto(code.G, x, l)
            assert kernel.launch_counts()[name] == 1
            assert torch.equal(gf.pack_u32(got.cpu(), l), gf.pack_u32(want, l))


@pytest.mark.gpu
def test_search_mode_on_the_card(cuda, monkeypatch):
    """Search-mode probes time the real kernels on the card and persist
    ``torch-cuda`` entries; a warm cache then makes no probe, and tuned
    entry points equal explicit calls."""
    monkeypatch.setenv(autotune.TUNE_ENV, "search")
    autotune.reset()
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=0)
    probed = []                  # (entry, num_chunks, the mesh the probe ran on)
    kernel.reset_launch_counts()
    with monkeypatch.context() as m:
        for mod, name in ((chain, "pipelined_encode"), (multi, "pipelined_encode_many")):
            def spy(*args, _real=getattr(mod, name), _name=name, **kw):
                probed.append((_name, kw.get("num_chunks"), kw.get("mesh")))
                return _real(*args, **kw)
            m.setattr(mod, name, spy)
        rep = autotune.prewarm(code, nwords=1 << 14, b_obj=2, chunk_counts=(1, 2, 4, 8))
    assert rep["backend"] == "torch-cuda" and rep["stats"]["probes"] >= 5
    # every chain probe ran the chain placed on this one card, a tick path
    card = chain._resolve_device(cuda)
    assert probed and all(mesh is not None and list(mesh.flat) == [card] * code.n
                          for _, _, mesh in probed)
    assert kernel.launch_counts()["chain_tick"] > 0
    entry = json.loads(open(autotune.cache_path()).read())["entries"][autotune._key(
        "encode", code.spec, "B=16384", "chain=8", "num_chunks", device=cuda)]
    assert entry["value"] == rep["num_chunks_encode"] and len(entry["timings_s"]) > 1
    assert {c for name, c, _ in probed if name == "pipelined_encode"} >= {
        int(c) for c in entry["timings_s"]}
    assert set(json.loads(open(autotune.cache_path()).read())["entries"][
        autotune._key("dispatch", "l=16", "rows=8", "k=4", "B=16384", device=cuda)]
        ["timings_s"]) == {"vpu", "mxu"}
    monkeypatch.setenv(autotune.TUNE_ENV, "cached")
    autotune.reset()
    data = autotune.random_words((code.k, 1 << 14), 16, cuda)
    got = chain.pipelined_encode(code, data)
    want = chain.pipelined_encode(code, data, num_chunks=rep["num_chunks_encode"])
    assert torch.equal(gf.pack_u32(got, 16), gf.pack_u32(want, 16))
    assert autotune.stats()["probes"] == 0
