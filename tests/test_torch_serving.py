"""The serving layer of the PyTorch/CUDA port against the JAX package.

``repro_torch.storage.workload`` draws the JAX package's traces in the same
order, ``repro_torch.core.admission`` grants what the JAX package's
controller grants, ``simulate_serving`` prices the same three scenarios,
and ``ServingEngine`` on the port's lifecycle (``device="cpu"``: the
kernels' plain versions) serves the same requests from the same tiers with
the same modelled latencies as the JAX package's engine on its host route,
with and without admission, degraded reads included. The rest are the
counterparts of ``tests/test_serving.py`` against the port.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import autotune, churn, jitcache  # noqa: E402
from repro_torch.core import topology as topo_lib  # noqa: E402
from repro_torch.core.admission import AdmissionConfig, AdmissionController  # noqa: E402
from repro_torch.storage import archive as arc  # noqa: E402
from repro_torch.storage import workload as wl  # noqa: E402
from repro_torch.storage.lifecycle import ClusterLifecycle, LifecycleConfig  # noqa: E402
from repro_torch.storage.serving import (ServingEngine, ServingModelConfig,  # noqa: E402
                                         percentiles, simulate_serving)

try:  # the reference
    from repro.core import admission as jadm
    from repro.core import churn as jchurn
    from repro.storage import archive as jarc
    from repro.storage import lifecycle as jlife
    from repro.storage import serving as jserv
    from repro.storage import workload as jwl
except ImportError:
    jwl = None

N, K = 6, 4


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    if jwl is None:
        pytest.skip("the JAX reference package is not installed")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setenv(autotune.TUNE_ENV, "cached")
    autotune.reset()
    jitcache.clear()
    yield
    jitcache.clear()
    autotune.reset()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(), dict(req_rate=3.0, seed=7),
                                 dict(req_rate=20.0, zipf_alpha=0.8, catalog_ranks=5,
                                      read_bytes_min=1, read_bytes_max=3, seed=2)])
def test_workload_equals_reference(tmp_path, cfg):
    trace = wl.synthetic_workload(wl.WorkloadConfig(**cfg), 60)
    want = jwl.synthetic_workload(jwl.WorkloadConfig(**cfg), 60)
    assert trace.to_dict() == want.to_dict() and trace.requests
    assert (wl.zipf_weights(16, 1.1) == jwl.zipf_weights(16, 1.1)).all()
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    wl.save_workload(path, trace)
    jwl.save_workload(jpath, want)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    assert wl.load_workload(jpath).to_dict() == jwl.load_workload(path).to_dict()


def test_workload_validation_equals_reference():
    base = wl.synthetic_workload(wl.WorkloadConfig(req_rate=4.0), 20).to_dict()
    cases = [lambda d: d.update(version=99), lambda d: d.update(n_users=0),
             lambda d: d["requests"][0].update(user=10 ** 9),
             lambda d: d["requests"][0].update(tick=-1),
             lambda d: d["requests"][0].update(offset_frac=1.5),
             lambda d: d["requests"][0].update(nbytes=0),
             lambda d: d["requests"][0].update(rank=99),
             lambda d: d["requests"][0].update(tick=10 ** 6),
             lambda d: d["requests"][0].pop("user"), lambda d: d.pop("requests")]
    for mutate in cases:
        d = dict(base, requests=[dict(r) for r in base["requests"]])
        mutate(d)
        with pytest.raises(ValueError) as got:
            wl.workload_from_dict(d)
        with pytest.raises(ValueError) as want:
            jwl.workload_from_dict(d)
        assert str(got.value) == str(want.value)


def test_admission_equals_reference():
    """One call sequence through both controllers: every grant, the
    history and the stats."""
    cfg = dict(rate=1.5, burst=3.0, read_capacity=6.0, floor=0.125, max_inflight=2)
    a, b = AdmissionController(AdmissionConfig(**cfg)), jadm.AdmissionController(
        jadm.AdmissionConfig(**cfg))
    loads = [0, 3, 9, 6, 0, 0, 12, 1, 5, 2]
    for t, load in enumerate(loads):
        assert a.begin_tick(load) == b.begin_tick(load)
        for i in range(5):
            kind, urgent = ("repair", i == 4 and t % 3 == 0) if i % 2 else ("archive", False)
            assert a.acquire(kind, urgent=urgent) == b.acquire(kind, urgent=urgent)
        assert a.background_level == b.background_level
    assert a.stats() == b.stats() and a.history == b.history
    for bad in (dict(rate=-1.0), dict(burst=0.0), dict(read_capacity=0.0), dict(floor=2.0),
                dict(max_inflight=0)):
        with pytest.raises(ValueError) as got:
            AdmissionConfig(**bad)
        with pytest.raises(ValueError) as want:
            jadm.AdmissionConfig(**bad)
        assert str(got.value) == str(want.value)


def test_simulate_serving_equals_reference():
    cfg = dataclasses.replace(ServingModelConfig(), ticks=120)
    jcfg = dataclasses.replace(jserv.ServingModelConfig(), ticks=120)
    assert simulate_serving(cfg) == jserv.simulate_serving(jcfg)
    lat = [0.3, 0.1, 0.2, 0.25, 1.5]
    assert percentiles(lat) == jserv.percentiles(lat)
    assert percentiles([]) == jserv.percentiles([])


def _pair(tmp_path, ticks, seed, admission, rate=5.0):
    """The same served cluster twice: the port on the CPU, the JAX package on
    its host route."""
    lcfg = dict(arrival_rate=0.7, block_bytes=128, archive_age=2, seed=seed)
    actl = dict(rate=2.0, burst=4.0, read_capacity=6.0, max_inflight=2)
    port = ServingEngine(ClusterLifecycle(
        str(tmp_path / "port"), arc.ArchiveConfig(n=N, k=K, l=16, num_chunks=4),
        LifecycleConfig(**lcfg), churn.bounded_trace(N, K, ticks, fail_rate=0.03, seed=seed),
        admission=AdmissionController(AdmissionConfig(**actl)) if admission else None,
        device="cpu"))
    ref = jserv.ServingEngine(jlife.ClusterLifecycle(
        str(tmp_path / "jax"), jarc.ArchiveConfig(n=N, k=K, l=16, num_chunks=4),
        jlife.LifecycleConfig(**lcfg, use_devices=False),
        jchurn.bounded_trace(N, K, ticks, fail_rate=0.03, seed=seed),
        admission=jadm.AdmissionController(jadm.AdmissionConfig(**actl)) if admission else None))
    wcfg = dict(req_rate=rate, catalog_ranks=8, read_bytes_min=32, read_bytes_max=256,
                seed=seed)
    return port, ref, wl.synthetic_workload(wl.WorkloadConfig(**wcfg), ticks), \
        jwl.synthetic_workload(jwl.WorkloadConfig(**wcfg), ticks)


@pytest.mark.parametrize("seed,admission", [(5, True), (2, False)])
def test_engine_report_equals_reference(tmp_path, seed, admission):
    """Reports, per-request records (tier, nodes' latency, bytes check) and
    lifecycle rows equal, with and without admission; the admission run
    serves degraded reads."""
    ticks = 24
    port, ref, trace, jtrace = _pair(tmp_path, ticks, seed, admission)
    rep = port.run(trace, ticks)
    assert rep == ref.run(jtrace, ticks)
    assert port.requests == ref.requests
    assert port.lc.metrics == ref.lc.metrics
    assert rep["wrong_bytes"] == 0 and rep["count"] > 0
    assert ("admission" in rep) == admission
    if admission:
        assert rep["served"]["degraded"] > 0
    assert port.client.device == "cpu"


# ---------------------------------------------------------------------------
# counterparts of tests/test_serving.py
# ---------------------------------------------------------------------------


def test_workload_roundtrip(tmp_path):
    trace = wl.synthetic_workload(wl.WorkloadConfig(req_rate=3.0, seed=7), 50)
    path = str(tmp_path / "wl.json")
    wl.save_workload(path, trace)
    assert wl.load_workload(path) == trace


def test_workload_deterministic():
    cfg = wl.WorkloadConfig(req_rate=5.0, seed=11)
    a = wl.synthetic_workload(cfg, 40)
    assert a == wl.synthetic_workload(cfg, 40)
    assert wl.synthetic_workload(dataclasses.replace(cfg, seed=12), 40) != a


def test_workload_zipf_skew():
    w = wl.zipf_weights(16, 1.1)
    assert w.sum() == pytest.approx(1.0)
    assert all(w[i] > w[i + 1] for i in range(15))
    trace = wl.synthetic_workload(wl.WorkloadConfig(req_rate=20.0, zipf_alpha=1.1, seed=0), 100)
    ranks = [r.rank for r in trace.requests]
    assert ranks.count(0) > 3 * ranks.count(15)


@pytest.mark.parametrize("mutate,err", [
    (lambda d: d.update(version=99), "version"),
    (lambda d: d.update(n_users=0), "n_users"),
    (lambda d: d["requests"][0].update(user=10 ** 9), "user"),
    (lambda d: d["requests"][0].update(tick=-1), "negative"),
    (lambda d: d["requests"][0].update(offset_frac=1.5), "offset_frac"),
    (lambda d: d["requests"][0].update(nbytes=0), "nbytes"),
    (lambda d: d["requests"][0].update(tick=10 ** 6), "backwards"),
])
def test_workload_validation(mutate, err):
    d = wl.synthetic_workload(wl.WorkloadConfig(req_rate=4.0), 20).to_dict()
    mutate(d)
    with pytest.raises(ValueError, match=err):
        wl.workload_from_dict(d)


def test_workload_config_validation():
    with pytest.raises(ValueError, match="req_rate"):
        wl.WorkloadConfig(req_rate=-1.0)
    with pytest.raises(ValueError, match="read_bytes"):
        wl.WorkloadConfig(read_bytes_min=100, read_bytes_max=10)
    with pytest.raises(ValueError, match="catalog_ranks"):
        wl.WorkloadConfig(catalog_ranks=0)


def test_admission_refill_scales_with_idle():
    ctrl = AdmissionController(AdmissionConfig(rate=4.0, burst=100.0, read_capacity=16.0,
                                               floor=0.125))
    assert ctrl.idle_fraction(0) == 1.0
    assert ctrl.idle_fraction(8) == 0.5
    assert ctrl.idle_fraction(16) == 0.125
    assert ctrl.idle_fraction(10 ** 6) == 0.125
    t0 = ctrl.tokens
    assert ctrl.begin_tick(0) == pytest.approx(t0 + 4.0)
    assert ctrl.begin_tick(8) == pytest.approx(t0 + 6.0)


def test_admission_burst_caps_banked_idleness():
    ctrl = AdmissionController(AdmissionConfig(rate=4.0, burst=6.0))
    for _ in range(10):
        ctrl.begin_tick(0)
    assert ctrl.tokens == 6.0


def test_admission_max_inflight_bounds_each_tick():
    ctrl = AdmissionController(AdmissionConfig(rate=10.0, burst=100.0, max_inflight=2))
    ctrl.begin_tick(0)
    assert [ctrl.acquire("archive") for _ in range(5)] == [True, True, False, False, False]
    assert ctrl.background_level == 2
    ctrl.begin_tick(0)
    assert ctrl.acquire("archive")


def test_admission_denies_when_starved_urgent_bypasses():
    ctrl = AdmissionController(AdmissionConfig(rate=1.0, burst=2.0, read_capacity=4.0,
                                               floor=0.0, max_inflight=1))
    ctrl.begin_tick(0)
    while ctrl.tokens >= 1.0:
        ctrl.begin_tick(4.0)
        ctrl.acquire("archive")
    ctrl.begin_tick(4.0)
    assert not ctrl.acquire("archive")
    assert ctrl.acquire("repair", urgent=True)
    assert ctrl.acquire("repair", urgent=True)
    s = ctrl.stats()
    assert s["denied"]["archive"] >= 1 and s["granted"]["repair"] == 2


def test_admission_validation():
    with pytest.raises(ValueError, match="burst"):
        AdmissionConfig(burst=0.0)
    with pytest.raises(ValueError, match="floor"):
        AdmissionConfig(floor=1.5)
    with pytest.raises(ValueError, match="max_inflight"):
        AdmissionConfig(max_inflight=0)
    with pytest.raises(ValueError, match="read_capacity"):
        AdmissionConfig(read_capacity=0.0)
    ctrl = AdmissionController()
    with pytest.raises(ValueError, match="foreground_load"):
        ctrl.begin_tick(-1.0)
    with pytest.raises(ValueError, match="cost"):
        ctrl.acquire("archive", cost=0.0)


def test_congestion_share_algebra():
    topo = topo_lib.Topology.uniform(4, nic_bw=100e6)
    assert topo_lib.with_background(topo, 0.0).nic_bw == topo.nic_bw
    half = topo_lib.with_background(topo, 1.0, base_flows=2.0)
    assert half.nic_bw[0] == pytest.approx(50e6)
    with pytest.raises(ValueError, match="bg_units"):
        topo_lib.with_background(topo, -1.0)
    assert topo_lib.hot_read_time(topo, 0, 1 << 20, bg_units=4) > \
        topo_lib.hot_read_time(topo, 0, 1 << 20)
    helpers = list(range(3))
    assert topo_lib.coded_read_time(topo, 0, helpers, 1 << 20, degraded=True) > \
        topo_lib.coded_read_time(topo, 0, helpers, 1 << 20)


def _model_cfg():
    return dataclasses.replace(ServingModelConfig(), ticks=120)


def test_model_inversion_admission_holds_2x_uncontrolled_breaks_it():
    m = simulate_serving(_model_cfg())
    assert m["admission"]["p99"] <= 2.0 * m["idle"]["p99"]
    assert m["uncontrolled"]["p99"] > 2.0 * m["idle"]["p99"]
    assert m["yield_gain"] > 1.0
    assert m["bg_granted_total"] > 0


def test_model_paired_and_deterministic():
    a = simulate_serving(_model_cfg())
    assert a == simulate_serving(_model_cfg())
    assert a["idle"]["served"] == a["uncontrolled"]["served"] == a["admission"]["served"]
    assert a["idle"]["count"] == a["admission"]["count"]


def _engine(root, ticks, seed=0, admission=True):
    acfg = arc.ArchiveConfig(n=N, k=K, l=16, num_chunks=4)
    lcfg = LifecycleConfig(arrival_rate=0.7, block_bytes=128, archive_age=2, seed=seed)
    trace = churn.bounded_trace(N, K, ticks, fail_rate=0.03, seed=seed)
    ctrl = AdmissionController(AdmissionConfig(rate=2.0, burst=4.0, read_capacity=6.0,
                                               max_inflight=2)) if admission else None
    return ServingEngine(ClusterLifecycle(str(root), acfg, lcfg, trace, admission=ctrl,
                                          device="cpu"))


def _trace(rate, seed, ticks):
    return wl.synthetic_workload(wl.WorkloadConfig(req_rate=rate, catalog_ranks=8,
                                                   read_bytes_min=32, read_bytes_max=256,
                                                   seed=seed), ticks)


def test_serving_soak_zero_wrong_bytes_under_churn(tmp_path):
    eng = _engine(tmp_path, 30, seed=3)
    trace = _trace(5.0, 3, 30)
    rep = eng.run(trace, 30)
    assert rep["wrong_bytes"] == 0
    assert rep["lifecycle"]["lost_objects"] == 0
    assert rep["count"] + rep["unresolved"] == len(trace.requests)
    assert rep["count"] > 0 and rep["served"]["hot"] > 0
    assert all(r["ok"] for r in eng.requests)
    eng.lc.verify_all()


def test_serving_admission_bounds_background_per_tick(tmp_path):
    eng = _engine(tmp_path, 30, seed=1)
    eng.run(_trace(6.0, 1, 30), 30)
    cap = eng.lc.admission.cfg.max_inflight
    rows = eng.lc.metrics
    assert all(r["bg_granted"] <= cap for r in rows)
    assert sum(r["bg_denied"] for r in rows) > 0
    assert sum(r["bg_granted"] + r["bg_urgent"] for r in rows) > 0


def test_serving_without_admission_is_pre_admission_engine(tmp_path):
    eng = _engine(tmp_path, 20, seed=2, admission=False)
    rep = eng.run(_trace(4.0, 2, 20), 20)
    assert rep["wrong_bytes"] == 0
    assert "admission" not in rep
    assert all("bg_granted" not in r for r in eng.lc.metrics)


def test_serving_degraded_reads_bitexact(tmp_path):
    eng = _engine(tmp_path, 30, seed=5)
    rep = eng.run(_trace(5.0, 5, 30), 30)
    assert rep["wrong_bytes"] == 0
    assert {r["served_from"] for r in eng.requests} <= {"hot", "coded", "degraded"}
    assert all(r["ok"] for r in eng.requests if r["served_from"] == "degraded")


@pytest.mark.parametrize("budget", [0, 1 << 40])
def test_payload_cache_bounded_and_transparent(tmp_path, monkeypatch, budget):
    """The engine's payload cache changes no response check: a budget of
    nothing keeps one payload, an ample one every step served."""
    from repro_torch.storage import serving
    monkeypatch.setattr(serving, "PAYLOAD_CACHE_BYTES", budget)
    eng = _engine(tmp_path, 16, seed=4)
    rep = eng.run(_trace(5.0, 4, 16), 16)
    assert rep["wrong_bytes"] == 0 and rep["count"] > 0
    served = {r["step"] for r in eng.requests}
    assert len(eng._payloads) == (1 if budget == 0 else len(served))


@pytest.mark.parametrize("fail_rate,heals", [(0.03, False), (0.05, True)])
def test_live_cluster_churn_heals_only_past_003(tmp_path, fail_rate, heals):
    """chip_smoke's phase-15 cluster at 4 KiB blocks: with read_capacity at
    the mean request rate the controller denies every routine repair, so at
    fail_rate 0.03 the seed-0 trace heals no shard and at 0.05 it does —
    why the phase runs at 0.05. Nothing is lost either way."""
    acfg = arc.ArchiveConfig(n=16, k=11, l=16, seed=0, num_chunks=8)
    lcfg = LifecycleConfig(arrival_rate=1.0, block_bytes=4096, archive_age=3, batch_max=4,
                           seed=0)
    ctrl = AdmissionController(AdmissionConfig(rate=2.0, burst=4.0, read_capacity=8,
                                               max_inflight=2))
    eng = ServingEngine(ClusterLifecycle(
        str(tmp_path), acfg, lcfg, churn.bounded_trace(16, 11, 24, fail_rate=fail_rate, seed=0),
        admission=ctrl, device="cpu"))
    rep = eng.run(wl.synthetic_workload(wl.WorkloadConfig(seed=0), 24), 24)
    assert (rep["lifecycle"]["total_repaired_shards"] > 0) == heals
    assert rep["lifecycle"]["lost_objects"] == 0 and rep["wrong_bytes"] == 0
    assert rep["admission"]["denied"]["repair"] > 0
