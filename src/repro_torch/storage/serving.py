"""Traffic-driven serving layer: temperature-routed reads with bounded p99.

The tentpole of the serving story. Two halves, one request vocabulary
(``repro_torch.storage.workload`` traces):

* :class:`ServingEngine` — the REAL read front end: owns a
  ``ClusterLifecycle`` cluster and serves every trace request through the
  :class:`repro_torch.storage.client.StorageClient` facade (and nothing else).
  Requests address objects by popularity rank; the engine resolves rank r
  to the r-th newest live object, so popular objects are the recent —
  still-replicated — ones and the temperature routing of the paper's
  archival story emerges from the lifecycle itself: hot replica read for
  young objects, k-fanin coded read for archived ones, degraded read
  (routing around missing shards) when churn has holes the scrubber has
  not healed yet. Every response is byte-verified against the object's
  seeded payload — the soak's zero-wrong-bytes property is end to end.

* :func:`simulate_serving` — the deterministic latency MODEL behind the
  benchmark's blocking SLO keys: one seeded request stream evaluated under
  three scenarios (idle cluster; uncontrolled background work; admission-
  controlled background work) with per-node FIFO queueing and service
  times from ``repro_torch.core.topology``'s congestion accounting. It prices
  the inversion of the netsim congestion result: uncontrolled background
  repair+archival inflates every NIC share (netsim's 1.95-4.8x) until the
  hottest replica holder's queue diverges and read p99 blows past 2x the
  idle cluster's, while the admission controller
  (``repro_torch.core.admission``) keeps at most a trickle of background work
  in flight during busy ticks and holds p99 inside the 2x bound — the
  ``model_serving_*`` acceptance gate.

Latencies in the real engine are modeled too (the container has no real
network): each served request is priced with the same topology functions,
with the background level taken from what the admission controller
actually granted that tick. Wall clocks never enter; everything replays
bit-identically from (trace, configs, seed).

The JAX package's ``repro.storage.serving`` on the port's lifecycle: the
engine's client runs on the lifecycle's ``device`` (a ``read_range`` with
``heal=True`` repairs there), while range reads decode the covering word
range on the host, as in the JAX package.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core import topology as topo_lib
from repro_torch.core.admission import AdmissionConfig, AdmissionController
from repro_torch.storage import workload as wl
from repro_torch.storage.client import StorageClient


#: host bytes of seeded payloads a ServingEngine keeps (every object of a
#: 24-tick soak of 176 MiB objects fits)
PAYLOAD_CACHE_BYTES = 8 << 30


def percentiles(latencies) -> dict:
    """p50/p99/p999 + mean over per-request latencies (seconds)."""
    lat = np.asarray(sorted(latencies), dtype=np.float64)
    if lat.size == 0:
        return {"count": 0, "p50": 0.0, "p99": 0.0, "p999": 0.0, "mean": 0.0}
    return {
        "count": int(lat.size),
        "p50": round(float(np.percentile(lat, 50.0)), 6),
        "p99": round(float(np.percentile(lat, 99.0)), 6),
        "p999": round(float(np.percentile(lat, 99.9)), 6),
        "mean": round(float(lat.mean()), 6),
    }


class _NodeQueues:
    """Per-node FIFO service queues (busy-until times, seconds)."""

    def __init__(self, n: int):
        self.busy_until = [0.0] * n

    def serve(self, node: int, arrival: float, service: float) -> float:
        """Enqueue one request; returns its latency (queue wait + service)."""
        start = max(arrival, self.busy_until[node])
        done = start + service
        self.busy_until[node] = done
        return done - arrival


# ---------------------------------------------------------------------------
# the deterministic paired latency model (blocking benchmark keys)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingModelConfig:
    """Constants of the paired idle/uncontrolled/admission simulation.

    ``bg_demand`` is the background work the cluster WANTS to run every
    tick (archival batches + repair groups — what a churning lifecycle
    engine generates); the uncontrolled scenario runs all of it, the
    admission scenario runs what the controller grants. ``hot_ranks``
    ranks are replica-tier (the newest objects), the rest are coded;
    ``degraded_frac`` of coded reads hit a shard hole and pay the replan
    penalty. ``nic_bw`` is deliberately modest — the model prices relative
    congestion, not absolute disks. ``base_flows`` is each NIC's
    foreground flow budget in the fair-share split (netsim's algebra).
    """
    n: int = 16
    k: int = 11
    ticks: int = 240
    tick_seconds: float = 1.0
    nic_bw: float = 25e6
    compute_rate: float = 200e6
    hot_ranks: int = 4
    degraded_frac: float = 0.08
    bg_demand: int = 6
    base_flows: float = 4.0
    seed: int = 0
    workload: wl.WorkloadConfig = dataclasses.field(
        default_factory=lambda: wl.WorkloadConfig(
            req_rate=8.0, zipf_alpha=1.1, catalog_ranks=16,
            read_bytes_min=512 << 10, read_bytes_max=4 << 20, seed=0))
    admission: AdmissionConfig = dataclasses.field(
        default_factory=lambda: AdmissionConfig(
            rate=1.0, burst=2.0, read_capacity=8.0, floor=0.125,
            max_inflight=1))

    def topology(self) -> topo_lib.Topology:
        return topo_lib.Topology.uniform(
            self.n, compute_rate=self.compute_rate, nic_bw=self.nic_bw)


def _scenario(cfg: ServingModelConfig, trace: wl.WorkloadTrace,
              bg_level) -> dict:
    """Run the request stream against per-tick background levels.

    ``bg_level(t) -> float`` is the only thing that differs between the
    scenarios; the request stream, the node routing, and the degraded
    coins are IDENTICAL (paired comparison — latency deltas are purely
    the background policy's doing).
    """
    topo = cfg.topology()
    queues = _NodeQueues(cfg.n)
    # degraded coins drawn once per request index from a dedicated rng, so
    # every scenario sees the same holes
    coin_rng = np.random.default_rng((cfg.seed, 0xD36))
    coins = coin_rng.random(len(trace.requests))
    by_tick = trace.by_tick()
    latencies: list[float] = []
    served = {"hot": 0, "coded": 0, "degraded": 0}
    for t in range(cfg.ticks):
        reqs = by_tick.get(t, [])
        bg = float(bg_level(t, len(reqs)))
        # congestion applied once per tick: every NIC keeps base_flows
        # foreground budget against the tick's background flows
        t_topo = topo_lib.with_background(topo, bg,
                                         base_flows=cfg.base_flows)
        for i, req in enumerate(reqs):
            arrival = (t + (i + 1) / (len(reqs) + 1)) * cfg.tick_seconds
            if req.rank < cfg.hot_ranks:
                # replica tier: the newest objects; one holder serves the
                # whole range (RapidRAID placement pins block j's replicas,
                # the model pins the object's traffic to one of them)
                node = req.rank % cfg.k
                service = topo_lib.hot_read_time(t_topo, node, req.nbytes)
                served["hot"] += 1
            else:
                node = req.user % cfg.n
                helpers = [(req.rank + j) % cfg.n for j in range(cfg.k)]
                degraded = coins[len(latencies)] < cfg.degraded_frac
                service = topo_lib.coded_read_time(
                    t_topo, node, helpers, req.nbytes, degraded=degraded)
                served["degraded" if degraded else "coded"] += 1
            latencies.append(queues.serve(node, arrival, service))
    return {**percentiles(latencies), "served": served}


def simulate_serving(cfg: ServingModelConfig | None = None) -> dict:
    """The paired three-scenario SLO comparison (deterministic).

    Returns per-scenario latency rows plus the two gate ratios:
    ``yield_gain`` = uncontrolled p99 / admission p99 (what yielding buys)
    and ``p99_over_idle`` per scenario (the 2x bound is asserted on the
    admission scenario; the uncontrolled one must BREAK it — otherwise
    the controller is solving a non-problem).
    """
    cfg = cfg or ServingModelConfig()
    trace = wl.synthetic_workload(cfg.workload, cfg.ticks)

    idle = _scenario(cfg, trace, lambda t, load: 0.0)
    uncontrolled = _scenario(cfg, trace, lambda t, load: cfg.bg_demand)

    ctrl = AdmissionController(cfg.admission)
    granted_bg: dict[int, int] = {}

    def admitted(t: int, load: int) -> float:
        if t not in granted_bg:
            ctrl.begin_tick(load)
            granted_bg[t] = sum(
                1 for _ in range(cfg.bg_demand)
                if ctrl.acquire("background"))
        return granted_bg[t]

    admission = _scenario(cfg, trace, admitted)

    out = {
        "config": {
            "n": cfg.n, "k": cfg.k, "ticks": cfg.ticks,
            "nic_bw": cfg.nic_bw, "bg_demand": cfg.bg_demand,
            "hot_ranks": cfg.hot_ranks,
            "degraded_frac": cfg.degraded_frac,
            "req_rate": cfg.workload.req_rate,
            "zipf_alpha": cfg.workload.zipf_alpha,
            "admission": dataclasses.asdict(cfg.admission),
        },
        "idle": idle,
        "uncontrolled": uncontrolled,
        "admission": admission,
        "bg_granted_total": int(sum(granted_bg.values())),
        "bg_demand_total": int(cfg.bg_demand * cfg.ticks),
    }
    if idle["p99"] > 0:
        out["p99_over_idle_uncontrolled"] = round(
            uncontrolled["p99"] / idle["p99"], 3)
        out["p99_over_idle_admission"] = round(
            admission["p99"] / idle["p99"], 3)
    if admission["p99"] > 0:
        out["yield_gain"] = round(uncontrolled["p99"] / admission["p99"], 3)
    return out


# ---------------------------------------------------------------------------
# the real engine: facade-only reads against a live lifecycle cluster
# ---------------------------------------------------------------------------


class ServingEngine:
    """Serve a workload trace against a churning ``ClusterLifecycle``.

    ``lifecycle`` must already carry the admission controller (or None for
    an uncontrolled run); the engine builds the facade itself — every byte
    it serves flows through :class:`StorageClient`, nothing reaches the
    archive free functions directly. Per :meth:`tick`:

    1. the tick's requests are counted as the foreground load and the
       lifecycle advances one tick under it (churn, arrivals, admission-
       throttled archival/scrub, reclaim);
    2. each request resolves its popularity rank to the rank-th newest
       live object and is served via ``client.read_range`` — whole path
       reported by the :class:`ReadResult` (hot / coded / degraded);
    3. the response is byte-verified against the object's seeded payload
       (``wrong_bytes`` MUST stay 0 — the soak gate);
    4. latency is modeled through the same topology congestion functions
       the simulation uses, with the background level the admission
       controller actually granted this tick (or the tick's background
       step count when uncontrolled).

    Requests whose rank exceeds the live catalog (cold start: nothing
    archived yet) are counted ``unresolved`` and skipped, not errors.
    """

    def __init__(self, lifecycle, topology: topo_lib.Topology | None = None,
                 tick_seconds: float = 1.0, base_flows: float = 4.0):
        self.lc = lifecycle
        self.client = StorageClient(lifecycle.store, lifecycle.acfg,
                                    device=lifecycle.device)
        self.topology = topology or topo_lib.Topology.uniform(
            lifecycle.acfg.n, nic_bw=25e6, compute_rate=200e6)
        self.tick_seconds = float(tick_seconds)
        self.base_flows = float(base_flows)
        self.queues = _NodeQueues(lifecycle.acfg.n)
        self.requests: list[dict] = []
        self.wrong_bytes = 0
        self.unresolved = 0
        # the seeded payloads responses are checked against, last used last
        self._payloads: collections.OrderedDict[int, np.ndarray] = \
            collections.OrderedDict()

    def _payload(self, step: int) -> np.ndarray:
        """The step's seeded payload as flat bytes (``lc._payload``), kept
        while the kept ones fit in ``PAYLOAD_CACHE_BYTES``: drawing one
        costs as much as the read it checks many times over at real object
        sizes, and popular ranks are the newest objects."""
        flat = self._payloads.pop(step, None)
        if flat is None:
            flat = self.lc._payload(step).reshape(-1)
        self._payloads[step] = flat
        while (len(self._payloads) > 1 and sum(
                p.nbytes for p in self._payloads.values()) > PAYLOAD_CACHE_BYTES):
            self._payloads.popitem(last=False)
        return flat

    def _live_steps(self) -> list[int]:
        """Live objects, newest first — rank r is ``live[r]``."""
        return sorted((s for s, st in self.lc.objects.items()
                       if st["state"] != "lost"), reverse=True)

    def _serve_one(self, req: wl.Request, arrival: float, bg: float) -> None:
        live = self._live_steps()
        if req.rank >= len(live):
            self.unresolved += 1
            return
        step = live[req.rank]
        obj_bytes = self.lc.acfg.k * self.lc.lcfg.block_bytes
        nbytes = min(req.nbytes, obj_bytes)
        offset = min(int(req.offset_frac * obj_bytes), obj_bytes - nbytes)
        res = self.client.read_range(step, offset, nbytes)
        want = self._payload(step)[offset:offset + nbytes]
        ok = res.data == want.tobytes()
        if not ok:
            self.wrong_bytes += 1
        t_topo = topo_lib.with_background(self.topology, bg,
                                          base_flows=self.base_flows)
        if res.served_from == "hot":
            node = res.nodes[0] if res.nodes else 0
            service = topo_lib.hot_read_time(t_topo, node, nbytes)
        else:
            node = req.user % self.lc.acfg.n
            helpers = res.nodes or tuple(range(self.lc.acfg.k))
            service = topo_lib.coded_read_time(
                t_topo, node, helpers, nbytes,
                degraded=res.served_from == "degraded")
        lat = self.queues.serve(node, arrival, service)
        self.requests.append({
            "tick": req.tick, "user": req.user, "rank": req.rank,
            "step": step, "served_from": res.served_from,
            "healed": res.healed, "nbytes": nbytes,
            "latency": round(lat, 6), "ok": ok,
        })

    def tick(self, reqs: list[wl.Request]) -> dict:
        row = self.lc.tick(foreground_load=len(reqs))
        if self.lc.admission is not None:
            bg = float(self.lc.admission.background_level)
        else:
            # uncontrolled: every background step that ran this tick is a
            # concurrent flow set on the serving path
            bg = float(row["archived"] + row["repaired_shards"])
        t = row["tick"]
        for i, req in enumerate(reqs):
            arrival = (t + (i + 1) / (len(reqs) + 1)) * self.tick_seconds
            self._serve_one(req, arrival, bg)
        return row

    def run(self, trace: wl.WorkloadTrace, ticks: int) -> dict:
        by_tick = trace.by_tick()
        for t in range(ticks):
            self.tick(by_tick.get(t, []))
        return self.report()

    def report(self) -> dict:
        served = {"hot": 0, "coded": 0, "degraded": 0}
        for r in self.requests:
            served[r["served_from"]] += 1
        out = {
            **percentiles([r["latency"] for r in self.requests]),
            "served": served,
            "wrong_bytes": self.wrong_bytes,
            "unresolved": self.unresolved,
            "healed_on_read": sum(1 for r in self.requests if r["healed"]),
            "lifecycle": self.lc.summary(),
        }
        if self.lc.admission is not None:
            out["admission"] = self.lc.admission.stats()
        return out
