"""Admission control: background archival/repair yields to foreground reads.

The netsim congestion model (``benchmarks.netsim.churn_config``) prices what
an UNCONTROLLED cluster does: background repair chains share every NIC with
foreground work and slow it 1.95-4.8x. A serving cluster must run the same
background work — archival migration, scrub repair, reclaim — WITHOUT that
number landing on the read tail. This module is the inversion: a
token-bucket + priority admission controller that meters background work by
how loaded the foreground read path is, so read p99 stays bounded while
background work drains in the idle troughs.

Mechanics (all deterministic — no wall clock, so the serving simulation and
the real engine replay identically):

* **Token bucket** — background work units (one archival chain, one repair
  group) each cost one token. The bucket refills once per tick with
  ``rate * idle_fraction`` tokens, capped at ``burst``; ``idle_fraction``
  is how much of the cluster's read capacity (``read_capacity`` requests
  per tick) the tick's foreground load left unused. Heavy read traffic
  starves the refill down to ``floor`` (background never fully stops —
  a starved scrubber is a durability bug, not an SLO win), an idle tick
  refills at full rate and lets the backlog drain in bursts.
* **Priority bypass** — work flagged ``urgent`` (a repair whose object is
  within one further loss of undecodable) bypasses the bucket entirely:
  durability outranks the SLO. Ordinary background work queues behind the
  bucket and simply retries next tick; the lifecycle engine's backlog
  metrics make the deferral visible.
* **In-flight bound** — at most ``max_inflight`` background units are
  granted per tick regardless of accumulated tokens, so a long idle
  stretch cannot bank an unbounded burst that lands all at once.

``repro_torch.storage.lifecycle.ClusterLifecycle`` consumes the controller on its
migration and coded-scrub phases; ``repro_torch.storage.serving`` drives
``begin_tick`` from the workload's per-tick arrival count and feeds the
granted background level into the latency model
(``repro_torch.core.topology.with_background``).

Host code, the JAX package's ``repro.core.admission`` decision for decision.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Knobs of the background admission policy.

    ``rate``: tokens refilled per fully-idle tick. ``burst``: bucket
    capacity (caps banked idleness). ``read_capacity``: foreground
    requests/tick that count as full load — at or past it the refill
    drops to ``floor * rate``. ``floor``: the starvation floor in [0, 1]
    (background trickle under saturation). ``max_inflight``: hard cap on
    background units granted within one tick.
    """

    rate: float = 4.0
    burst: float = 8.0
    read_capacity: float = 16.0
    floor: float = 0.125
    max_inflight: int = 4

    def __post_init__(self):
        if self.rate < 0 or self.burst <= 0:
            raise ValueError(
                f"rate must be >= 0 and burst > 0, got rate={self.rate}, "
                f"burst={self.burst}")
        if self.read_capacity <= 0:
            raise ValueError(
                f"read_capacity must be > 0, got {self.read_capacity}")
        if not 0.0 <= self.floor <= 1.0:
            raise ValueError(f"floor must be in [0, 1], got {self.floor}")
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")


class AdmissionController:
    """Token-bucket / priority gate for background storage work.

    One instance is shared by everything that generates background work in
    a serving cluster; the serving layer calls :meth:`begin_tick` with the
    tick's foreground read count, then the lifecycle engine's phases call
    :meth:`acquire` per unit of background work.
    """

    def __init__(self, cfg: AdmissionConfig | None = None):
        self.cfg = cfg or AdmissionConfig()
        self.tokens = float(self.cfg.rate)     # one idle refill of headroom
        self.tick_granted = 0
        self.tick_urgent = 0
        self.tick_denied = 0
        self.granted: dict[str, int] = {}
        self.denied: dict[str, int] = {}
        self.history: list[dict] = []

    def idle_fraction(self, foreground_load: float) -> float:
        """Unused share of the read capacity, floored at ``cfg.floor``."""
        idle = 1.0 - float(foreground_load) / self.cfg.read_capacity
        return max(self.cfg.floor, min(1.0, idle))

    def begin_tick(self, foreground_load: float = 0.0) -> float:
        """Refill for a new tick; returns the tokens now available.

        ``foreground_load`` is the tick's foreground read count (or any
        load proxy in request units): the refill scales with the capacity
        those reads leave unused.
        """
        if foreground_load < 0:
            raise ValueError(
                f"foreground_load must be >= 0, got {foreground_load}")
        refill = self.cfg.rate * self.idle_fraction(foreground_load)
        self.tokens = min(self.cfg.burst, self.tokens + refill)
        self.tick_granted = 0
        self.tick_urgent = 0
        self.tick_denied = 0
        self.history.append({"load": float(foreground_load),
                             "refill": round(refill, 6),
                             "tokens": round(self.tokens, 6)})
        return self.tokens

    def acquire(self, kind: str, cost: float = 1.0,
                urgent: bool = False) -> bool:
        """Request one unit of background work; True = admitted now.

        ``urgent`` bypasses both the bucket and the in-flight bound (a
        repair racing undecodability must never wait on an SLO knob); it
        is accounted separately so the soak metrics show how often the
        bypass fired. A denied unit is NOT queued here — the caller keeps
        its own backlog and retries next tick.
        """
        if cost <= 0:
            raise ValueError(f"cost must be > 0, got {cost}")
        if urgent:
            self.tick_urgent += 1
            self.granted[kind] = self.granted.get(kind, 0) + 1
            return True
        if (self.tick_granted + 1 > self.cfg.max_inflight
                or self.tokens < cost):
            self.tick_denied += 1
            self.denied[kind] = self.denied.get(kind, 0) + 1
            return False
        self.tokens -= cost
        self.tick_granted += 1
        self.granted[kind] = self.granted.get(kind, 0) + 1
        return True

    @property
    def background_level(self) -> int:
        """Background units running this tick (granted + urgent) — what the
        latency model charges congestion for."""
        return self.tick_granted + self.tick_urgent

    def stats(self) -> dict:
        return {
            "granted": dict(self.granted),
            "denied": dict(self.denied),
            "tokens": round(self.tokens, 6),
            "ticks": len(self.history),
        }
