"""Read workload traces: open-loop Poisson arrivals, Zipfian popularity.

The ROADMAP's north star is a cluster "serving heavy traffic from millions
of users"; this module is that traffic, in the same replayable-trace idiom
as ``repro_torch.core.churn``:

* **Traces** — a workload trace is an explicit list of read requests
  ``(tick, user, rank, offset_frac, nbytes)``, either drawn from a seeded
  stochastic process (``synthetic_workload``) or loaded from JSON
  (``save_workload`` / ``load_workload``) so production access logs can be
  replayed against the serving layer. Same trace => same requests, byte
  for byte — the paired idle/uncontrolled/admission comparison in
  ``repro_torch.storage.serving`` depends on it.

* **Open loop** — arrivals are Poisson per tick (an open system: users do
  not wait for earlier requests to finish before issuing more), the
  arrival process that actually produces heavy tails under overload.
  Closed-loop generators self-throttle and hide exactly the p99 collapse
  the admission controller exists to prevent.

* **Zipfian popularity** — users pick objects by popularity *rank* with
  ``P(rank r) ∝ 1 / r^alpha`` over the ``catalog_ranks`` most recent
  objects. Ranks, not step ids: the serving layer maps rank r to the r-th
  newest live object at serve time, so "popular = recent = hot tier"
  tracks the cluster as it archives — the paper's "replicas are maintained
  only for the latest data" made load-bearing.

Requests carry a fractional object offset (``offset_frac``) rather than a
byte offset because the trace is object-size agnostic: the serving layer
scales it by the object's actual byte length.

Host code over numpy, the JAX package's ``repro.storage.workload`` in the
same rng draw order: the same config gives the same trace in either package.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

WORKLOAD_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Request:
    tick: int
    user: int            # simulated user id in [0, n_users)
    rank: int            # popularity rank: 0 = most popular (= newest)
    offset_frac: float   # fractional start offset within the object [0, 1)
    nbytes: int          # bytes requested

    def to_dict(self) -> dict:
        return {"tick": int(self.tick), "user": int(self.user),
                "rank": int(self.rank),
                "offset_frac": float(self.offset_frac),
                "nbytes": int(self.nbytes)}


@dataclasses.dataclass(frozen=True)
class WorkloadTrace:
    """A replayable read-request history.

    ``n_users`` bounds the user id space; ``catalog_ranks`` bounds the
    popularity ranks (the serving layer resolves rank -> live object).
    """
    n_users: int
    catalog_ranks: int
    requests: tuple[Request, ...]
    meta: dict = dataclasses.field(default_factory=dict)

    def by_tick(self) -> dict[int, list[Request]]:
        out: dict[int, list[Request]] = {}
        for r in self.requests:
            out.setdefault(r.tick, []).append(r)
        return out

    def max_tick(self) -> int:
        return max((r.tick for r in self.requests), default=-1)

    def to_dict(self) -> dict:
        return {"version": WORKLOAD_VERSION, "n_users": int(self.n_users),
                "catalog_ranks": int(self.catalog_ranks),
                "meta": dict(self.meta),
                "requests": [r.to_dict() for r in self.requests]}


def workload_from_dict(d: dict) -> WorkloadTrace:
    """Parse + validate the JSON trace format (clear ValueError on damage)."""
    if not isinstance(d, dict):
        raise ValueError(f"workload trace must be a JSON object, got {type(d)}")
    if d.get("version") != WORKLOAD_VERSION:
        raise ValueError(
            f"unsupported workload trace version {d.get('version')!r} "
            f"(want {WORKLOAD_VERSION})")
    try:
        n_users = int(d["n_users"])
        catalog = int(d["catalog_ranks"])
        raw = d["requests"]
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"corrupt workload trace: {e!r}") from None
    if n_users < 1 or catalog < 1:
        raise ValueError(
            f"corrupt workload trace: n_users={n_users}, "
            f"catalog_ranks={catalog} must both be >= 1")
    requests = []
    for idx, r in enumerate(raw):
        try:
            req = Request(tick=int(r["tick"]), user=int(r["user"]),
                          rank=int(r["rank"]),
                          offset_frac=float(r["offset_frac"]),
                          nbytes=int(r["nbytes"]))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f"corrupt workload trace: request {idx} malformed "
                f"({e!r})") from None
        if req.tick < 0:
            raise ValueError(f"corrupt workload trace: request {idx} tick "
                             f"{req.tick} is negative")
        if not 0 <= req.user < n_users:
            raise ValueError(f"corrupt workload trace: request {idx} user "
                             f"{req.user} outside [0, {n_users})")
        if not 0 <= req.rank < catalog:
            raise ValueError(f"corrupt workload trace: request {idx} rank "
                             f"{req.rank} outside [0, {catalog})")
        if not 0.0 <= req.offset_frac < 1.0:
            raise ValueError(
                f"corrupt workload trace: request {idx} offset_frac "
                f"{req.offset_frac} outside [0, 1)")
        if req.nbytes < 1:
            raise ValueError(f"corrupt workload trace: request {idx} nbytes "
                             f"{req.nbytes} must be >= 1")
        if requests and req.tick < requests[-1].tick:
            raise ValueError(f"corrupt workload trace: request {idx} tick "
                             f"{req.tick} goes backwards")
        requests.append(req)
    return WorkloadTrace(n_users=n_users, catalog_ranks=catalog,
                         requests=tuple(requests),
                         meta=dict(d.get("meta", {})))


def save_workload(path: str, trace: WorkloadTrace) -> None:
    with open(path, "w") as f:
        json.dump(trace.to_dict(), f, indent=1)


def load_workload(path: str) -> WorkloadTrace:
    with open(path) as f:
        try:
            d = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"corrupt workload trace {path}: {e}") from None
    return workload_from_dict(d)


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Stochastic read-workload parameters.

    ``req_rate`` is the Poisson mean arrivals per tick (open loop);
    ``zipf_alpha`` the popularity skew (1.0-1.2 is web-like — a handful of
    hot objects take most of the traffic); ``catalog_ranks`` how many of
    the newest objects are ever requested; ``read_bytes_min/max`` the
    uniform per-request size range; ``n_users`` the simulated user
    population (millions — ids only cost trace bytes).
    """
    n_users: int = 2_000_000
    req_rate: float = 8.0
    zipf_alpha: float = 1.1
    catalog_ranks: int = 16
    read_bytes_min: int = 4 << 10
    read_bytes_max: int = 256 << 10
    seed: int = 0

    def __post_init__(self):
        if self.n_users < 1 or self.catalog_ranks < 1:
            raise ValueError(
                f"n_users ({self.n_users}) and catalog_ranks "
                f"({self.catalog_ranks}) must be >= 1")
        if self.req_rate < 0:
            raise ValueError(f"req_rate must be >= 0, got {self.req_rate}")
        if not 1 <= self.read_bytes_min <= self.read_bytes_max:
            raise ValueError(
                f"need 1 <= read_bytes_min <= read_bytes_max, got "
                f"[{self.read_bytes_min}, {self.read_bytes_max}]")


def zipf_weights(ranks: int, alpha: float) -> np.ndarray:
    """P(rank r) ∝ 1/(r+1)^alpha, normalized over ``ranks`` ranks."""
    if ranks < 1:
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    w = 1.0 / np.power(np.arange(1, ranks + 1, dtype=np.float64), alpha)
    return w / w.sum()


def synthetic_workload(cfg: WorkloadConfig, ticks: int) -> WorkloadTrace:
    """Draw a seeded trace from the open-loop Poisson/Zipf process.

    Pure function of ``(cfg, ticks)``: one rng drives arrival counts, user
    ids, ranks, offsets and sizes in a fixed draw order, so the trace —
    and everything downstream of it — replays bit-identically.
    """
    rng = np.random.default_rng(cfg.seed)
    weights = zipf_weights(cfg.catalog_ranks, cfg.zipf_alpha)
    requests: list[Request] = []
    for t in range(ticks):
        count = int(rng.poisson(cfg.req_rate))
        if count == 0:
            continue
        users = rng.integers(0, cfg.n_users, size=count)
        ranks = rng.choice(cfg.catalog_ranks, size=count, p=weights)
        fracs = rng.random(count)
        sizes = rng.integers(cfg.read_bytes_min, cfg.read_bytes_max + 1,
                             size=count)
        for i in range(count):
            requests.append(Request(
                tick=t, user=int(users[i]), rank=int(ranks[i]),
                offset_frac=float(fracs[i]), nbytes=int(sizes[i])))
    return WorkloadTrace(n_users=cfg.n_users,
                         catalog_ranks=cfg.catalog_ranks,
                         requests=tuple(requests),
                         meta={"config": dataclasses.asdict(cfg),
                               "ticks": int(ticks)})
