"""Node churn: seeded failure/rejoin traces + a Monte Carlo durability model.

The paper's operating scenario is a LIVE cluster: XORing Elephants
(Sathiamoorthy et al., PAPERS.md) measures a steady background of node
failures and rejoins in production HDFS clusters, which turns archival and
repair from one-shot verbs into a continuous workload. This module provides
the churn side of that scenario for ``repro_torch.storage.lifecycle``:

* **Traces** — a churn trace is an explicit, replayable list of
  ``(tick, op, node)`` events (``op`` in {"fail", "join"}). Traces are
  either generated from a seeded stochastic process (``synthetic_trace``)
  or loaded from a simple JSON format (``save_trace`` / ``load_trace``) so
  real incident logs can be replayed against the engine.

* **Bounded traces** — ``bounded_trace`` generates churn that never
  exceeds the code's repair capacity: at most ``n - k`` nodes are
  *unhealed* at once (down, or rejoined so recently the scrubber has not
  yet refilled them — ``heal_ticks``), and the two holders of any hot
  replica pair (``replica_pairs``) are never unhealed together. Under such
  a trace a lifecycle engine that scrubs every tick provably never drops
  below k live coded shards or one live replica, so a soak run must finish
  with zero lost objects — the testable form of the paper's "without
  compromising data reliability".

* **Durability** — ``monte_carlo_durability`` estimates object loss
  probability for 3-replication versus a RapidRAID (n, k) code under the
  SAME seeded (unbounded) node-failure process: a paired comparison of the
  two redundancy schemes, storage overhead 3.0x versus n/k, that
  reproduces the replication-vs-EC trade-off of Cook et al. (PAPERS.md).

Host code over numpy, the JAX package's ``repro.core.churn`` draw for draw:
the same seed gives the same trace and the same Monte Carlo result in
either package. ``_decodable_lookup`` asks the port's codes.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

TRACE_VERSION = 1
OPS = ("fail", "join")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    tick: int
    op: str          # "fail" | "join"
    node: int

    def to_dict(self) -> dict:
        return {"tick": int(self.tick), "op": self.op, "node": int(self.node)}


@dataclasses.dataclass(frozen=True)
class ChurnTrace:
    """A replayable churn history over an ``n_nodes`` cluster.

    Events are applied in list order; within one tick the generator emits
    joins before fails so a node slot freed by a rejoin can fail again the
    same tick only through an explicit event ordering.
    """
    n_nodes: int
    events: tuple[ChurnEvent, ...]
    meta: dict = dataclasses.field(default_factory=dict)

    def by_tick(self) -> dict[int, list[ChurnEvent]]:
        out: dict[int, list[ChurnEvent]] = {}
        for ev in self.events:
            out.setdefault(ev.tick, []).append(ev)
        return out

    def max_tick(self) -> int:
        return max((ev.tick for ev in self.events), default=-1)

    def to_dict(self) -> dict:
        return {"version": TRACE_VERSION, "n_nodes": int(self.n_nodes),
                "meta": dict(self.meta),
                "events": [ev.to_dict() for ev in self.events]}


def trace_from_dict(d: dict) -> ChurnTrace:
    """Parse + validate the JSON trace format (clear ValueError on damage)."""
    if not isinstance(d, dict):
        raise ValueError(f"churn trace must be a JSON object, got {type(d)}")
    if d.get("version") != TRACE_VERSION:
        raise ValueError(f"unsupported churn trace version {d.get('version')!r}"
                         f" (want {TRACE_VERSION})")
    try:
        n_nodes = int(d["n_nodes"])
        raw = d["events"]
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"corrupt churn trace: {e!r}") from None
    events = []
    down: set[int] = set()
    for idx, r in enumerate(raw):
        try:
            ev = ChurnEvent(tick=int(r["tick"]), op=str(r["op"]),
                            node=int(r["node"]))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f"corrupt churn trace: event {idx} malformed ({e!r})") from None
        if ev.op not in OPS:
            raise ValueError(f"corrupt churn trace: event {idx} op {ev.op!r} "
                             f"not in {OPS}")
        if not 0 <= ev.node < n_nodes:
            raise ValueError(f"corrupt churn trace: event {idx} node "
                             f"{ev.node} outside cluster of {n_nodes}")
        if events and ev.tick < events[-1].tick:
            raise ValueError(f"corrupt churn trace: event {idx} tick "
                             f"{ev.tick} goes backwards")
        if ev.op == "fail" and ev.node in down:
            raise ValueError(f"corrupt churn trace: event {idx} fails node "
                             f"{ev.node} which is already down")
        if ev.op == "join" and ev.node not in down:
            raise ValueError(f"corrupt churn trace: event {idx} joins node "
                             f"{ev.node} which is not down")
        (down.add if ev.op == "fail" else down.discard)(ev.node)
        events.append(ev)
    return ChurnTrace(n_nodes=n_nodes, events=tuple(events),
                      meta=dict(d.get("meta", {})))


def save_trace(path: str, trace: ChurnTrace) -> None:
    with open(path, "w") as f:
        json.dump(trace.to_dict(), f, indent=1)


def load_trace(path: str) -> ChurnTrace:
    with open(path) as f:
        try:
            d = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"corrupt churn trace {path}: {e}") from None
    return trace_from_dict(d)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Stochastic churn process parameters.

    ``fail_rate`` is the per-node per-tick failure probability; a failed
    node stays down for a uniform 1..2*mean_down_ticks ticks. ``max_down``
    caps how many nodes may be *unhealed* simultaneously (None = no cap);
    a rejoined node still counts as unhealed for ``heal_ticks`` ticks — the
    window the scrubber needs to refill it. ``protect`` lists node groups
    that must never be entirely unhealed at once (the hot replica pairs).
    """
    n_nodes: int
    fail_rate: float = 0.02
    mean_down_ticks: int = 4
    max_down: int | None = None
    heal_ticks: int = 1
    protect: tuple[tuple[int, ...], ...] = ()
    seed: int = 0


def synthetic_trace(cfg: ChurnConfig, ticks: int) -> ChurnTrace:
    """Draw a seeded trace from the bounded stochastic process."""
    rng = np.random.default_rng(cfg.seed)
    rejoin_at: dict[int, int] = {}        # node -> tick it rejoins
    dirty_until: dict[int, int] = {}      # node -> first tick it counts healed
    events: list[ChurnEvent] = []
    protect = [frozenset(g) for g in cfg.protect]
    for t in range(ticks):
        for node in sorted(rejoin_at):
            if rejoin_at[node] <= t:
                del rejoin_at[node]
                dirty_until[node] = t + cfg.heal_ticks
                events.append(ChurnEvent(tick=t, op="join", node=node))
        unhealed = set(rejoin_at) | {n for n, d in dirty_until.items() if d > t}
        # one vectorized draw per tick keeps the trace a pure function of
        # (seed, ticks) regardless of which nodes happen to be up
        coins = rng.random(cfg.n_nodes)
        for node in range(cfg.n_nodes):
            if node in rejoin_at or coins[node] >= cfg.fail_rate:
                continue
            would = unhealed | {node}
            if cfg.max_down is not None and len(would) > cfg.max_down:
                continue
            if any(g <= would for g in protect):
                continue
            down_for = int(rng.integers(1, 2 * cfg.mean_down_ticks + 1))
            rejoin_at[node] = t + down_for
            unhealed = would
            events.append(ChurnEvent(tick=t, op="fail", node=node))
    return ChurnTrace(n_nodes=cfg.n_nodes, events=tuple(events),
                      meta={"config": dataclasses.asdict(cfg),
                            "ticks": int(ticks)})


def replica_pairs(n: int, k: int) -> tuple[tuple[int, ...], ...]:
    """Node groups co-holding one hot block under the RapidRAID placement
    (replica 1 on 0..k-1, replica 2 on n-k..n-1): losing a whole group
    loses a not-yet-archived block, so bounded traces protect them."""
    from repro_torch.core import rapidraid
    place = rapidraid.placement(n, k)
    holders: dict[int, list[int]] = {}
    for node, held in enumerate(place):
        for j in held:
            holders.setdefault(j, []).append(node)
    return tuple(tuple(h) for h in holders.values())


def bounded_trace(n: int, k: int, ticks: int, fail_rate: float = 0.02,
                  mean_down_ticks: int = 4, heal_ticks: int = 1,
                  seed: int = 0) -> ChurnTrace:
    """Churn bounded by the code's repair capacity: at most n-k unhealed
    nodes at once, hot replica pairs never both unhealed — the trace class
    under which a per-tick-scrubbing lifecycle engine loses nothing."""
    cfg = ChurnConfig(n_nodes=n, fail_rate=fail_rate,
                      mean_down_ticks=mean_down_ticks, max_down=n - k,
                      heal_ticks=heal_ticks, protect=replica_pairs(n, k),
                      seed=seed)
    return synthetic_trace(cfg, ticks)


# ---------------------------------------------------------------------------
# Monte Carlo durability: 3-replication vs RapidRAID under the same churn
# ---------------------------------------------------------------------------


def monte_carlo_durability(n: int = 16, k: int = 11, replication: int = 3,
                           ticks: int = 600, trials: int = 1500,
                           fail_rate: float = 0.006, mean_down_ticks: int = 4,
                           repair_ticks: int = 2, seed: int = 0) -> dict:
    """Object-loss probability under UNBOUNDED seeded churn, paired schemes.

    One shared node-failure process per trial drives both schemes:

    * replication: ``replication`` copies on nodes 0..r-1; the object is
      lost when every copy is simultaneously missing;
    * RapidRAID (n, k): one coded shard per node; lost when fewer than k
      shards survive.

    A shard/copy dies when its node fails (disk wiped) and is restored
    ``repair_ticks`` after the failure — or at rejoin, whichever is later
    (repair-on-rejoin, the lifecycle engine's policy) — provided the scheme
    is still recoverable at that moment. Loss latches. Deterministic for a
    given seed; vectorized over trials. Returns loss probabilities plus the
    Laplace-smoothed ratio used as the benchmark's blocking model key.
    """
    if not 1 <= replication <= n:
        raise ValueError(f"replication {replication} outside 1..{n}")
    rng = np.random.default_rng(seed)
    down_until = np.zeros((trials, n), dtype=np.int64)       # node rejoin tick
    # per shard: restored at restore_at provided the scheme is recoverable
    missing_rr = np.zeros((trials, n), dtype=bool)
    restore_rr = np.zeros((trials, n), dtype=np.int64)
    missing_rep = np.zeros((trials, replication), dtype=bool)
    restore_rep = np.zeros((trials, replication), dtype=np.int64)
    lost_rr = np.zeros(trials, dtype=bool)
    lost_rep = np.zeros(trials, dtype=bool)
    for t in range(ticks):
        up = down_until <= t
        fails = up & (rng.random((trials, n)) < fail_rate)
        durs = rng.integers(1, 2 * mean_down_ticks + 1, size=(trials, n))
        down_until = np.where(fails, t + durs, down_until)
        restore = np.maximum(t + repair_ticks, down_until)
        # newly failed nodes wipe their shard/copy
        missing_rr |= fails
        restore_rr = np.where(fails, restore, restore_rr)
        fr = fails[:, :replication]
        missing_rep |= fr
        restore_rep = np.where(fr, restore[:, :replication], restore_rep)
        # repairs complete only while the scheme is still recoverable
        ok_rr = (~lost_rr) & ((~missing_rr).sum(axis=1) >= k)
        ok_rep = (~lost_rep) & ((~missing_rep).sum(axis=1) >= 1)
        missing_rr &= ~(ok_rr[:, None] & (restore_rr <= t))
        missing_rep &= ~(ok_rep[:, None] & (restore_rep <= t))
        lost_rr |= (~missing_rr).sum(axis=1) < k
        lost_rep |= (~missing_rep).sum(axis=1) < 1
    n_rr, n_rep = int(lost_rr.sum()), int(lost_rep.sum())
    return {
        "trials": trials, "ticks": ticks, "fail_rate": fail_rate,
        "repair_ticks": repair_ticks,
        "n": n, "k": k, "replication": replication,
        "overhead_replication": float(replication),
        "overhead_rapidraid": round(n / k, 4),
        "lost_replication": n_rep, "lost_rapidraid": n_rr,
        "p_loss_replication": round(n_rep / trials, 4),
        "p_loss_rapidraid": round(n_rr / trials, 4),
        # Laplace-smoothed so the ratio is finite and stable for the CI gate
        "durability_ratio": round((n_rep + 1) / (n_rr + 1), 3),
    }


# ---------------------------------------------------------------------------
# Monte Carlo code-family comparison: durability + repair traffic + storage
# ---------------------------------------------------------------------------


def _decodable_lookup(code, masks: np.ndarray,
                      cache: dict[int, bool]) -> np.ndarray:
    """Vectorized ``code.decodable`` over alive-set bitmasks.

    Rank checks are memoized per bitmask (at most 2^n of them, and a churn
    process visits only a tiny corner of that lattice), so the inner loop
    of the Monte Carlo never recomputes a GF rank.
    """
    out = np.empty(masks.shape, dtype=bool)
    for m in np.unique(masks):
        if m not in cache:
            cache[m] = code.decodable(
                [i for i in range(code.n) if (int(m) >> i) & 1])
        out[masks == m] = cache[m]
    return out


def monte_carlo_code_compare(families=("rapidraid", "lrc", "mbr"),
                             n: int = 8, k: int = 4, l: int = 16,
                             ticks: int = 400, trials: int = 400,
                             fail_rate: float = 0.01,
                             mean_down_ticks: int = 4,
                             repair_ticks: int = 2, seed: int = 0,
                             block_words: int = 1024) -> dict:
    """Paired comparison of code FAMILIES under one seeded failure process.

    Every family sees the identical per-trial node-failure sample (same
    rng draws), so differences are pure code geometry:

    * durability — an object is lost when the surviving node set is not
      decodable *for that family* (code-aware: LRC is not MDS, MBR
      tolerates any n-k losses);
    * repair traffic — each completed shard repair is charged the family's
      ``repair_transfer_words`` (LRC reads one local group, MBR pulls one
      beta sub-block from each of d helpers, RapidRAID reads k full
      shards), reported in units of the logical object (k*B words);
    * storage overhead — ``code.storage_overhead`` (MBR pays n*alpha/M_sub
      for its one-shard repairs).

    Repairs complete ``repair_ticks`` after the failure — or at rejoin,
    whichever is later — and only while the object is still decodable
    (repair-on-rejoin, the lifecycle engine's policy). Loss latches.
    Returns per-family rows plus cross-family ratios for the benchmark's
    blocking model keys.
    """
    from repro_torch.core import codes
    built = {fam: codes.make(fam, n, k, l=l, seed=seed) for fam in families}
    rng = np.random.default_rng(seed)
    # ONE failure sample shared by every family
    fail_coin = rng.random((ticks, trials, n))
    durs = rng.integers(1, 2 * mean_down_ticks + 1, size=(ticks, trials, n))
    out: dict[str, dict] = {}
    for fam, code in built.items():
        down_until = np.zeros((trials, n), dtype=np.int64)
        missing = np.zeros((trials, n), dtype=bool)
        restore = np.zeros((trials, n), dtype=np.int64)
        lost = np.zeros(trials, dtype=bool)
        repair_words = np.zeros(trials, dtype=np.float64)
        cache: dict[int, bool] = {}
        weights = 1 << np.arange(n, dtype=np.int64)
        per_repair = float(code.repair_transfer_words(block_words))
        for t in range(ticks):
            up = down_until <= t
            fails = up & (fail_coin[t] < fail_rate)
            down_until = np.where(fails, t + durs[t], down_until)
            missing |= fails
            restore = np.where(fails, np.maximum(t + repair_ticks,
                                                 down_until), restore)
            alive_mask = ((~missing) * weights).sum(axis=1)
            ok = (~lost) & _decodable_lookup(code, alive_mask, cache)
            done = ok[:, None] & missing & (restore <= t)
            repair_words += per_repair * done.sum(axis=1)
            missing &= ~done
            alive_mask = ((~missing) * weights).sum(axis=1)
            lost |= ~_decodable_lookup(code, alive_mask, cache)
        obj_words = k * block_words
        out[fam] = {
            "p_loss": round(float(lost.mean()), 4),
            "lost": int(lost.sum()),
            "storage_overhead": round(float(code.storage_overhead), 4),
            "repair_words_per_event": per_repair,
            "repair_traffic_objects": round(
                float(repair_words.mean()) / obj_words, 3),
            "max_tolerated_losses": int(code.max_tolerated_losses()),
        }
    result = {
        "families": list(families), "n": n, "k": k, "l": l,
        "ticks": ticks, "trials": trials, "fail_rate": fail_rate,
        "repair_ticks": repair_ticks, "block_words": block_words,
        "per_family": out,
    }
    if "rapidraid" in out:
        rr = out["rapidraid"]
        for fam in families:
            if fam == "rapidraid":
                continue
            # Laplace-smoothed, stable for CI gates (cf. durability_ratio)
            result[f"durability_ratio_{fam}"] = round(
                (rr["lost"] + 1) / (out[fam]["lost"] + 1), 3)
            result[f"repair_traffic_ratio_{fam}"] = round(
                rr["repair_traffic_objects"]
                / max(out[fam]["repair_traffic_objects"], 1e-9), 3)
    return result
