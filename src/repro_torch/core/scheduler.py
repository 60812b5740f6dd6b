"""Heterogeneity-aware archival scheduler (chain placement + chunking).

Three decisions, all searched against the ``repro_torch.core.topology`` makespan
model:

1. **Chain placement** (``plan_chain``): which node plays which chain
   position. Positions are not symmetric — ends carry one flow and (for
   n <= 2k-1 interiors) one replica block, the middle ``2k-n`` positions
   carry two blocks and two flows — so a slow node parked in the middle
   drags every tick. Exhaustive search for n <= 8 (provably optimal under
   the model); beyond that, a slowest-node-last greedy seed (slowest nodes
   onto the cheapest positions, i.e. the chain ends) polished by pairwise-
   swap hill climbing.
2. **Adaptive chunk count** (``best_num_chunks``): the paper's buffer-
   granularity knob. More chunks shrink the pipeline fill (tau_block ->
   tau_buf) but pay per-tick overhead; the analytic optimum is
   ``C* = sqrt((fill_cost - steady_cost) / tick_overhead)`` and
   ``best_num_chunks`` picks the best feasible candidate by model.
3. **Multi-object assignment** (``plan_many``): B concurrent chains are
   bin-packed onto DISJOINT node sets when the cluster has at least two
   chains' worth of nodes (no shared NICs at all), else staggered onto one
   shared chain (the ``repro_torch.storage.multi`` scheduler).

``repro_torch.storage.archive`` consumes these plans and records them in the
manifest, so decode and repair replay the same placement.

Host logic only: the JAX package's ``repro.core.scheduler`` copied as it
is, so both packages choose the same plans and write the same manifests.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from repro_torch.core import codes
from repro_torch.core import topology as topo_lib
from repro_torch.core.topology import Topology

# powers of two: every block length the storage layer produces (whole-lane
# padded) divides cleanly after at most a few halvings
DEFAULT_CHUNK_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """One object's chain schedule: node ``order[p]`` plays position p."""

    order: tuple[int, ...]
    num_chunks: int
    makespan: float

    def to_manifest(self) -> dict:
        return {"order": [int(i) for i in self.order],
                "num_chunks": int(self.num_chunks),
                "makespan_s": float(self.makespan)}


@dataclasses.dataclass(frozen=True)
class MultiPlan:
    """B objects onto g chains: object b runs on ``plans[assignment[b]]``."""

    plans: tuple[ChainPlan, ...]
    assignment: tuple[int, ...]
    stagger: int = 1


def analytic_num_chunks(topo: Topology, order, k: int,
                        block_bytes: float) -> float:
    """Closed-form optimum of the makespan over a continuous chunk count.

    T(C) = fill/C + steady*(1 - 1/C) + C*t0 + const, so
    dT/dC = -(fill - steady)/C^2 + t0 = 0 at
    C* = sqrt((fill - steady) / t0), where ``fill`` is the whole block's
    one-pass cost down the chain and ``steady`` the whole block's cost at
    the slowest stage. With zero tick overhead the optimum is unbounded
    (finer chunks only shrink the fill).
    """
    order = list(order)
    n = len(order)
    t_comp, t_link = topo_lib.chain_taus(topo, order, k, block_bytes)
    fill = sum(t_comp) + sum(t_link)
    steady = max(t_comp[p] + (t_link[p] if p < n - 1 else 0.0)
                 for p in range(n))
    if topo.tick_overhead <= 0:
        return math.inf
    return math.sqrt(max(fill - steady, 0.0) / topo.tick_overhead)


def best_num_chunks(topo: Topology, order, k: int, block_bytes: float,
                    candidates=DEFAULT_CHUNK_CANDIDATES) -> tuple[int, float]:
    """(chunk count, makespan) minimizing the model over the candidates."""
    best = min(candidates,
               key=lambda c: topo_lib.chain_makespan(topo, order, k,
                                                     block_bytes, c))
    return best, topo_lib.chain_makespan(topo, order, k, block_bytes, best)


def _greedy_order(topo: Topology, nodes, k: int) -> list[int]:
    """Slowest-node-last seed: costliest nodes onto the cheapest positions.

    Position weight = blocks carried + flows carried (ends: 1 block 1 flow;
    2k-n middles: 2 blocks 2 flows). Sort positions cheap-first, nodes
    slow-first, and pair them off — the slowest node lands on a chain end.
    """
    nodes = list(nodes)
    n = len(nodes)
    blocks = topo_lib.position_blocks(n, k)
    weight = [blocks[p] + (1 if p in (0, n - 1) else 2) for p in range(n)]
    # cheap positions first; ties broken outside-in so ends fill first
    positions = sorted(range(n), key=lambda p: (weight[p], min(p, n - 1 - p)))
    by_cost = sorted(nodes, key=lambda i: topo_lib.node_cost(topo, i),
                     reverse=True)                       # slowest first
    order = [0] * n
    for pos, node in zip(positions, by_cost):
        order[pos] = node
    return order


def _exhaustive_order(topo: Topology, nodes, k: int, block_bytes: float,
                      num_chunks: int) -> list[int]:
    """argmin of ``chain_makespan`` over ALL placements, vectorized.

    Evaluates the model for every permutation in one numpy pass (n = 8 is
    40320 rows — milliseconds), bit-identical to the scalar model.
    """
    nodes = list(nodes)
    n = len(nodes)
    perms = np.array(list(itertools.permutations(nodes)))          # (P, n)
    cr = np.asarray(topo.compute_rate, dtype=float)
    bw = np.asarray(topo.nic_bw, dtype=float)
    blocks = np.asarray(topo_lib.position_blocks(n, k), dtype=float)
    chunk = block_bytes / num_chunks
    comp = blocks[None, :] * (chunk / cr[perms]
                              + topo.tick_quad * chunk * chunk)    # (P, n)
    pos = np.arange(n)
    flows = np.where((pos == 0) | (pos == n - 1), 1.0, 2.0)
    share = bw[perms] / flows[None, :]
    link = chunk / np.minimum(share[:, :-1], share[:, 1:])         # (P, n-1)
    fill = comp.sum(1) + link.sum(1) + (n - 1) * topo.hop_latency
    stage = comp.copy()
    stage[:, :-1] += link
    total = (fill + (num_chunks - 1) * stage.max(1)
             + (num_chunks + n - 1) * topo.tick_overhead)
    return [int(i) for i in perms[int(np.argmin(total))]]


def _swap_polish(topo: Topology, order, k: int, block_bytes: float,
                 num_chunks: int, max_rounds: int = 8) -> list[int]:
    """Pairwise-swap hill climbing on the makespan model."""
    order = list(order)
    n = len(order)
    best = topo_lib.chain_makespan(topo, order, k, block_bytes, num_chunks)
    for _ in range(max_rounds):
        improved = False
        for a in range(n):
            for b in range(a + 1, n):
                order[a], order[b] = order[b], order[a]
                t = topo_lib.chain_makespan(topo, order, k, block_bytes,
                                            num_chunks)
                if t < best - 1e-12:
                    best = t
                    improved = True
                else:
                    order[a], order[b] = order[b], order[a]
        if not improved:
            break
    return order


def plan_chain(topo: Topology | None, k: int, block_bytes: float, *,
               nodes=None, n: int | None = None, exhaustive_limit: int = 8,
               candidates=DEFAULT_CHUNK_CANDIDATES) -> ChainPlan:
    """Choose chain placement + chunk count minimizing modeled makespan.

    ``nodes`` (default: every topology node) are the node ids to place; its
    length is the chain length n. Exhaustive permutation search for
    n <= ``exhaustive_limit``, greedy + swap-polish beyond. The chunk count
    is co-optimized: chosen for the seed ordering, the placement searched at
    that count, then re-chosen for the winning placement.

    ``topo=None`` plans against the MEASURED topology: the autotuner's
    calibrated ``compute_rate``/``tick_overhead`` for this backend
    (``repro_torch.core.autotune.calibrated_topology``; hand-tuned uniform
    defaults when no calibration has been recorded). Since a calibrated
    topology has no node count of its own, pass ``n`` (or ``nodes``).
    """
    if topo is None:
        if n is None and nodes is None:
            raise ValueError("plan_chain: topo=None needs n= or nodes=")
        from repro_torch.core import autotune
        topo = autotune.calibrated_topology(n if n is not None
                                            else len(list(nodes)))
    nodes = list(range(topo.n_nodes)) if nodes is None else list(nodes)
    n = len(nodes)
    if n < 2:
        raise ValueError(f"a chain needs >= 2 nodes, got {n}")
    c0, _ = best_num_chunks(topo, nodes, k, block_bytes, candidates)
    if n <= exhaustive_limit:
        order = _exhaustive_order(topo, nodes, k, block_bytes, c0)
    else:
        order = _greedy_order(topo, nodes, k)
        order = _swap_polish(topo, order, k, block_bytes, c0)
    num_chunks, makespan = best_num_chunks(topo, order, k, block_bytes,
                                           candidates)
    return ChainPlan(order=tuple(int(i) for i in order),
                     num_chunks=int(num_chunks), makespan=float(makespan))


def _balanced_groups(topo: Topology, n: int, n_groups: int) -> list[list[int]]:
    """Partition the nodes into ``n_groups`` chains of n nodes each, snake-
    drafted by node cost so no group gets all the slow nodes."""
    by_cost = sorted(range(topo.n_nodes),
                     key=lambda i: topo_lib.node_cost(topo, i))
    groups: list[list[int]] = [[] for _ in range(n_groups)]
    it = iter(by_cost)
    for rnd in range(n):
        seq = range(n_groups) if rnd % 2 == 0 else range(n_groups - 1, -1, -1)
        for g in seq:
            node = next(it, None)
            if node is not None:
                groups[g].append(node)
    return [grp for grp in groups if len(grp) == n]


def plan_many(topo: Topology | None, n_objects: int, n: int, k: int,
              block_bytes: float, *, stagger: int = 1,
              candidates=DEFAULT_CHUNK_CANDIDATES) -> MultiPlan:
    """Assign B concurrent archival chains to node sets.

    With >= 2n nodes the cluster supports disjoint chains: nodes are
    snake-drafted into ``n_nodes // n`` balanced groups, each group gets its
    own ``plan_chain``, and objects are dealt to groups by shortest modeled
    finish time (bin-packing on the makespan). Otherwise every object runs
    on the one shared chain, staggered (``repro_torch.storage.multi``).
    ``topo=None`` plans against the autotuner's calibrated topology for an
    n-node chain (as in ``plan_chain``).
    """
    if topo is None:
        from repro_torch.core import autotune
        topo = autotune.calibrated_topology(n)
    n_groups = max(1, topo.n_nodes // n)
    if n_groups >= 2:
        groups = _balanced_groups(topo, n, n_groups)
    else:
        if topo.n_nodes < n:
            raise ValueError(
                f"chain needs {n} nodes, topology has {topo.n_nodes}")
        # one chain: run it on the n cheapest nodes (matches archive_step's
        # single-chain node selection), letting any surplus slow nodes idle
        by_cost = sorted(range(topo.n_nodes),
                         key=lambda i: topo_lib.node_cost(topo, i))
        groups = [sorted(by_cost[:n])]
    plans = [plan_chain(topo, k, block_bytes, nodes=grp,
                        candidates=candidates) for grp in groups]
    # deal objects to the chain with the least accumulated modeled work
    load = [0.0] * len(plans)
    assignment = []
    for _ in range(n_objects):
        g = int(np.argmin([load[i] + plans[i].makespan
                           for i in range(len(plans))]))
        assignment.append(g)
        load[g] += plans[g].makespan
    return MultiPlan(plans=tuple(plans), assignment=tuple(assignment),
                     stagger=int(stagger))


# ---------------------------------------------------------------------------
# Temperature-aware code selection (which FAMILY, next to which placement)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CodePolicy:
    """Pick the erasure-code family by object temperature.

    Warm objects (recently written, still likely to be read or to lose a
    shard while the cluster churns) archive into a code with cheap partial
    repair — LRC reads only its local group to heal one shard. Cold objects
    (aged past ``cold_age`` ticks before the migrator got to them) archive
    into RapidRAID: the pipelined chain encode is the cheapest way to get
    them coded, and their repairs are rare enough that full-k repair reads
    are acceptable. The lifecycle engine consults this policy per object at
    migration time; both families share the archive data plane, manifests,
    and jit cache (keyed by ``CodeSpec``), so a mixed-temperature cluster
    runs one engine.
    """
    hot_family: str = "lrc"
    cold_family: str = "rapidraid"
    cold_age: int = 8     # ticks since birth at which an object is cold

    def __post_init__(self):
        for fam in (self.hot_family, self.cold_family):
            if fam not in codes.families():
                raise ValueError(
                    f"unknown code family {fam!r}; registered families: "
                    f"{', '.join(codes.families())}")
        if self.cold_age < 0:
            raise ValueError(f"cold_age must be >= 0, got {self.cold_age}")

    def family_for(self, age: int) -> str:
        """Family for an object that is ``age`` ticks old at archive time."""
        return self.cold_family if age >= self.cold_age else self.hot_family
