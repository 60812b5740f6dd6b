"""Cluster topology model for heterogeneity-aware archival scheduling.

The paper's EC2 experiments (§V) show pipelined archival running at the pace
of the SLOWEST node/link in the chain: Eq. (2)'s T = tau_block + (n-1)
tau_buf assumes identical nodes, and on a heterogeneous cluster the steady
state degrades to ``num_chunks * max_hop(tau_hop)``. This module models
that: per-node GF-combine compute rate, per-node NIC bandwidth, and a
makespan predictor for an arbitrary chain *placement* (which node plays
which chain position) at an arbitrary chunk granularity. The scheduler
(``repro_torch.core.scheduler``) searches placements/chunk counts against this
model; the JAX package's ``benchmarks/netsim.py`` carries the same per-hop
algebra inside its max-min-fair fluid simulator, so a schedule chosen here
transfers.

Rates are configured (ops config / JSON) or measured: ``measure_compute_rates``
is a calibration micro-benchmark timing the port's packed GF combine (the
static-coefficient ``gf_encode`` kernel on a card, its plain version on the
CPU) on every device.

Everything but the calibration is the JAX package's host model
(``repro.core.topology``), copied as it is, so both packages plan the same
chains from the same topology.

Chain cost model (mirrors the runtime in ``repro_torch.core.pipeline`` and the
fluid model in the JAX package's ``benchmarks/netsim.py``):

* chain position p processes ``blocks(p)`` replica blocks per chunk
  (ends hold 1 block, the middle ``2k-n`` positions hold 2 — RapidRAID's
  overlapped placement), so per-chunk compute at p is
  ``blocks(p) * chunk_bytes / compute_rate[node]``;
* the link p -> p+1 runs at the NIC share of its slower endpoint — interior
  nodes split their NIC over an in- and an out-flow, chain ends carry one
  flow (exactly netsim's ``nic_share``);
* a tick (one chunk through every stage) costs the slowest stage's
  compute + forward time; the pipeline fill costs the sum along the chain;
* every tick additionally pays ``tick_overhead`` (per-message/launch cost —
  the term that makes chunk count a real trade-off: more chunks shrink the
  fill but pay more per-tick overhead).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Per-node rates of a storage cluster.

    ``compute_rate[i]``: bytes/s node i sustains for the per-chunk GF
    combine (Eq. 3/4 work). ``nic_bw[i]``: bytes/s total NIC capacity of
    node i (full-duplex pool; shared by the node's concurrent chain flows).
    ``hop_latency``: seconds per chain hop (propagation, paid in the fill).
    ``tick_overhead``: seconds of fixed per-tick cost (message/launch/sync).
    ``tick_quad``: seconds per byte^2 of per-tick working set — models the
    compute bandwidth degrading once a tick's chunk overflows the cache
    hierarchy (a host property, uniform across nodes; 0 = the ideal
    linear-bandwidth model).
    """

    compute_rate: tuple[float, ...]
    nic_bw: tuple[float, ...]
    hop_latency: float = 0.2e-3
    tick_overhead: float = 0.0
    tick_quad: float = 0.0

    def __post_init__(self):
        if len(self.compute_rate) != len(self.nic_bw):
            raise ValueError(
                f"compute_rate ({len(self.compute_rate)}) and nic_bw "
                f"({len(self.nic_bw)}) must describe the same nodes")
        if any(r <= 0 for r in self.compute_rate + self.nic_bw):
            raise ValueError("rates must be positive")

    @property
    def n_nodes(self) -> int:
        return len(self.compute_rate)

    @classmethod
    def uniform(cls, n: int, compute_rate: float = 400e6,
                nic_bw: float = 250e6, hop_latency: float = 0.2e-3,
                tick_overhead: float = 0.0,
                tick_quad: float = 0.0) -> "Topology":
        return cls(compute_rate=(float(compute_rate),) * n,
                   nic_bw=(float(nic_bw),) * n,
                   hop_latency=hop_latency, tick_overhead=tick_overhead,
                   tick_quad=tick_quad)

    def with_slow(self, node: int, factor: float) -> "Topology":
        """A copy with node ``node`` slowed by ``factor`` (compute and NIC)."""
        cr = list(self.compute_rate)
        bw = list(self.nic_bw)
        cr[node] /= factor
        bw[node] /= factor
        return dataclasses.replace(self, compute_rate=tuple(cr),
                                   nic_bw=tuple(bw))

    def to_dict(self) -> dict:
        return {"compute_rate": list(self.compute_rate),
                "nic_bw": list(self.nic_bw),
                "hop_latency": self.hop_latency,
                "tick_overhead": self.tick_overhead,
                "tick_quad": self.tick_quad}

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        return cls(compute_rate=tuple(float(v) for v in d["compute_rate"]),
                   nic_bw=tuple(float(v) for v in d["nic_bw"]),
                   hop_latency=float(d.get("hop_latency", 0.2e-3)),
                   tick_overhead=float(d.get("tick_overhead", 0.0)),
                   tick_quad=float(d.get("tick_quad", 0.0)))


def position_blocks(n: int, k: int) -> list[int]:
    """Replica blocks held at each chain position (RapidRAID placement):
    position p holds block p (p < k) plus block p-(n-k) (p >= n-k)."""
    if not k <= n <= 2 * k:
        raise ValueError(f"need k <= n <= 2k, got (n={n}, k={k})")
    return [(1 if p < k else 0) + (1 if p >= n - k else 0) for p in range(n)]


def _nic_share(topo: Topology, order, pos: int, n: int) -> float:
    """NIC bytes/s available to ONE chain flow at position ``pos``: interior
    positions split the NIC between their in- and out-flow."""
    flows = 1 if pos in (0, n - 1) else 2
    return topo.nic_bw[int(order[pos])] / flows


def chain_taus(topo: Topology, order, k: int,
               chunk_bytes: float) -> tuple[list[float], list[float]]:
    """(per-position compute seconds, per-link forward seconds) per chunk."""
    order = list(order)
    n = len(order)
    blocks = position_blocks(n, k)
    t_comp = [blocks[p] * (chunk_bytes / topo.compute_rate[int(order[p])]
                           + topo.tick_quad * chunk_bytes * chunk_bytes)
              for p in range(n)]
    t_link = [chunk_bytes / min(_nic_share(topo, order, p, n),
                                _nic_share(topo, order, p + 1, n))
              for p in range(n - 1)]
    return t_comp, t_link


def chain_makespan(topo: Topology, order, k: int, block_bytes: float,
                   num_chunks: int) -> float:
    """Modeled seconds to archive one object through chain ``order``.

    T = fill + steady + overhead: the first chunk pays every stage in
    sequence (fill), the remaining ``num_chunks - 1`` chunks drain at the
    slowest stage's pace (steady — the heterogeneous generalization of
    Eq. (2)'s tau_buf term), and every one of the ``num_chunks + n - 1``
    ticks pays the fixed per-tick overhead.
    """
    order = list(order)
    n = len(order)
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    chunk = block_bytes / num_chunks
    t_comp, t_link = chain_taus(topo, order, k, chunk)
    fill = sum(t_comp) + sum(t_link) + (n - 1) * topo.hop_latency
    per_tick = max(t_comp[p] + (t_link[p] if p < n - 1 else 0.0)
                   for p in range(n))
    steady = (num_chunks - 1) * per_tick
    overhead = (num_chunks + n - 1) * topo.tick_overhead
    return fill + steady + overhead


def node_cost(topo: Topology, i: int) -> float:
    """Per-byte chain cost of node i (compute + wire): the 'slowness' key
    the scheduler sorts on."""
    return 1.0 / topo.compute_rate[i] + 1.0 / topo.nic_bw[i]


# ---------------------------------------------------------------------------
# serving-path congestion accounting (netsim's background-flow algebra)
# ---------------------------------------------------------------------------

#: NIC flows one background work unit (an archival chain hop or a repair
#: chain hop crossing a node) adds to every node it touches — matches
#: ``benchmarks.netsim.churn_config``'s per-repair extra-flow accounting.
FLOWS_PER_BACKGROUND_UNIT = 2.0


def with_background(topo: Topology, bg_units: float,
                    base_flows: float = 1.0) -> Topology:
    """Topology as a foreground read sees it with background work running.

    Mirrors ``benchmarks.netsim.churn_config``: each of ``bg_units``
    concurrent background work units (archival chains, repair chains)
    adds :data:`FLOWS_PER_BACKGROUND_UNIT` flows to every NIC that a
    foreground flow must share fairly with, shrinking the foreground
    share from ``nic_bw / base_flows`` to
    ``nic_bw * base_flows / (base_flows + extra)``. ``bg_units=0``
    returns the topology unchanged; this is the 1.95-4.8x netsim
    congestion result expressed as a read-path price.
    """
    if bg_units < 0:
        raise ValueError(f"bg_units must be >= 0, got {bg_units}")
    if bg_units == 0:
        return topo
    extra = FLOWS_PER_BACKGROUND_UNIT * float(bg_units)
    share = base_flows / (base_flows + extra)
    return dataclasses.replace(
        topo, nic_bw=tuple(bw * share for bw in topo.nic_bw))


def hot_read_time(topo: Topology, holder: int, nbytes: float,
                  bg_units: float = 0.0) -> float:
    """Modeled seconds to read ``nbytes`` from a hot replica on ``holder``.

    One flow, one hop: the replica holder streams the bytes at its
    (possibly congested) NIC share, plus one hop of propagation.
    """
    t = with_background(topo, bg_units)
    return nbytes / t.nic_bw[int(holder)] + t.hop_latency


def coded_read_time(topo: Topology, reader: int, helpers, nbytes: float,
                    bg_units: float = 0.0, degraded: bool = False,
                    replan_penalty: float = 2.0e-3) -> float:
    """Modeled seconds for a k-fanin coded read of ``nbytes`` of payload.

    The RapidRAID code is non-systematic, so EVERY archive-tier read
    pulls a word-range from all ``k`` helper shards (``k * nbytes / k``
    = ``nbytes`` of wire per helper fan-in is wrong — each helper sends
    ``nbytes / k`` of its shard, but all k flows converge on the
    reader's NIC, so the reader-side fan-in carries ``nbytes`` total)
    and decodes with the cached inverse program. Cost: the slower of
    the reader's fan-in and the slowest helper's share, plus GF decode
    compute at the reader, plus one hop. ``degraded=True`` adds
    ``replan_penalty`` — building/fetching the alternative decode
    program for the surviving-shard set (cached after first use, but
    the model prices the cold path so the SLO bound is conservative).
    """
    t = with_background(topo, bg_units)
    helpers = [int(h) for h in helpers]
    if not helpers:
        raise ValueError("coded_read_time: need at least one helper")
    per_helper = nbytes / len(helpers)
    t_helpers = max(per_helper / t.nic_bw[h] for h in helpers)
    t_fanin = nbytes / t.nic_bw[int(reader)]
    t_decode = nbytes / topo.compute_rate[int(reader)]
    base = max(t_helpers, t_fanin) + t_decode + t.hop_latency
    return base + (replan_penalty if degraded else 0.0)


# ---------------------------------------------------------------------------
# calibration fit: (compute_rate, tick_overhead) from a measured chunk sweep
# ---------------------------------------------------------------------------

#: effectively-infinite wire for calibrated single-host topologies: on forced
#: XLA host devices the "network" is shared memory, so the whole per-tick cost
#: lives in the compute + per-tick-overhead terms the fit below recovers.
CALIBRATION_NIC_BW = 1e15


def fit_chain_constants(samples, n: int, k: int,
                        block_bytes: float) -> tuple[Topology, np.ndarray]:
    """Least-squares (compute_rate, tick_quad, tick_overhead) from a sweep.

    ``samples`` is a sequence of ``(num_chunks, wall_seconds)`` measurements
    of the REAL pipelined chain encode at one ``(n, k, block_bytes)``
    geometry. On a uniform topology with a negligible wire the makespan
    model collapses to a form linear in the three constants:

        T(C) = (1/r) * block_bytes * (2k + (C-1)*mb) / C
             + q * block_bytes^2 * (2k + (C-1)*mb) / C^2
             + t0 * (C + n - 1)

    (``mb`` = blocks at the busiest position, 2k = total replica blocks down
    the chain). The quadratic ``q`` (``Topology.tick_quad``) captures the
    compute bandwidth collapsing when few-chunk plans push the per-tick
    working set past the cache hierarchy — on this host the one-chunk plan
    runs ~50x slower than 32 chunks, far beyond what any linear byte model
    can express; ``q`` is only fitted when the sweep has >= 3 distinct
    counts (two pin just rate + overhead). Returns the calibrated uniform
    :class:`Topology` — whose ``chain_makespan`` reproduces the fitted curve
    exactly — and the per-sample model predictions, in sample order.
    Replaces the hand-tuned ``compute_rate``/``tick_overhead`` defaults with
    measured ones (``repro_torch.core.autotune`` persists the result).
    """
    samples = [(int(c), float(t)) for c, t in samples]
    if len({c for c, _ in samples}) < 2:
        raise ValueError(
            f"fit_chain_constants: need >= 2 distinct chunk counts, got "
            f"{sorted({c for c, _ in samples})}")
    if any(c < 1 or t <= 0 for c, t in samples):
        raise ValueError(f"fit_chain_constants: bad samples {samples}")
    mb = max(position_blocks(n, k))
    C = np.array([c for c, _ in samples], dtype=float)
    T = np.array([t for _, t in samples], dtype=float)
    g_bytes = block_bytes * (2 * k + (C - 1) * mb) / C   # x (1/rate)
    g_quad = g_bytes * block_bytes / C                   # x tick_quad
    g_ticks = C + n - 1                                  # x tick_overhead
    with_quad = len({c for c, _ in samples}) >= 3
    cols = [g_bytes, g_quad, g_ticks] if with_quad else [g_bytes, g_ticks]
    # rows weighted by 1/T: minimize RELATIVE residuals, so the fast
    # many-chunk samples are fit as faithfully as the slow one-chunk ones
    # (plain lstsq would let the largest T dominate the loss)
    A = np.stack([col / T for col in cols], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.ones_like(T), rcond=None)
    inv_rate, quad, t0 = ((coef[0], coef[1], coef[2]) if with_quad
                          else (coef[0], 0.0, coef[1]))
    # physical clamps: a tiny/negative coefficient means that term is not
    # identifiable from the sweep — pin it instead of emitting a nonsense rate
    inv_rate = max(float(inv_rate), 1e-15)
    quad = max(float(quad), 0.0)
    t0 = max(float(t0), 0.0)
    topo = Topology.uniform(n, compute_rate=1.0 / inv_rate,
                            nic_bw=CALIBRATION_NIC_BW, hop_latency=0.0,
                            tick_overhead=t0, tick_quad=quad)
    pred = np.array([chain_makespan(topo, range(n), k, block_bytes, c)
                     for c, _ in samples])
    return topo, pred


# ---------------------------------------------------------------------------
# calibration: measure per-device compute rates with the real GF combine
# ---------------------------------------------------------------------------


def _default_devices() -> list:
    import torch
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def measure_compute_rates(l: int = 16, nwords: int = 1 << 15,
                          iters: int = 3, devices=None) -> list[float]:
    """Micro-benchmark: bytes/s of the packed GF combine on every device.

    Times ``ops.encode_packed`` of a (1, 2) coefficient matrix over two
    blocks of ``nwords`` words (the shift/mask/multiply/xor work of a chain
    node combining its replica blocks) on each device separately, after one
    warm-up call: CUDA events on a card, which launches the ``gf_encode``
    kernel, ``time.perf_counter`` on the CPU, which runs its plain version.
    ``devices`` defaults to every card, or the CPU where there is none.
    Returns the median bytes/s of each device: the measured
    ``Topology.compute_rate`` for clusters whose nodes are the local
    devices. On heterogeneous real clusters, run this per host and
    assemble the Topology from the per-host numbers.
    """
    import time

    import torch

    from repro_torch.core import gf
    from repro_torch.kernels.gf_encode import ops

    devices = [torch.device(d) for d in (devices if devices is not None
                                         else _default_devices())]
    rng = np.random.default_rng(0)
    coeffs = rng.integers(1, 1 << l, size=(1, 2))
    data = rng.integers(0, 1 << l, size=(2, nwords)).astype(gf.WORD_DTYPE[l])
    packed_host = torch.from_numpy(data.view(np.int32))
    rates = []
    for dev in devices:
        xp = packed_host.to(dev)
        ops.encode_packed(coeffs, xp, l)            # build + warm
        ts = []
        for _ in range(iters):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.cuda.device(dev):
                    start.record()
                    ops.encode_packed(coeffs, xp, l)
                    end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                ops.encode_packed(coeffs, xp, l)
                ts.append(time.perf_counter() - t0)
        rates.append(data.nbytes / sorted(ts)[len(ts) // 2])
    return rates


def measured(nic_bw: float = 250e6, l: int = 16, nwords: int = 1 << 15,
             tick_overhead: float = 0.0) -> Topology:
    """Topology with calibrated per-device compute rates and a uniform NIC."""
    rates = measure_compute_rates(l=l, nwords=nwords)
    return Topology(compute_rate=tuple(rates),
                    nic_bw=(float(nic_bw),) * len(rates),
                    tick_overhead=tick_overhead)
