"""Cost-model-driven autotuner for the GF kernels and pipeline plans.

The port's counterpart of the JAX package's ``repro.core.autotune``: the
same modes, environment variables, cache file format, key layout,
resolution order and counters, over the port's kernels and entry points.
What a tuner may change is SPEED, never bytes: every tuned configuration
encodes, decodes and repairs bit-identically to the hand-tuned one.

* **search** — short timed probes of the real kernels and entry points
  sweep candidate configurations (the ``gf_encode`` block, the bit-plane /
  bit-lift dispatch, chunk counts, stagger) and keep the fastest. A probe
  is timed with CUDA events after one warm-up call on a card, with
  ``time.perf_counter`` on the CPU;
* **cross-check** — each calibration sample is compared against a
  prediction from the bytes the program's launches move
  (``program_cost``) and the calibrated makespan model;
* **calibrate** — a measured chunk sweep least-squares-fits the topology
  model's ``compute_rate`` / ``tick_overhead``
  (``topology.fit_chain_constants``), which the scheduler plans with;
* **cache** — results persist in a JSON tuning cache keyed like
  ``repro_torch.core.jitcache`` (backend, entry point, code spec, shapes),
  so a warm process performs ZERO search probes (``stats()`` shows it).

The backend part of every key is the port's own, ``torch-cuda`` or
``torch-cpu`` (the device the tuned call runs on), never the JAX package's
``cpu`` / ``gpu``: the two packages may share one cache file, and neither
reads the other's tuned values.

Only a candidate that the geometry refuses with ``ValueError`` (a lifted
matrix past the shared memory a block may use, say) is skipped, and the
entry records why. Any other error of a probe, a failed build or launch
above all, propagates: a kernel that cannot run must not quietly lose a
sweep.

Knobs:

* ``RAPIDRAID_TUNE`` — ``off`` (hand-tuned defaults, never read or write
  the cache), ``cached`` (default: consult the cache, fall back to the
  defaults, never probe), ``search`` (probe-and-persist on cache miss);
* ``RAPIDRAID_TUNE_CACHE`` — cache file path (default
  ``~/.cache/rapidraid/autotune.json``).

``python -m repro_torch.autotune`` pre-warms the cache for a geometry.
Probes always pass explicit configurations, so they never recurse into a
resolver.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Sequence

import torch

from repro_torch.core import gf
from repro_torch.core import topology as topo_lib

TUNE_ENV = "RAPIDRAID_TUNE"
CACHE_ENV = "RAPIDRAID_TUNE_CACHE"
MODES = ("off", "cached", "search")
CACHE_VERSION = 1

#: hand-tuned default the pipeline entry points fall back to.
DEFAULT_NUM_CHUNKS = 8
#: candidate chunk counts for plan tuning (model search + probes filter to
#: counts that divide the geometry).
CHUNK_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)
#: candidate staggers are derived per num_chunks: (1, nc//2, nc).

_PROBE_ITERS = 3            # timed repetitions per candidate (median wins)


def mode() -> str:
    """The tuning mode from ``RAPIDRAID_TUNE`` (validated)."""
    m = os.environ.get(TUNE_ENV, "cached").strip().lower() or "cached"
    if m not in MODES:
        raise ValueError(
            f"{TUNE_ENV}={m!r}: must be one of {', '.join(MODES)}")
    return m


def cache_path() -> str:
    """The tuning-cache file path from ``RAPIDRAID_TUNE_CACHE``."""
    p = os.environ.get(CACHE_ENV)
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "rapidraid",
                        "autotune.json")


def _device(device=None) -> torch.device:
    """The device a tuned call runs on: ``device``, else the card where
    there is one (the entry points' default), else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def backend(device=None) -> str:
    """The backend part of a cache key: ``torch-cuda`` or ``torch-cpu``."""
    return f"torch-{_device(device).type}"


# ---------------------------------------------------------------------------
# the persisted tuning cache
# ---------------------------------------------------------------------------


class TuningCache:
    """JSON-backed map from canonical key strings to tuned-config entries.

    Each entry is a dict with at least ``value`` (the tuned config) plus
    probe evidence (``timings_s``, ``skipped``, the calibration samples).
    Keys mirror ``repro_torch.core.jitcache``:
    ``entry|backend|code-spec|shape parts``.
    """

    def __init__(self, path: str):
        self.path = path
        self.entries: dict[str, dict] = {}
        self.load()

    def load(self) -> None:
        """(Re)read the cache file; a missing file is an empty cache, a
        mangled one is a ``ValueError`` naming the path and the defect."""
        self.entries = {}
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(
                f"tuning cache {self.path} is not valid JSON ({e}); delete "
                f"it or point {CACHE_ENV} elsewhere") from e
        if not isinstance(raw, dict) or "entries" not in raw:
            raise ValueError(
                f"tuning cache {self.path} has no 'entries' map — not a "
                f"RapidRAID tuning cache")
        if raw.get("version") != CACHE_VERSION:
            raise ValueError(
                f"tuning cache {self.path} has version {raw.get('version')!r},"
                f" expected {CACHE_VERSION} — delete it to re-tune")
        if not isinstance(raw["entries"], dict) or not all(
                isinstance(v, dict) for v in raw["entries"].values()):
            raise ValueError(
                f"tuning cache {self.path}: 'entries' must map keys to "
                f"config dicts")
        self.entries = raw["entries"]

    def save(self) -> None:
        """Atomic write-through (tmp + rename), creating parent dirs."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": self.entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def get(self, key: str) -> dict | None:
        return self.entries.get(key)

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = entry


_cache: TuningCache | None = None
_cache_for_path: str | None = None
_stats = {"hits": 0, "misses": 0, "probes": 0}


def reset() -> None:
    """Drop the in-process cache handle and zero the counters (tests; also
    how a process picks up an externally rewritten cache file)."""
    global _cache, _cache_for_path
    _cache = None
    _cache_for_path = None
    for k in _stats:
        _stats[k] = 0


def stats() -> dict[str, int]:
    """Lookup hit/miss and probe counters — a warm cache must show
    ``probes == 0``."""
    return dict(_stats)


def cache() -> TuningCache:
    """The process-wide cache for the current ``RAPIDRAID_TUNE_CACHE``."""
    global _cache, _cache_for_path
    path = cache_path()
    if _cache is None or _cache_for_path != path:
        _cache = TuningCache(path)
        _cache_for_path = path
    return _cache


def _key(entry: str, *parts, device=None) -> str:
    """Canonical cache key: entry point + backend + ordered key parts.

    Code identities pass their ``CodeSpec`` (hashable AND serializable —
    the same object that keys ``repro_torch.core.jitcache`` programs and
    archive manifests); everything else is scalars. ``device`` sets the
    backend part (``backend``).
    """
    def _fmt(p):
        if dataclasses.is_dataclass(p) and not isinstance(p, type):
            d = dataclasses.asdict(p)
            return ",".join(f"{k}={d[k]}" for k in sorted(d))
        return str(p)
    return "|".join([entry, backend(device)] + [_fmt(p) for p in parts])


def _lookup(key: str) -> dict | None:
    """Cache-only lookup honoring the mode (never probes, never writes)."""
    if mode() == "off":
        return None
    hit = cache().get(key)
    if hit is None:
        _stats["misses"] += 1
        return None
    _stats["hits"] += 1
    return hit


def _persist(key: str, entry: dict) -> None:
    c = cache()
    c.put(key, entry)
    c.save()


# ---------------------------------------------------------------------------
# probe harness + cost cross-check
# ---------------------------------------------------------------------------


def _median_time(fn: Callable[[], object], iters: int = _PROBE_ITERS,
                 device=None) -> float:
    """Median seconds of ``fn`` after one warm-up call (builds, first use):
    CUDA events around each call on a card, the host clock on the CPU."""
    dev = _device(device)
    fn()
    ts = []
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _sweep(candidates: Sequence, probe: Callable[[object], object],
           iters: int = _PROBE_ITERS, device=None) -> tuple[object, dict, dict]:
    """Time ``probe(candidate)`` for every candidate; return the fastest,
    the timings and the skipped candidates with why.

    One probe = one swept candidate list (``stats()['probes']`` counts
    sweeps, the unit the warm-cache zero-probe checks gate on). A candidate
    whose probe raises ``ValueError`` (the geometry refuses it) is skipped
    and recorded; any other exception propagates. If every candidate is
    skipped the caller falls back to its heuristic.
    """
    _stats["probes"] += 1
    timings: dict = {}
    skipped: dict = {}
    for cand in candidates:
        try:
            timings[cand] = _median_time(lambda: probe(cand), iters, device)
        except ValueError as e:
            skipped[str(cand)] = str(e)
    if not timings:
        return None, {}, skipped
    best = min(timings, key=timings.get)
    return best, {str(c): round(t, 6) for c, t in timings.items()}, skipped


def _entry(value, heuristic, timings: dict, skipped: dict) -> dict:
    entry = {"value": value, "heuristic": heuristic, "timings_s": timings}
    if skipped:
        entry["skipped"] = skipped
    return entry


def program_cost(code, nwords: int, num_chunks: int) -> dict[str, float]:
    """Work of one encode program's launches on a (k, nwords) object: the
    port's counterpart of reading XLA's ``cost_analysis``.

    ``bytes``: what the ``chain_tick`` launches read and write, counted
    from the code and the geometry as ``PERF.md``'s bounds count them: per
    node and int32 lane, the wire in, each replica slot, the codeword out
    and, except for the last node, the wire out. ``flops``: the integer
    operations (per replica slot, l bit masks of two operations, an xi
    multiply and xor, and a psi multiply and xor where psi is nonzero).
    Neither depends on ``num_chunks``: the chunks cut the same work into
    ticks. The field names are the reference's.
    """
    del num_chunks
    lanes = nwords // gf.LANES[code.l]
    valid = code.chain.block_valid
    psi_nz = code.chain.psi != 0
    n = code.n
    units = sum(2 + int(valid[i].sum()) + (i + 1 < n) for i in range(n))
    ops = sum(code.l * (4 + 2 * int(psi_nz[i, s]))
              for i in range(n) for s in range(code.chain.max_blocks)
              if valid[i, s])
    return {"flops": float(ops * lanes), "bytes": float(units * lanes * 4)}


def predict_seconds(cost: dict[str, float], n_ticks: int,
                    topo: topo_lib.Topology) -> float:
    """Roofline-style runtime prediction from a program's byte count.

    GF coding is mask/shift/xor streaming — memory-bound — so the byte
    term dominates: bytes at the calibrated ``compute_rate`` plus the
    calibrated per-tick overhead for each of the program's ``n_ticks``
    pipeline ticks.
    """
    rate = min(topo.compute_rate)
    return cost.get("bytes", 0.0) / rate + n_ticks * topo.tick_overhead


# ---------------------------------------------------------------------------
# kernel configs: block widths + bit-plane / bit-lift dispatch
# ---------------------------------------------------------------------------


def kernel_block(entry: str, l: int, Bp: int, *, heuristic: int,
                 candidates: Sequence[int] = (),
                 probe: Callable[[int], object] | None = None,
                 device=None) -> int:
    """Tuned block width for a kernel entry point.

    ``entry`` is the kernel name (``encode_packed``: the threads of a
    ``gf_encode`` block), the key carries (backend, l, Bp). Cache hit wins;
    on a miss, ``search`` mode with a ``probe`` sweeps the candidates on the
    real kernel and persists the fastest; otherwise the heuristic.
    """
    key = _key(entry, f"l={l}", f"Bp={Bp}", device=device)
    hit = _lookup(key)
    if hit is not None:
        blk = int(hit.get("value", 0))
        if blk > 0:
            return blk
    if mode() == "search" and probe is not None and candidates:
        best, timings, skipped = _sweep(candidates, probe, device=device)
        if best is not None:
            _persist(key, _entry(int(best), int(heuristic), timings, skipped))
            return int(best)
    return heuristic


def tick_block(l: int, S: int, *, heuristic: int, device=None) -> int:
    """The tick kernels' block width for chunk length ``S`` (cache-only).

    The port's tick kernels take no tile width: ``chain_tick`` and
    ``repair_tick`` cover 256 threads x 4 lanes a block where ``S`` allows
    16-byte lanes, else x 1, and choose that themselves
    (``ops.pick_tick_block``). So this returns ``heuristic``, the width the
    kernel uses; the lookup keeps the reference's key and counters, and a
    cached value (``tune_tick_block`` writes the same width) changes
    nothing.
    """
    _lookup(_key("tick_block", f"l={l}", f"S={S}", device=device))
    return heuristic


def tune_tick_block(l: int, S: int, max_b: int = 2, device=None) -> int:
    """Record the tick kernels' block width for chunk length ``S``.

    Nothing is swept: the width is the kernel's own
    (``ops.pick_tick_block``), so a search-mode miss persists it with
    ``from: "kernel"`` and no probe. Returns the width the kernel uses.
    ``max_b`` is the reference's signature (its probe's slot count).
    """
    from repro_torch.kernels.gf_encode import ops as kernel_ops

    del max_b
    width = kernel_ops.pick_tick_block(S)
    key = _key("tick_block", f"l={l}", f"S={S}", device=device)
    if _lookup(key) is None and mode() == "search":
        _persist(key, {"value": int(width), "heuristic": int(width),
                       "from": "kernel"})
    return width


def dispatch_for(l: int, rows: int, k: int, B: int, *,
                 probes: dict[str, Callable[[], object]] | None = None,
                 device=None) -> str:
    """Bit-plane vs bit-lift dispatch for a static-matrix encode of shape
    (rows, k) x B.

    Returns ``"vpu"`` (the bit-plane ``gf_encode`` kernel — the hand-tuned
    default) or ``"mxu"`` (the bit-lift ``gf_encode_mxu`` on the int8
    tensor cores). On a ``search`` miss with probes, times BOTH real
    kernels and persists the winner per (backend, l, rows, k, B).
    """
    key = _key("dispatch", f"l={l}", f"rows={rows}", f"k={k}", f"B={B}",
               device=device)
    hit = _lookup(key)
    if hit is not None and hit.get("value") in ("vpu", "mxu"):
        return hit["value"]
    if mode() == "search" and probes:
        best, timings, skipped = _sweep(sorted(probes), lambda d: probes[d](),
                                        device=device)
        if best is not None:
            _persist(key, _entry(str(best), "vpu", timings, skipped))
            return str(best)
    return "vpu"


# ---------------------------------------------------------------------------
# pipeline plan parameters: num_chunks + stagger
# ---------------------------------------------------------------------------


def calibrated_topology(n: int, l: int = 16, fallback: bool = True,
                        device=None) -> topo_lib.Topology | None:
    """Uniform n-node topology with MEASURED compute_rate/tick_overhead.

    Reads the persisted chain calibration (``calibrate_chain``); without
    one, returns the hand-tuned ``Topology.uniform`` defaults when
    ``fallback`` else None. The scheduler consults this for ``topo=None``
    plans, and ``num_chunks_for`` uses it to pick chunk counts by model
    when probing is off or impossible.
    """
    hit = _lookup(_key("chain_calib", f"l={l}", device=device))
    if hit is not None and "compute_rate" in hit and "tick_overhead" in hit:
        return topo_lib.Topology.uniform(
            n, compute_rate=float(hit["compute_rate"]),
            nic_bw=topo_lib.CALIBRATION_NIC_BW, hop_latency=0.0,
            tick_overhead=float(hit["tick_overhead"]),
            tick_quad=float(hit.get("tick_quad", 0.0)))
    return topo_lib.Topology.uniform(n) if fallback else None


def random_words(shape, l: int, device) -> torch.Tensor:
    """Seeded random GF(2^l) words made on ``device`` (a probe's input)."""
    gen = torch.Generator(device=device).manual_seed(0)
    lanes = torch.randint(-(1 << 31), 1 << 31, tuple(shape[:-1]) + (shape[-1] // gf.LANES[l],),
                          generator=gen, dtype=torch.int64, device=device)
    return gf.unpack_u32(lanes.to(torch.int32), l)


def calibrate_chain(code, nwords: int = 1 << 15,
                    chunk_counts: Sequence[int] = (1, 2, 4, 8, 16),
                    iters: int = _PROBE_ITERS, device=None) -> dict:
    """Measure a real chunk sweep and fit the makespan-model constants.

    Times ``storage.chain.pipelined_encode`` (warm) at each chunk count on
    a seeded (k, nwords) object made on the device, least-squares-fits
    ``topology.fit_chain_constants``, cross-checks every sample against the
    fitted model AND a byte-count prediction (``program_cost``), and
    persists the calibration per (backend, l). One card holds the whole
    chain, so this runs on any one device.
    """
    from repro_torch.storage import chain as chain_lib

    dev = _device(device)
    lanes = gf.LANES[code.l]
    chunk_counts = sorted({int(c) for c in chunk_counts
                           if c >= 1 and nwords % (lanes * c) == 0})
    if len(chunk_counts) < 2:
        raise ValueError(
            f"calibrate_chain: nwords={nwords} admits chunk counts "
            f"{chunk_counts}; need >= 2 (whole uint32 lanes per chunk)")
    data = random_words((code.k, nwords), code.l, dev)
    block_bytes = nwords * (code.l // 8)
    _stats["probes"] += 1
    samples, cost = [], {}
    for c in chunk_counts:
        t = _median_time(
            lambda: chain_lib.pipelined_encode(code, data, num_chunks=c, device=dev),
            iters, dev)
        samples.append((c, t))
        cost[str(c)] = program_cost(code, nwords, c)
    topo, pred = topo_lib.fit_chain_constants(samples, code.n, code.k,
                                              block_bytes)
    rel_err = [abs(p - t) / t for (_, t), p in zip(samples, pred)]
    entry = {
        "compute_rate": topo.compute_rate[0],
        "tick_overhead": topo.tick_overhead,
        "tick_quad": topo.tick_quad,
        "n": code.n, "k": code.k, "block_bytes": block_bytes,
        "samples": [{"num_chunks": c, "measured_s": round(t, 6),
                     "model_s": round(float(p), 6),
                     "hlo_bytes": cost[str(c)]["bytes"],
                     "hlo_pred_s": round(predict_seconds(
                         cost[str(c)], c + code.n - 1, topo), 6)}
                    for (c, t), p in zip(samples, pred)],
        "max_rel_err": round(float(max(rel_err)), 4),
    }
    if mode() != "off":
        _persist(_key("chain_calib", f"l={code.l}", device=dev), entry)
    return entry


def chunk_candidates_for(l: int, total_words: int,
                         valid: Callable[[int], bool] | None = None
                         ) -> list[int]:
    """The chunk counts a geometry admits, smallest first."""
    lanes = gf.LANES[l]
    if valid is None:
        def valid(c):
            return total_words % (lanes * c) == 0
    return [c for c in CHUNK_CANDIDATES
            if c * lanes <= total_words and valid(c)]


def num_chunks_for(entry: str, code, total_words: int, *,
                   default: int = DEFAULT_NUM_CHUNKS,
                   chain_len: int | None = None,
                   valid: Callable[[int], bool] | None = None,
                   probe: Callable[[int], object] | None = None,
                   extra_key: tuple = (), device=None) -> int:
    """Tuned pipeline chunk count for one entry point + geometry.

    Resolution order: ``off`` → hand-tuned default; cache hit (validated
    against the geometry) → tuned value; ``search`` + a ``probe`` → timed
    sweep of the real entry point over the admissible candidates,
    persisted; otherwise → the calibrated makespan model's best candidate
    when a chain calibration exists, else the default. Probes always pass
    explicit chunk counts, so they never recurse into this resolver.
    """
    if mode() == "off":
        return default
    n = code.n if chain_len is None else chain_len
    key = _key(entry, code.spec, f"B={total_words}", f"chain={n}",
               *[f"x{i}={v}" for i, v in enumerate(extra_key)], "num_chunks",
               device=device)
    cands = chunk_candidates_for(code.l, total_words, valid)
    hit = _lookup(key)
    if hit is not None:
        c = int(hit.get("value", 0))
        if c in cands or (valid is not None and c >= 1 and valid(c)):
            return c
    if not cands:
        return default
    if mode() == "search" and probe is not None:
        best, timings, skipped = _sweep(cands, probe, device=device)
        if best is not None:
            _persist(key, _entry(int(best), default, timings, skipped))
            return int(best)
    # model fallback: only when a MEASURED calibration exists — the
    # hand-tuned Topology defaults (tick_overhead=0) would always pick the
    # finest candidate, a silent behavior change the default must not make
    topo = calibrated_topology(n, l=code.l, fallback=False, device=device)
    if topo is not None:
        block_bytes = total_words * (code.l // 8)
        best = min(cands, key=lambda c: topo_lib.chain_makespan(
            topo, range(n), min(code.k, n), block_bytes, c))
        if mode() == "search":
            _persist(key, {"value": int(best), "heuristic": default,
                           "from": "model"})
        return int(best)
    return default


def stagger_for(code, b_obj: int, num_chunks: int, *, default: int = 1,
                probe: Callable[[int], object] | None = None,
                device=None) -> int:
    """Tuned stagger for the staggered multi-object pipeline.

    ``stagger=1`` (maximal overlap) is the hand-tuned default;
    ``stagger=num_chunks`` runs the chains back to back, one object a node
    a tick — the right choice when a tick's compute, not the wire, is the
    bottleneck — so the probe sweeps between the two.
    """
    if mode() == "off":
        return default
    key = _key("stagger", code.spec, f"b={b_obj}", f"nc={num_chunks}", device=device)
    cands = sorted({1, max(1, num_chunks // 2), num_chunks})
    hit = _lookup(key)
    if hit is not None:
        s = int(hit.get("value", 0))
        if 1 <= s <= num_chunks:
            return s
    if mode() == "search" and probe is not None and b_obj > 1:
        best, timings, skipped = _sweep(cands, probe, device=device)
        if best is not None:
            _persist(key, _entry(int(best), default, timings, skipped))
            return int(best)
    return default


# ---------------------------------------------------------------------------
# prewarm: fill every cache family for one geometry (the CLI entry)
# ---------------------------------------------------------------------------


def _cached_calibration(code, nwords: int, device) -> dict | None:
    """The persisted chain calibration when it was measured at this
    geometry (n, k, block bytes), else None."""
    hit = _lookup(_key("chain_calib", f"l={code.l}", device=device))
    if hit is not None and (hit.get("n"), hit.get("k"), hit.get("block_bytes")) == \
            (code.n, code.k, nwords * (code.l // 8)):
        return hit
    return None


def prewarm(code, nwords: int = 1 << 14, b_obj: int = 4,
            chunk_counts: Sequence[int] = (1, 2, 4, 8, 16),
            device=None) -> dict:
    """Populate the tuning cache for one code geometry (search mode only).

    Runs, in order: the kernel block sweep (``gf_encode``'s threads), the
    bit-lift's tile width and the bit-plane / bit-lift dispatch, the tick
    kernels' widths for every admissible chunk count, the chain
    calibration sweep (fits compute_rate / tick_overhead) and the plan
    parameters (num_chunks for encode / encode_many, stagger). Returns a
    report of every tuned value. Requires ``RAPIDRAID_TUNE=search``. One
    card holds the whole chain, so the chain probes always run (the
    reference needs ``code.n`` devices for them). A calibration already
    cached for this geometry is reused, not measured again, so a warm
    cache makes zero probes.
    """
    from repro_torch.kernels.gf_encode import ops as kernel_ops
    from repro_torch.storage import chain as chain_lib
    from repro_torch.storage import multi as multi_lib

    if mode() != "search":
        raise ValueError(
            f"prewarm needs {TUNE_ENV}=search, got {TUNE_ENV}={mode()!r}")
    dev = _device(device)
    if dev.type == "cuda":
        dev = chain_lib._resolve_device(dev)
    l = code.l
    lanes = gf.LANES[l]
    report: dict = {"backend": backend(dev), "cache": cache_path(),
                    "spec": dataclasses.asdict(code.spec),
                    "nwords": nwords}
    data = random_words((code.k, nwords), l, dev)

    Bp = nwords // lanes
    report["encode_packed_block"] = kernel_ops.encode_block_for(code.G, data, l)
    report["encode_mxu_block"] = kernel_ops.mxu_block_for(code.G, data, l)
    report["dispatch"] = kernel_ops.dispatch_for_data(code.G, data, l)
    report["tick_blocks"] = {
        c: tune_tick_block(l, Bp // c, device=dev)
        for c in chunk_candidates_for(l, nwords) if (Bp % c) == 0}

    cal = _cached_calibration(code, nwords, dev)
    report["calibration"] = (cal if cal is not None
                             else calibrate_chain(code, nwords, chunk_counts, device=dev))
    report["num_chunks_encode"] = num_chunks_for(
        "encode", code, nwords, device=dev,
        probe=lambda c: chain_lib.pipelined_encode(code, data, num_chunks=c, device=dev))
    objs = random_words((b_obj, code.k, nwords), l, dev)
    nc_many = num_chunks_for(
        "encode_many", code, nwords, extra_key=(b_obj,), device=dev,
        probe=lambda c: multi_lib.pipelined_encode_many(code, objs, num_chunks=c,
                                                        device=dev))
    report["num_chunks_encode_many"] = nc_many
    report["stagger"] = stagger_for(
        code, b_obj, nc_many, device=dev,
        probe=lambda s: multi_lib.pipelined_encode_many(
            code, objs, num_chunks=nc_many, stagger=s, device=dev))
    report["stats"] = stats()
    return report
