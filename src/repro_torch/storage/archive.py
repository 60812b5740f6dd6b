"""Archival lifecycle: replicated hot tier -> RapidRAID coded tier -> repair.

The paper's lifecycle over a ``NodeStore``:

1. **hot_save** — a freshly written object (k blocks) is stored with two
   replicas overlapped over n nodes exactly per RapidRAID's placement
   (replica 1 on nodes 0..k-1, replica 2 on nodes n-k..n-1), the layout
   pipelined insertion produces and the precondition for chain encoding
   (paper §V).
2. **archive_step** — the migration: the n nodes run the pipelined encode
   (``repro_torch.storage.chain`` on the card, or the host oracle), each
   node keeps its coded block c_i, replicas are dropped. Storage falls
   from 2x to n/k (1.45x for (16,11)). **archive_many** batches the
   migration: B pending steps encode together through the staggered
   multi-chain (``repro_torch.storage.multi``) or, for families without a
   chain, one batched ``gf_encode`` launch — the paper's multi-object
   archival (§VI).
3. **restore** — any k live coded blocks reconstruct the object; the decode
   runs on the host, as in the JAX package. ``read_range`` serves byte
   ranges WITHOUT materializing the object: hot-tier slice reads, or a
   degraded read that decodes only the covering word range of k surviving
   shards.
4. **repair** — after node loss, only the missing c_i are recomputed from k
   digest-verified helpers (``fault_tolerance.repair_plan``), through the
   reverse pipelined helper chain on the card or one ``gf_encode`` launch.
   ``repair_many`` heals B objects through one staggered run;
   ``restore_blocks(heal=True)`` and ``read_range(heal=True)`` heal missing
   shards found on the read path.

Manifests, coded blobs and the ``streaming`` stripe records are the JAX
package's (``repro.storage.archive``) byte for byte, JSON key order
included, so either package restores, repairs and range-reads the other's
archives. Where the JAX package picks its device chain when it has n
devices, one card holds the whole chain here: ``use_devices=None`` means
the card (``device``, CUDA unless the caller passes ``device="cpu"``), and
``use_devices=False`` keeps the host route (``code.encode_np``) or the
static-coefficient kernel.

Straggler mitigation: ``node_speeds`` permutes slow nodes to the chain
ends (the paper's Fig. 5 insight); ``topology=`` engages the
heterogeneity-aware scheduler (``repro_torch.core.scheduler``), whose
plan (chain order and chunk count) the manifest records with the topology
(``sched``), as the JAX package's does. Either way the manifest records
the node->codeword-row mapping so decode is permutation-aware. On one
card the chain order changes which node keeps which codeword row, not the
kernels' work. Families without a chain encode through ``ops.encode_auto``
(the bit-plane or the bit-lift kernel, as tuned).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from repro_torch.core import (classical, codes, fault_tolerance, gf, rapidraid, scheduler,
                              streaming)
from repro_torch.core import topology as topo_lib
from repro_torch.kernels.gf_encode import ops
from repro_torch.storage import chain as chain_lib
from repro_torch.storage import multi as multi_lib
from repro_torch.storage import repair as repair_lib
from repro_torch.storage.object_store import NodeStore, digest, digests

MANIFEST = "manifests/{step:08d}.json"
HOT = "hot/{step:08d}/block_{j:02d}.bin"
ARC = "archive/{step:08d}/c_{i:02d}.bin"


@dataclasses.dataclass(frozen=True)
class ArchiveConfig:
    n: int = 16
    k: int = 11
    l: int = 16               # GF(2^16): random coefficients suffice (§V-A)
    seed: int = 0
    num_chunks: int = 8       # pipeline chunks per block
    baseline: str = "rapidraid"  # or "classical" (CEC; for benchmarks)
    family: str = "rapidraid"    # registered code family (repro_torch.core.codes)

    def code(self) -> codes.ErasureCode:
        return codes.make(self.family, self.n, self.k, l=self.l,
                          seed=self.seed)


@dataclasses.dataclass(frozen=True)
class ReadResult:
    """What a read returned AND how it was served.

    ``data``: the payload — ``(k, B)`` uint8 blocks from
    :func:`restore_blocks_ex`, raw ``bytes`` from :func:`read_range_ex`.
    ``served_from``: which path produced the bytes —

    * ``"hot"`` — replica-tier read (including the retained-replica
      fallback of a two-phase migration);
    * ``"coded"`` — archive-tier decode with the FULL shard set alive
      (RapidRAID is non-systematic, so even the healthy path is a k-fanin
      decode — "coded" means nothing had to be routed around);
    * ``"degraded"`` — archive-tier decode that routed around missing or
      corrupt shards.

    ``nodes``: the physical nodes that served payload bytes for this
    read (replica holders, decode helpers); liveness probes of nodes that
    contributed nothing are not counted. ``healed``: True when
    ``heal=True`` actually re-materialized shards on this read (reads
    doubling as scrubs). Serving metrics and tests consume these fields
    instead of inferring the path from side effects.
    """

    data: "np.ndarray | bytes"
    served_from: str
    nodes: tuple[int, ...]
    healed: bool
    step: int

    def __post_init__(self):
        if self.served_from not in ("hot", "coded", "degraded"):
            raise ValueError(
                f"served_from must be 'hot', 'coded' or 'degraded', "
                f"got {self.served_from!r}")


def _result(data, served_from: str, nodes, healed: bool,
            step: int) -> ReadResult:
    return ReadResult(data=data, served_from=served_from,
                      nodes=tuple(sorted({int(x) for x in nodes})),
                      healed=bool(healed), step=int(step))


def _words(blocks_u8: np.ndarray, l: int) -> np.ndarray:
    dt = gf.WORD_DTYPE[l]
    return blocks_u8.view(dt)


def _u8(blocks_w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(blocks_w).view(np.uint8)


# ---------------------------------------------------------------------------
# hot tier (replicated per RapidRAID placement)
# ---------------------------------------------------------------------------


def hot_save(store: NodeStore, step: int, blocks: np.ndarray,
             acfg: ArchiveConfig) -> dict:
    """blocks (k, B) uint8 -> two overlapped replicas over n nodes."""
    place = rapidraid.placement(acfg.n, acfg.k)
    k, B = blocks.shape
    assert k == acfg.k
    # serialize each block ONCE: every replica put and the digest reuse it
    blobs = [blocks[j].tobytes() for j in range(k)]
    for node, held in enumerate(place):
        for j in held:
            store.put(node, HOT.format(step=step, j=j), blobs[j])
    manifest = {
        "step": step, "tier": "hot", "n": acfg.n, "k": acfg.k, "l": acfg.l,
        "seed": acfg.seed, "family": acfg.family, "block_bytes": int(B),
        "digests": digests(blobs),
        "placement": [list(h) for h in place],
    }
    _put_manifest(store, step, manifest)
    return manifest


def hot_load(store: NodeStore, step: int, manifest: dict) -> np.ndarray:
    """Read each block from any node still holding a replica."""
    return _hot_load_ex(store, step, manifest)[0]


def _hot_load_ex(store: NodeStore, step: int,
                 manifest: dict) -> tuple[np.ndarray, list[int]]:
    """(blocks, replica nodes actually read) — the node-tracking core of
    ``hot_load`` that ``restore_blocks_ex`` builds its ReadResult from."""
    k, B = manifest["k"], manifest["block_bytes"]
    out = np.zeros((k, B), dtype=np.uint8)
    touched: list[int] = []
    for j in range(k):
        holders = [i for i, held in enumerate(manifest["placement"])
                   if j in held]
        for node in holders:
            rel = HOT.format(step=step, j=j)
            if store.has(node, rel):
                raw = store.get(node, rel)
                if digest(raw) == manifest["digests"][j]:
                    out[j] = np.frombuffer(raw, dtype=np.uint8)
                    touched.append(node)
                    break
        else:
            raise FileNotFoundError(
                f"hot block {j} of step {step} lost on all replicas")
    return out, touched


# ---------------------------------------------------------------------------
# archival migration (the paper's pipelined encode)
# ---------------------------------------------------------------------------


def _plan_placement(acfg: ArchiveConfig, block_bytes: int, topology,
                    node_speeds) -> tuple[np.ndarray, int, dict | None]:
    """(perm, num_chunks, sched-manifest-entry) for one archival chain.

    ``topology`` (a ``repro_torch.core.topology.Topology``) engages the
    heterogeneity-aware scheduler: chain ordering + chunk count minimizing
    the modeled makespan, with the plan recorded in the manifest so decode
    and repair replay the same placement. ``node_speeds`` keeps the older
    slow-nodes-to-the-ends heuristic. Neither -> in-order placement.
    """
    if topology is not None:
        if topology.n_nodes < acfg.n:
            raise ValueError(
                f"chain needs {acfg.n} nodes, topology has {topology.n_nodes}")
        nodes = None
        if topology.n_nodes > acfg.n:  # pick the n cheapest nodes
            nodes = sorted(range(topology.n_nodes),
                           key=lambda i: topo_lib.node_cost(topology, i)
                           )[: acfg.n]
        plan = scheduler.plan_chain(topology, acfg.k, float(block_bytes),
                                    nodes=nodes)
        return (np.asarray(plan.order), plan.num_chunks,
                {**plan.to_manifest(), "topology": topology.to_dict()})
    if node_speeds is not None:
        perm = chain_lib.order_chain(np.asarray(node_speeds), acfg.n, acfg.k)
        return perm, acfg.num_chunks, None
    return np.arange(acfg.n), acfg.num_chunks, None


def _use_devices(use_devices: bool | None) -> bool:
    """The device route unless the caller turned it off: one card holds the
    whole chain (the JAX package asks for n devices)."""
    return True if use_devices is None else bool(use_devices)


def _host(words: torch.Tensor) -> np.ndarray:
    """A result tensor of words as a host array."""
    return words.cpu().numpy()


def archive_step(store: NodeStore, step: int, acfg: ArchiveConfig,
                 node_speeds: np.ndarray | None = None,
                 use_devices: bool | None = None,
                 topology=None, reclaim_hot: bool = True,
                 superchunk_bytes: int | None = None, device=None) -> dict:
    """Migrate step's hot replicas to RapidRAID coded blocks; drop hot.

    ``use_devices`` None or True encodes through the pipelined chain on
    ``device``; False through the host oracle ``code.encode_np``.

    ``topology`` engages the heterogeneity-aware scheduler
    (``repro_torch.core.scheduler``): chain placement + chunk count chosen
    against the topology's makespan model and recorded in the manifest
    (``perm`` / ``sched``), so repair and decode reuse the placement.

    ``superchunk_bytes`` streams the migration: the object archives as
    independent super-chunk stripes through the streaming executor
    (``repro_torch.core.streaming``) — each stripe's hot slices are
    range-read off the replicas, encoded through ONE cached program (a
    replay of its CUDA graph on the card), and framed into atomic
    ``put_stream`` writers, so neither peak device nor peak host bytes ever
    hold the object. Positionwise codes write coded
    blocks BYTE-IDENTICAL to the monolithic path (same digests, every
    existing reader works unchanged); the manifest additionally records
    the stripe geometry + per-stripe digests (``streaming``) so restore
    and scrub can verify stripe-by-stripe. Hot digests are checked
    incrementally as stripes are read, and a mismatch aborts the coded
    writes BEFORE anything is published. Sub-packetized families cannot
    stream (raises ValueError).

    ``reclaim_hot=False`` defers the replica deletion: the step is coded
    and readable from the archive tier, but the hot replicas stay on disk
    (manifest ``hot_retained``) until ``reclaim_replicas`` has digest-
    verified every placed coded block — the lifecycle engine's
    never-drop-the-last-copy-unverified invariant.
    """
    manifest = get_manifest(store, step)
    if manifest["tier"] != "hot":
        raise ValueError(f"step {step} already archived")
    code = acfg.code()

    # chain position p stores codeword row p on physical node perm[p]
    perm, nc, sched = _plan_placement(acfg, manifest["block_bytes"],
                                      topology, node_speeds)

    if superchunk_bytes is not None:
        wb = acfg.l // 8
        plan = streaming.plan_stream(manifest["block_bytes"] // wb,
                                     max(1, superchunk_bytes // wb),
                                     l=acfg.l, num_chunks=nc)
        if plan.streaming:
            if not code.positionwise:
                raise ValueError(
                    f"archive_step: {code.family} is sub-packetized — "
                    f"stripe concatenation is not a codeword, so it cannot "
                    f"stream (archive without superchunk_bytes)")
            return _archive_step_streaming(
                store, step, acfg, manifest, code, perm, nc, sched, plan,
                use_devices, reclaim_hot, device)
        # plan degenerated to one stripe: the monolithic path IS the stream

    blocks = hot_load(store, step, manifest)
    data_w = _words(blocks, acfg.l)
    # largest feasible chunk count: every chunk must be whole uint32 lanes
    # (the device chain's granularity; the host oracle only needs nc | B,
    # which the stricter condition implies)
    while nc > 1 and data_w.shape[1] % (gf.LANES[acfg.l] * nc):
        nc //= 2
    if sched is not None:
        sched = {**sched, "num_chunks": int(nc)}  # record what actually ran
    if _use_devices(use_devices) and code.supports_chain_encode:
        coded_w = _host(chain_lib.pipelined_encode(code, data_w, num_chunks=nc,
                                                   device=device))
    else:
        # matrix-form host encode (bit-identical to the chain for
        # RapidRAID; the only encode for non-chain families)
        coded_w = code.encode_np(np.asarray(data_w))
    coded = _u8(coded_w)
    coded_blobs = [coded[i].tobytes() for i in range(acfg.n)]

    for pos in range(acfg.n):
        store.put(int(perm[pos]), ARC.format(step=step, i=pos),
                  coded_blobs[pos])
    if reclaim_hot:
        # drop the hot replicas (the actual capacity saving: 2x -> n/k)
        for node, held in enumerate(manifest["placement"]):
            for j in held:
                store.delete(node, HOT.format(step=step, j=j))

    manifest = {
        **manifest, "tier": "archive", "family": acfg.family,
        "perm": [int(p) for p in perm],
        "coded_digests": [digest(b) for b in coded_blobs],
        "orig_digests": manifest["digests"],
    }
    if not reclaim_hot:
        manifest["hot_retained"] = True
    if sched is not None:
        manifest["sched"] = sched
    _put_manifest(store, step, manifest)
    return manifest


def _hot_holders(store: NodeStore, step: int, manifest: dict) -> list[int]:
    """One replica-holding node per hot block (existence probe only)."""
    holders = []
    for j in range(manifest["k"]):
        rel = HOT.format(step=step, j=j)
        cands = [i for i, held in enumerate(manifest["placement"])
                 if j in held and store.has(i, rel)]
        if not cands:
            raise FileNotFoundError(
                f"hot block {j} of step {step} lost on all replicas")
        holders.append(cands[0])
    return holders


def _archive_step_streaming(store: NodeStore, step: int, acfg: ArchiveConfig,
                            manifest: dict, code, perm: np.ndarray, nc: int,
                            sched: dict | None, plan: streaming.StreamPlan,
                            use_devices: bool | None,
                            reclaim_hot: bool, device) -> dict:
    """The streamed migration: hot range-reads -> stripe encodes -> framed
    coded writes, never holding the object (see ``archive_step``)."""
    k, n, l = acfg.k, acfg.n, acfg.l
    wb = l // 8
    if sched is not None:
        sched = {**sched, "num_chunks": int(nc)}
    holders = _hot_holders(store, step, manifest)
    hot_rel = [HOT.format(step=step, j=j) for j in range(k)]
    # hot digests accumulate as the stripes stream past; verified BEFORE
    # any coded write publishes (the writers abort on mismatch)
    orig_sha = [hashlib.sha256() for _ in range(k)]

    def get_stripe(s: int) -> np.ndarray:
        lo, hi = plan.stripe_span(s)
        nb = (hi - lo) * wb
        rows = np.zeros((k, plan.sc_words * wb), np.uint8)  # tail zero-padded
        for j in range(k):
            raw = store.get_range(holders[j], hot_rel[j], lo * wb, nb)
            if len(raw) != nb:
                raise ValueError(
                    f"step {step}: hot block {j} short read (stripe {s}: "
                    f"got {len(raw)} of {nb} bytes)")
            orig_sha[j].update(raw)
            rows[j, :nb] = np.frombuffer(raw, dtype=np.uint8)
        return rows.view(gf.WORD_DTYPE[l])

    writers = [store.put_stream(int(perm[pos]), ARC.format(step=step, i=pos))
               for pos in range(n)]
    stripes: list[dict] = []

    def put_stripe(s: int, out_w: np.ndarray) -> None:
        frame = _u8(out_w[:, :plan.stripe_words(s)])
        recs = []
        for pos in range(n):
            blob = frame[pos].tobytes()
            writers[pos].write(blob)
            recs.append(digest(blob))
        stripes.append({"words": int(plan.stripe_words(s)),
                        "coded_digests": recs})

    try:
        if _use_devices(use_devices) and code.supports_chain_encode:
            program = chain_lib.encode_program(code, plan.sc_words, nc, device=device)
            streaming.execute(plan, program, get_stripe, put_stripe)
        else:
            # host oracle, stripe by stripe (positionwise: concatenation of
            # stripe encodes == the monolithic encode, bit-exactly)
            for s in range(plan.num_superchunks):
                put_stripe(s, np.asarray(code.encode_np(get_stripe(s))))
        for j in range(k):
            if orig_sha[j].hexdigest()[:16] != manifest["digests"][j]:
                raise ValueError(
                    f"step {step}: hot block {j} does not match its manifest "
                    f"digest — streamed archive aborted, nothing published")
    except BaseException:
        for w in writers:
            w.abort()
        raise
    for w in writers:
        w.close()

    if reclaim_hot:
        for node, held in enumerate(manifest["placement"]):
            for j in held:
                store.delete(node, HOT.format(step=step, j=j))
    manifest = {
        **manifest, "tier": "archive", "family": acfg.family,
        "perm": [int(p) for p in perm],
        # incremental frame hashes == whole-file digests, identical to the
        # monolithic path's (the files are byte-identical)
        "coded_digests": [w.digest() for w in writers],
        "orig_digests": manifest["digests"],
        "streaming": {
            "num_superchunks": int(plan.num_superchunks),
            "superchunk_bytes": int(plan.sc_words * wb),
            "num_chunks": int(nc),
            "stripes": stripes,
        },
    }
    if not reclaim_hot:
        manifest["hot_retained"] = True
    if sched is not None:
        manifest["sched"] = sched
    _put_manifest(store, step, manifest)
    return manifest


def _archive_group(store: NodeStore, grp: list[int], acfg: ArchiveConfig,
                   code, perm: np.ndarray, num_chunks: int, stagger: int,
                   use_devices: bool, manifests: dict[int, dict],
                   sched: dict | None, reclaim_hot: bool, device
                   ) -> dict[int, dict]:
    """Encode one rectangular (same block length, same placement) batch of
    hot steps and place/manifest the coded blocks."""
    # blocks are loaded one group at a time (and released after the
    # group's encode) so peak host memory is one group, not the batch
    objs_w = np.stack([_words(hot_load(store, s, manifests[s]), acfg.l)
                       for s in grp])
    B = objs_w.shape[-1]
    nc = num_chunks
    while nc > 1 and B % (gf.LANES[acfg.l] * nc):
        nc //= 2
    if sched is not None:
        sched = {**sched, "num_chunks": int(nc)}  # record what actually ran
    if use_devices and code.supports_chain_encode:
        coded_w = _host(multi_lib.pipelined_encode_many(
            code, objs_w, num_chunks=nc, stagger=stagger, device=device))
    else:
        # one batched static-coefficient encode over the whole group (the
        # bit-plane or the bit-lift kernel, as ``encode_auto`` dispatches);
        # the message view is the identity for positionwise codes and the
        # sub-packetized (M_sub, W) layout for regenerating codes, so
        # EVERY family encodes through the same static-coefficient kernels
        msgs = np.stack([np.asarray(code.to_message(o)) for o in objs_w])
        rows = _encode_static(code.G, msgs, acfg.l, device, ops.encode_auto)
        coded_w = rows.reshape(len(grp), code.n, -1)
    out: dict[int, dict] = {}
    for b, step in enumerate(grp):
        coded = _u8(coded_w[b])
        coded_blobs = [coded[i].tobytes() for i in range(acfg.n)]
        for pos in range(acfg.n):
            store.put(int(perm[pos]), ARC.format(step=step, i=pos),
                      coded_blobs[pos])
        manifest = manifests[step]
        if reclaim_hot:
            for node, held in enumerate(manifest["placement"]):
                for j in held:
                    store.delete(node, HOT.format(step=step, j=j))
        manifest = {
            **manifest, "tier": "archive", "family": acfg.family,
            "perm": [int(p) for p in perm],
            "coded_digests": digests(coded_blobs),
            "orig_digests": manifest["digests"],
            "batched_with": [int(s) for s in grp],
        }
        if not reclaim_hot:
            manifest["hot_retained"] = True
        if sched is not None:
            manifest["sched"] = sched
        _put_manifest(store, step, manifest)
        out[step] = manifest
    return out


def archive_many(store: NodeStore, steps: list[int], acfg: ArchiveConfig,
                 node_speeds: np.ndarray | None = None,
                 use_devices: bool | None = None,
                 stagger: int = 1, topology=None,
                 reclaim_hot: bool = True, device=None) -> list[dict]:
    """Batched migration: archive B hot steps CONCURRENTLY (paper §VI).

    All steps' objects are encoded together — through the staggered
    multi-chain on ``device`` (one run interleaving every object's coding
    chain over the same nodes) or, with ``use_devices=False`` or a family
    without a chain, ONE batched static-coefficient launch
    (``ops.encode_auto``; the object axis rides the kernel grid). Steps
    whose block lengths differ are grouped so each encode sees a
    rectangular (B, k, block_len) batch. Returns the updated manifests in
    step order.

    ``topology`` engages the multi-chain scheduler
    (``repro_torch.core.scheduler.plan_many``): when the cluster holds at
    least two chains' worth of nodes, concurrent chains are bin-packed onto
    DISJOINT node sets (no shared NICs); otherwise every chain runs
    staggered on the one scheduler-ordered node set. Each step's manifest
    records its placement (``perm`` / ``sched``) so repair reuses it.
    """
    code = acfg.code()
    use_devices = _use_devices(use_devices)

    manifests: dict[int, dict] = {}
    groups: dict[int, list[int]] = {}
    for step in steps:
        manifest = get_manifest(store, step)
        if manifest["tier"] != "hot":
            raise ValueError(f"step {step} already archived")
        manifests[step] = manifest
        groups.setdefault(manifest["block_bytes"], []).append(step)

    out: dict[int, dict] = {}
    for block_bytes, grp in groups.items():
        if topology is not None:
            mplan = scheduler.plan_many(topology, len(grp), acfg.n, acfg.k,
                                        float(block_bytes), stagger=stagger)
            by_chain: dict[int, list[int]] = {}
            for b, s in enumerate(grp):
                by_chain.setdefault(mplan.assignment[b], []).append(s)
            for g, sub in sorted(by_chain.items()):
                plan = mplan.plans[g]
                out.update(_archive_group(
                    store, sub, acfg, code, np.asarray(plan.order),
                    plan.num_chunks, stagger, use_devices, manifests,
                    {**plan.to_manifest(), "topology": topology.to_dict(),
                     "chain_group": int(g)}, reclaim_hot, device))
        else:
            perm, nc, _ = _plan_placement(acfg, block_bytes, None, node_speeds)
            out.update(_archive_group(store, grp, acfg, code, perm, nc, stagger,
                                      use_devices, manifests, None, reclaim_hot, device))
    return [out[s] for s in steps]


def _encode_static(M: np.ndarray, x: np.ndarray, l: int, device,
                   encode=ops.encode_words) -> np.ndarray:
    """(O, rows, W) words = M applied to (O, cols, W) words ``x`` by one
    static-coefficient launch on ``device`` (``encode``: ``ops.encode_words``,
    the ``gf_encode`` kernel, or ``ops.encode_auto``); a W of partial lanes
    is zero-padded on the way in and trimmed on the way out (the product is
    per word)."""
    dev = chain_lib._resolve_device(device)
    W = x.shape[-1]
    pad = -W % gf.LANES[l]
    if pad:
        x = np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1)
    words = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return _host(encode(M, words, l))[..., :W]


def reclaim_replicas(store: NodeStore, step: int) -> dict | None:
    """Drop a retained hot tier AFTER digest-verifying the archived copy.

    ``archive_step``/``archive_many`` with ``reclaim_hot=False`` leave the
    replicas on disk; this is the second phase of that two-phase migration.
    The replicas are deleted only once ALL n coded blocks are present on
    their manifest-recorded nodes and match their recorded digests — a
    missing or corrupt shard (e.g. its write landed on a node that died
    mid-archival) defers the reclaim (returns None) until the scrubber has
    healed it; a digest-MISMATCHED shard is deleted on the spot (it is
    provably not the data), demoting corruption to the missing-shard state
    the repair path heals. Returns the updated manifest on success, the
    manifest unchanged if the step holds no retained replicas (idempotent),
    and raises ValueError for a step that was never archived.
    """
    manifest = get_manifest(store, step)
    if manifest["tier"] == "hot":
        raise ValueError(
            f"step {step} is not archived — refusing to reclaim replicas")
    if not manifest.get("hot_retained"):
        return manifest
    alive = {pos for pos, _ in _alive_coded(store, step, manifest)}
    if len(alive) < manifest["n"]:
        for pos in range(manifest["n"]):   # corrupt copies -> missing
            rel = ARC.format(step=step, i=pos)
            if pos not in alive and store.has(manifest["perm"][pos], rel):
                store.delete(manifest["perm"][pos], rel)
        return None                      # unverified shards: keep the replicas
    for node, held in enumerate(manifest["placement"]):
        for j in held:
            store.delete(node, HOT.format(step=step, j=j))
    manifest = {**manifest, "hot_retained": False}
    _put_manifest(store, step, manifest)
    return manifest


def archive_classical(store: NodeStore, step: int, acfg: ArchiveConfig) -> dict:
    """CEC baseline (paper Fig. 1): single node gathers k blocks, computes
    m parities, scatters them. Used by benchmarks for comparison."""
    manifest = get_manifest(store, step)
    blocks = hot_load(store, step, manifest)
    code = classical.make_code(acfg.n, acfg.k, l=acfg.l)
    parity_w = classical.encode_np(code, _words(blocks, acfg.l))
    coded = np.concatenate([blocks, _u8(parity_w)], axis=0)
    coded_blobs = [coded[i].tobytes() for i in range(acfg.n)]
    for i in range(acfg.n):
        store.put(i, ARC.format(step=step, i=i), coded_blobs[i])
    for node, held in enumerate(manifest["placement"]):
        for j in held:
            store.delete(node, HOT.format(step=step, j=j))
    manifest = {**manifest, "tier": "archive_classical",
                "perm": list(range(acfg.n)),
                "coded_digests": [digest(b) for b in coded_blobs],
                "orig_digests": manifest["digests"]}
    _put_manifest(store, step, manifest)
    return manifest


# ---------------------------------------------------------------------------
# restore & repair
# ---------------------------------------------------------------------------


def _alive_coded(store: NodeStore, step: int, manifest: dict):
    """[(codeword_row, bytes)] for every surviving coded block."""
    perm = manifest["perm"]
    rels = {pos: ARC.format(step=step, i=pos) for pos in range(manifest["n"])}
    present = [(pos, store.get(perm[pos], rel)) for pos, rel in rels.items()
               if store.has(perm[pos], rel)]
    got = digests([raw for _, raw in present])
    return [(pos, raw) for (pos, raw), d in zip(present, got)
            if d == manifest["coded_digests"][pos]]


def restore_blocks(store: NodeStore, step: int, acfg: ArchiveConfig,
                   heal: bool = False, device=None) -> np.ndarray:
    """(k, B) uint8 original blocks from whichever tier survives.

    ``heal=True``: when the read detects missing coded shards (and the step
    is still recoverable), re-materialize them via ``repair`` before
    returning — reads double as scrubs. Raw-array shim over
    :func:`restore_blocks_ex` (which additionally reports how the read
    was served).
    """
    return restore_blocks_ex(store, step, acfg, heal=heal, device=device).data


def restore_blocks_ex(store: NodeStore, step: int, acfg: ArchiveConfig,
                      heal: bool = False, device=None) -> ReadResult:
    """:class:`ReadResult` with ``data`` = (k, B) uint8 original blocks.

    The full-information form of ``restore_blocks``: same bytes, plus the
    serve path (hot / coded / degraded), the nodes that funded the read,
    and whether ``heal=True`` actually repaired shards along the way
    (through ``repair`` on ``device``). The decode runs on the host, as in
    the JAX package.
    """
    manifest = get_manifest(store, step)
    if manifest["tier"] == "hot":
        blocks, nodes = _hot_load_ex(store, step, manifest)
        return _result(blocks, "hot", nodes, False, step)
    if manifest["tier"] == "archive" and manifest.get("streaming"):
        return _restore_streaming(store, step, acfg, manifest, heal=heal, device=device)
    alive = _alive_coded(store, step, manifest)
    healed = False
    if heal and manifest["tier"] == "archive" and len(alive) < manifest["n"]:
        try:
            healed = bool(repair(store, step, acfg, device=device))
        except ValueError:
            # undecodable survivors: with retained replicas the hot tier
            # below still serves the read; without them, fall through to
            # the clear too-few-blocks error instead of dying mid-heal
            if not manifest.get("hot_retained"):
                raise
        manifest = get_manifest(store, step)   # perm may have changed
        alive = _alive_coded(store, step, manifest)
    if len(alive) < manifest["k"]:
        if manifest.get("hot_retained"):
            # two-phase migration: the replicas were never reclaimed, so
            # the hot tier still backs the object
            blocks, nodes = _hot_load_ex(store, step, manifest)
            return _result(blocks, "hot", nodes, healed, step)
        raise FileNotFoundError(
            f"step {step}: only {len(alive)} of n={manifest['n']} coded "
            f"blocks alive, need k={manifest['k']}")
    k, l = manifest["k"], manifest["l"]
    ids = [pos for pos, _ in alive[: manifest["n"]]]
    shards = np.stack([np.frombuffer(raw, dtype=np.uint8)
                       for _, raw in alive])
    shards_w = _words(shards, l)
    # use the first decodable subset (greedy rank selection inside)
    if manifest["tier"] == "archive_classical":
        code = classical.make_code(manifest["n"], k, l=l)
        data_w = classical.decode_np(code, ids, shards_w)
    else:
        code = _manifest_code(manifest)
        data_w = code.decode_np(
            ids, shards_w, block_words=manifest["block_bytes"] // (l // 8))
    blocks = _u8(data_w)
    got = digests([blocks[j].tobytes() for j in range(k)])
    for j in range(k):
        # a real exception (asserts vanish under python -O): a decode that
        # does not match the archived digest must never be returned
        if got[j] != manifest["orig_digests"][j]:
            raise ValueError(
                f"step {step}: decoded block {j} does not match the archived "
                f"digest — corrupt shard set or code mismatch")
    served = "coded" if len(alive) == manifest["n"] else "degraded"
    return _result(blocks, served,
                   [manifest["perm"][pos] for pos in ids], healed, step)


def _manifest_code(manifest: dict) -> codes.ErasureCode:
    """Reconstruct the exact code a manifest describes (any family)."""
    return codes.from_spec(codes.CodeSpec.from_manifest(manifest))


def _restore_streaming(store: NodeStore, step: int, acfg: ArchiveConfig,
                       manifest: dict, heal: bool = False, device=None) -> ReadResult:
    """Stripe-at-a-time restore of a streamed archive, as a ReadResult.

    Reads only each stripe's word range of k helper shards
    (``NodeStore.get_range``) and verifies it against the manifest's
    per-stripe digests as it goes — a corrupt slice demotes that shard to
    missing and the helper set is re-planned, so corruption is routed
    around exactly as ``_alive_coded`` does for whole files, without ever
    reading (or holding) more than k stripes at once.
    """
    code = _manifest_code(manifest)
    k, B, l = manifest["k"], manifest["block_bytes"], manifest["l"]
    wb = l // 8
    stream = manifest["streaming"]
    plan = streaming.plan_stream(B // wb, stream["superchunk_bytes"] // wb,
                                 l=l, num_chunks=stream["num_chunks"])
    perm = manifest["perm"]
    healed = False
    if heal and any(not store.has(perm[pos], ARC.format(step=step, i=pos))
                    for pos in range(manifest["n"])):
        try:
            healed = bool(repair(store, step, acfg, device=device))
        except ValueError:
            if not manifest.get("hot_retained"):
                raise
        manifest = get_manifest(store, step)   # perm may have changed
        perm = manifest["perm"]
    dead = {pos for pos in range(manifest["n"])
            if not store.has(perm[pos], ARC.format(step=step, i=pos))}
    out = np.zeros((k, B), dtype=np.uint8)
    while True:
        alive_ids = [p for p in range(manifest["n"]) if p not in dead]
        helpers = None
        if len(alive_ids) >= k:
            try:
                chosen = codes.independent_rows(code.G[alive_ids], k, l)
                helpers = [alive_ids[p] for p in chosen]
            except ValueError:
                helpers = None
        if helpers is None:
            if manifest.get("hot_retained"):
                # two-phase migration: the replicas still back the object
                blocks, nodes = _hot_load_ex(store, step, manifest)
                return _result(blocks, "hot", nodes, healed, step)
            raise FileNotFoundError(
                f"step {step}: only {len(alive_ids)} decodable of "
                f"n={manifest['n']} coded blocks, need k={k}")
        D = code.decode_matrix(helpers)
        corrupt = None
        for s in range(plan.num_superchunks):
            lo, hi = plan.stripe_span(s)
            rec = stream["stripes"][s]
            slices = []
            for h in helpers:
                raw = store.get_range(perm[h], ARC.format(step=step, i=h),
                                      lo * wb, (hi - lo) * wb)
                if digest(raw) != rec["coded_digests"][h]:
                    corrupt = h
                    break
                slices.append(np.frombuffer(raw, dtype=np.uint8)
                              .view(gf.WORD_DTYPE[l]))
            if corrupt is not None:
                break
            out[:, lo * wb:hi * wb] = _u8(
                gf.gf_matmul_np(D, np.stack(slices), l))
        if corrupt is None:
            break
        dead.add(corrupt)
    for j in range(k):
        if digest(out[j].tobytes()) != manifest["orig_digests"][j]:
            raise ValueError(
                f"step {step}: decoded block {j} does not match the archived "
                f"digest — corrupt shard set or code mismatch")
    served = "coded" if not dead else "degraded"
    return _result(out, served, [perm[h] for h in helpers], healed, step)


def _place_repaired(store: NodeStore, step: int, manifest: dict,
                    missing: list[int], repaired: np.ndarray,
                    replacement_nodes: dict[int, int] | None) -> None:
    """Digest-verify ALL repaired rows against the manifest, then place.

    Verification precedes every write, so a miscomputed repair raises
    ValueError without installing a single block or touching the manifest.
    """
    blobs = []
    for r, pos in enumerate(missing):
        blob = repaired[r].tobytes()
        if digest(blob) != manifest["coded_digests"][pos]:
            raise ValueError(
                f"repair of codeword row {pos} does not match the archived "
                f"digest — refusing to install")
        blobs.append(blob)
    perm = list(manifest["perm"])
    for pos, blob in zip(missing, blobs):
        node = perm[pos]
        if replacement_nodes and pos in replacement_nodes:
            node = replacement_nodes[pos]
            perm[pos] = node
        store.put(node, ARC.format(step=step, i=pos), blob)
    manifest["perm"] = perm
    _put_manifest(store, step, manifest)


def _repair_state(store: NodeStore, step: int,
                  manifest: dict) -> tuple[list[int], list[int], list[bytes]]:
    """(missing, helpers, helper_shards) for one step's repair.

    Liveness is probed by existence (no full-archive hashing); only the k
    helper shards that fund the reconstruction are read, and each is
    digest-verified — a corrupt-but-present helper is demoted to missing
    and the plan recomputed, so corruption is healed, not propagated.
    Raises ValueError when the survivors are not decodable.
    """
    code = _manifest_code(manifest)
    perm = manifest["perm"]
    dead = {pos for pos in range(manifest["n"])
            if not store.has(perm[pos], ARC.format(step=step, i=pos))}
    raws: dict[int, bytes] = {}
    while True:
        missing = sorted(dead)
        if not missing:
            return [], [], []
        alive = [p for p in range(manifest["n"]) if p not in dead]
        helpers = code.repair_helpers(missing, alive)
        for h in helpers:
            if h not in raws:
                raws[h] = store.get(perm[h], ARC.format(step=step, i=h))
        bad = [h for h in helpers
               if digest(raws[h]) != manifest["coded_digests"][h]]
        if not bad:
            return missing, helpers, [raws[h] for h in helpers]
        dead |= set(bad)


def repair(store: NodeStore, step: int, acfg: ArchiveConfig,
           replacement_nodes: dict[int, int] | None = None,
           use_devices: bool | None = None,
           superchunk_bytes: int | None = None, device=None) -> list[int]:
    """Recompute lost coded blocks and place them (on replacements if given).

    Targeted repair: only the missing rows are reconstructed — one GF inner
    product over k digest-verified helper shards
    (``fault_tolerance.repair_plan``), run through the reverse pipelined
    helper chain on ``device`` or, with ``use_devices=False``, one
    ``gf_encode`` launch of the repair matrix. No
    decode-to-object-and-re-encode, and no reads beyond the k helpers.
    Every repaired row is digest-verified against the manifest BEFORE any
    placement (a failed repair raises; it never installs a corrupt block).

    Returns the list of repaired codeword rows; raises ValueError when more
    than n-k rows are lost.
    """
    return repair_many(store, [step], acfg,
                       replacement_nodes=replacement_nodes,
                       use_devices=use_devices,
                       superchunk_bytes=superchunk_bytes, device=device)[0]


def repair_many(store: NodeStore, steps: list[int], acfg: ArchiveConfig,
                replacement_nodes: dict[int, int] | None = None,
                use_devices: bool | None = None,
                stagger: int = 1,
                superchunk_bytes: int | None = None, device=None) -> list[list[int]]:
    """Heal several archived steps CONCURRENTLY (batched repair).

    After a node failure every object archived on the node set lost the
    same codeword rows, so the repairs share helpers and coefficients:
    steps are grouped by (code geometry + seed, block length, missing rows,
    helper set) and each group runs as ONE staggered reverse-chain run on
    ``device`` (B repairs share one cached program) or, with
    ``use_devices=False``, one batched ``gf_encode`` launch. Per step, only
    the k helper
    shards are read (digest-verified; corrupt helpers are demoted to
    missing and repaired too — see ``_repair_state``). Returns the repaired
    rows per step, in step order.

    Streamed archives heal stripe-by-stripe: ``superchunk_bytes`` (or,
    when unset, the geometry recorded in the step's ``streaming`` manifest)
    runs the reverse chains through the streaming executor — per-stripe
    replays of one cached program, cross-stripe scheduled per Li et al. —
    so a lost node on a many-stripe object repairs under the same bounded
    device footprint it archived with. The repaired bytes are identical
    either way (positionwise codes).
    """
    manifests: dict[int, dict] = {}
    layout: dict[tuple, list[int]] = {}
    state: dict[int, tuple[list[int], list[int], list[bytes]]] = {}
    for step in steps:
        manifest = get_manifest(store, step)
        if manifest["tier"] != "archive":
            raise ValueError(f"step {step} not archived")
        manifests[step] = manifest
        missing, helpers, raws = _repair_state(store, step, manifest)
        state[step] = (missing, helpers, raws)
        # steps only batch when they share the CODE as well as the loss
        # pattern — a seed/geometry mismatch must not borrow coefficients
        key = (manifest["block_bytes"], manifest["n"], manifest["k"],
               manifest["l"], manifest["seed"],
               manifest.get("family", "rapidraid"), tuple(missing),
               tuple(helpers))
        layout.setdefault(key, []).append(step)

    out: dict[int, list[int]] = {}
    for (*_, missing_t, helpers_t), grp in layout.items():
        missing = list(missing_t)
        helpers = list(helpers_t)
        if not missing:
            for step in grp:
                out[step] = []
            continue
        l = manifests[grp[0]]["l"]
        code = _manifest_code(manifests[grp[0]])
        shards_w = np.stack([
            _words(np.stack([np.frombuffer(raw, dtype=np.uint8)
                             for raw in state[s][2]]), l)
            for s in grp])                      # (B_obj, |helpers|, B)
        if not code.positionwise:
            # sub-packetized repair (regenerating codes): per-object host
            # combine of the beta-sub-block helper summands
            repaired_w = np.stack([
                code.repair_np(missing, helpers, shards_w[b])
                for b in range(len(grp))])
        else:
            if _use_devices(use_devices):
                nc = acfg.num_chunks
                sc_words = None
                wb = l // 8
                if superchunk_bytes is not None:
                    sc_words = max(1, superchunk_bytes // wb)
                else:
                    stream = manifests[grp[0]].get("streaming")
                    if stream:          # heal with the archive's geometry
                        sc_words = stream["superchunk_bytes"] // wb
                if sc_words is None or sc_words >= shards_w.shape[-1]:
                    # identity plan: the monolithic chunking rules apply
                    sc_words = None
                    while nc > 1 and shards_w.shape[-1] % (gf.LANES[l] * nc):
                        nc //= 2
                repaired_w = _host(repair_lib.pipelined_repair_many(
                    code, helpers, shards_w, missing, num_chunks=nc,
                    stagger=stagger, device=device, superchunk_words=sc_words))
            else:
                # helpers is already the plan's decodable helper set, so
                # the plan over it returns the same set and an aligned R
                _, R = fault_tolerance.repair_plan(code, missing, helpers)
                repaired_w = _encode_static(R, shards_w, l, device)
        for b, step in enumerate(grp):
            _place_repaired(store, step, manifests[step], missing,
                            _u8(repaired_w[b]), replacement_nodes)
            out[step] = missing
    return [out[s] for s in steps]


# ---------------------------------------------------------------------------
# degraded reads: byte ranges without materializing the object
# ---------------------------------------------------------------------------


def read_range(store: NodeStore, step: int, acfg: ArchiveConfig,
               offset: int, nbytes: int, heal: bool = False, device=None) -> bytes:
    """Serve object bytes [offset, offset+nbytes) without full-object decode.

    Raw-bytes shim over :func:`read_range_ex`; see there for the serve-path
    semantics the full-information form additionally reports.
    """
    return read_range_ex(store, step, acfg, offset, nbytes, heal=heal, device=device).data


def _hot_range(store: NodeStore, step: int, manifest: dict,
               offset: int, end: int) -> tuple[bytes, list[int]]:
    """Serve [offset, end) from surviving replicas; -> (bytes, holder nodes).

    Used for the hot tier proper AND as the ``hot_retained`` fallback when
    an archived object's survivors are not decodable mid two-phase reclaim.
    """
    B = manifest["block_bytes"]
    out = bytearray()
    nodes = []
    for j in range(offset // B, (end - 1) // B + 1):
        a = max(offset, j * B) - j * B
        b = min(end, (j + 1) * B) - j * B
        rel = HOT.format(step=step, j=j)
        holders = [i for i, held in enumerate(manifest["placement"])
                   if j in held and store.has(i, rel)]
        if not holders:
            raise FileNotFoundError(
                f"hot block {j} of step {step} lost on all replicas")
        out += store.get_range(holders[0], rel, a, b - a)
        nodes.append(holders[0])
    return bytes(out), nodes


def read_range_ex(store: NodeStore, step: int, acfg: ArchiveConfig,
                  offset: int, nbytes: int, heal: bool = False,
                  device=None) -> ReadResult:
    """:class:`ReadResult` with ``data`` = object bytes [offset, offset+nbytes).

    Hot tier: slice reads straight from a surviving replica. Archive tier:
    a DEGRADED READ — only the covering word range of k surviving shards is
    read from disk (``NodeStore.get_range``) and only the touched blocks'
    rows of the decode matrix are applied, so a small read costs k small
    reads regardless of how many shards were lost. Slice reads cannot be
    digest-checked (the manifest pins whole-block digests); ``heal=True``
    first re-materializes any missing shards (full repair, digest-verified)
    so subsequent reads run non-degraded.

    Offsets address the padded k*block_bytes object; out-of-bounds or
    inverted ranges raise ValueError (no silent clamping — a caller that
    wants clamp-to-EOF semantics owns the clamp, as
    checkpoint readers do against their ``blob_len``). The decode runs on
    the host, as in the JAX package; ``heal=True`` repairs on ``device``.
    Streamed archives (manifest ``streaming``) serve ranges identically:
    positionwise stripes concatenate to the same coded bytes, so the
    range read touches exactly the stripes that cover it.
    """
    manifest = get_manifest(store, step)
    k, B, l = manifest["k"], manifest["block_bytes"], manifest["l"]
    end = offset + nbytes
    if offset < 0 or nbytes < 0 or end > k * B:
        raise ValueError(
            f"read_range: range [{offset}, {end}) is "
            f"{'inverted' if nbytes < 0 else 'out of bounds'} for step "
            f"{step}'s {k * B}-byte object (offset={offset}, "
            f"nbytes={nbytes})")
    if nbytes == 0:
        served = "hot" if manifest["tier"] == "hot" else "coded"
        return _result(b"", served, [], False, step)
    j0, j1 = offset // B, (end - 1) // B

    if manifest["tier"] == "hot":
        out, nodes = _hot_range(store, step, manifest, offset, end)
        return _result(out, "hot", nodes, False, step)

    if manifest["tier"] != "archive":
        # classical tier: fall back to full restore (no RapidRAID decode)
        res = restore_blocks_ex(store, step, acfg, device=device)
        return _result(res.data.reshape(-1)[offset:end].tobytes(),
                       res.served_from, res.nodes, res.healed, step)

    code = _manifest_code(manifest)
    if not code.positionwise:
        # sub-packetized shards have no positionwise word ranges — serve
        # the range from a full (digest-verified) restore
        res = restore_blocks_ex(store, step, acfg, heal=heal, device=device)
        return _result(res.data.reshape(-1)[offset:end].tobytes(),
                       res.served_from, res.nodes, res.healed, step)

    perm = manifest["perm"]
    healed = False
    if heal and any(not store.has(perm[pos], ARC.format(step=step, i=pos))
                    for pos in range(manifest["n"])):
        # existence probe only — slice reads cannot digest-check, so heal
        # here targets lost shards; a full scrub is repair()/repair_many()
        try:
            healed = bool(repair(store, step, acfg, device=device))
        except ValueError:
            # undecodable survivors: retained replicas (below) still serve
            # the range; without them the decodability check raises clearly
            if not manifest.get("hot_retained"):
                raise
        manifest = get_manifest(store, step)
        perm = manifest["perm"]
    alive_ids = [pos for pos in range(manifest["n"])
                 if store.has(perm[pos], ARC.format(step=step, i=pos))]
    try:
        chosen = codes.independent_rows(code.G[alive_ids], k, l)
    except ValueError as e:
        if manifest.get("hot_retained"):
            # two-phase migration window: survivors are not decodable but
            # the replicas were never reclaimed — the hot tier still backs
            # the object (same fallback as restore_blocks_ex)
            out, nodes = _hot_range(store, step, manifest, offset, end)
            return _result(out, "hot", nodes, healed, step)
        raise FileNotFoundError(
            f"step {step}: survivors not decodable ({e})") from None
    helpers = [alive_ids[p] for p in chosen]

    # per touched block: read ONLY its word-aligned slice of each helper
    # shard and apply that block's row of the decode matrix
    # (degraded_read_np's math with D hoisted out of the loop)
    D = code.decode_matrix(helpers)
    wb = l // 8
    dt = gf.WORD_DTYPE[l]
    out = bytearray()
    for j in range(j0, j1 + 1):
        a = max(offset, j * B) - j * B
        b = min(end, (j + 1) * B) - j * B
        lo = (a // wb) * wb
        hi = -(-b // wb) * wb
        slices_w = np.stack([
            np.frombuffer(
                store.get_range(perm[h], ARC.format(step=step, i=h),
                                lo, hi - lo), dtype=np.uint8).view(dt)
            for h in helpers])
        row = _u8(gf.gf_matmul_np(D[[j]], slices_w, l))[0]
        out += row[a - lo:b - lo].tobytes()
    served = "coded" if len(alive_ids) == manifest["n"] else "degraded"
    return _result(bytes(out), served, [perm[h] for h in helpers],
                   healed, step)


def publish_device_archive(store: NodeStore, step: int, acfg: ArchiveConfig,
                           blocks: np.ndarray, coded: np.ndarray,
                           blob_len: int, state_key: str | None = None
                           ) -> dict:
    """Place an already-encoded checkpoint (device-direct write path) into
    the coded tier and publish its manifest.

    A device-direct writer computes ``blocks`` (k, B) and ``coded`` (n, B)
    on the card; this is the storage-side half — shard
    placement (codeword row i on node i), digests for both the original
    blocks (what host restore verifies decode against) and the coded blobs
    (what liveness probes verify), and a manifest every existing reader —
    ``restore_blocks`` / ``repair`` / ``read_range`` — consumes unchanged.
    No hot replicas ever hit disk on this path.
    """
    if blocks.shape != (acfg.k, blocks.shape[1]) or blocks.dtype != np.uint8:
        raise ValueError(f"blocks must be (k={acfg.k}, B) uint8, "
                         f"got {blocks.shape} {blocks.dtype}")
    if coded.shape != (acfg.n, blocks.shape[1]):
        raise ValueError(f"coded must be (n={acfg.n}, B={blocks.shape[1]}), "
                         f"got {coded.shape}")
    orig_digests = [digest(blocks[j].tobytes()) for j in range(acfg.k)]
    coded_blobs = [coded[i].tobytes() for i in range(acfg.n)]
    for pos in range(acfg.n):
        store.put(pos, ARC.format(step=step, i=pos), coded_blobs[pos])
    manifest = {
        "step": step, "tier": "archive", "n": acfg.n, "k": acfg.k,
        "l": acfg.l, "seed": acfg.seed, "family": acfg.family,
        "block_bytes": int(blocks.shape[1]),
        "digests": orig_digests,
        # nominal hot placement (no replicas ever existed): keeps the
        # manifest schema one shape across write paths
        "placement": [list(h) for h in rapidraid.placement(acfg.n, acfg.k)],
        "perm": list(range(acfg.n)),
        "coded_digests": [digest(b) for b in coded_blobs],
        "orig_digests": orig_digests,
        "blob_len": int(blob_len),
        "device_direct": True,
    }
    if state_key is not None:
        manifest["state_key"] = state_key
    _put_manifest(store, step, manifest)
    return manifest


def publish_streaming_archive(store: NodeStore, step: int,
                              acfg: ArchiveConfig, blocks: np.ndarray,
                              blob_len: int, superchunk_bytes: int,
                              state_key: str | None = None,
                              use_devices: bool | None = None, device=None) -> dict:
    """Stream an in-memory (k, B) block set into the coded tier under a
    bounded device footprint.

    The checkpoint streaming route: the state's blocks are already on the
    host, but the ENCODE must not materialize the object on the card —
    each super-chunk stripe runs through one cached chain program and
    frames straight into atomic ``put_stream`` writers. Same
    manifest contract as ``publish_device_archive`` plus the ``streaming``
    stripe records; no hot replicas ever hit disk.
    """
    code = acfg.code()
    if not code.positionwise:
        raise ValueError(
            f"publish_streaming_archive: {code.family} is sub-packetized — "
            f"stripe concatenation is not a codeword")
    if blocks.ndim != 2 or blocks.shape[0] != acfg.k \
            or blocks.dtype != np.uint8:
        raise ValueError(f"blocks must be (k={acfg.k}, B) uint8, "
                         f"got {blocks.shape} {blocks.dtype}")
    n, l = acfg.n, acfg.l
    wb = l // 8
    B = blocks.shape[1]
    nc = acfg.num_chunks
    plan = streaming.plan_stream(B // wb, max(1, superchunk_bytes // wb),
                                 l=l, num_chunks=nc)
    if not plan.streaming:
        while nc > 1 and (B // wb) % (gf.LANES[l] * nc):
            nc //= 2
    data_w = _words(blocks, l)
    writers = [store.put_stream(pos, ARC.format(step=step, i=pos))
               for pos in range(n)]
    stripes: list[dict] = []

    def sink(s: int, out_w: np.ndarray) -> None:
        frame = _u8(np.asarray(out_w))
        recs = []
        for pos in range(n):
            blob = frame[pos].tobytes()
            writers[pos].write(blob)
            recs.append(digest(blob))
        stripes.append({"words": int(out_w.shape[-1]),
                        "coded_digests": recs})

    try:
        if _use_devices(use_devices) and code.supports_chain_encode:
            fn = chain_lib.encode_program(code, plan.sc_words, nc, device=device)
            x = torch.from_numpy(data_w)
            streaming.run_words(fn, x if plan.streaming else x.to(fn.device), plan,
                                sink=sink)
        else:
            for s in range(plan.num_superchunks):
                lo, hi = plan.stripe_span(s)
                stripe = data_w[:, lo:hi]
                if hi - lo < plan.sc_words:   # zero-pad the tail stripe
                    stripe = np.concatenate(
                        [stripe, np.zeros((acfg.k, plan.sc_words - (hi - lo)),
                                          data_w.dtype)], axis=1)
                sink(s, np.asarray(code.encode_np(stripe))[:, :hi - lo])
    except BaseException:
        for w in writers:
            w.abort()
        raise
    for w in writers:
        w.close()

    manifest = {
        "step": step, "tier": "archive", "n": n, "k": acfg.k, "l": l,
        "seed": acfg.seed, "family": acfg.family, "block_bytes": int(B),
        "digests": [digest(blocks[j].tobytes()) for j in range(acfg.k)],
        "placement": [list(h) for h in rapidraid.placement(n, acfg.k)],
        "perm": list(range(n)),
        "coded_digests": [w.digest() for w in writers],
        "blob_len": int(blob_len),
        "streaming": {
            "num_superchunks": int(plan.num_superchunks),
            "superchunk_bytes": int(plan.sc_words * wb),
            "num_chunks": int(nc),
            "stripes": stripes,
        },
    }
    manifest["orig_digests"] = manifest["digests"]
    if state_key is not None:
        manifest["state_key"] = state_key
    _put_manifest(store, step, manifest)
    return manifest


# ---------------------------------------------------------------------------
# manifests (replicated on every node)
# ---------------------------------------------------------------------------


def _put_manifest(store: NodeStore, step: int, manifest: dict) -> None:
    data = json.dumps(manifest).encode()
    for i in range(store.n_nodes):
        store.put(i, MANIFEST.format(step=step), data)


_REQUIRED_KEYS = ("step", "tier", "n", "k", "l", "seed", "block_bytes")
_TIER_KEYS = {
    "hot": ("placement", "digests"),
    "archive": ("placement", "perm", "coded_digests", "orig_digests"),
    "archive_classical": ("placement", "perm", "coded_digests",
                          "orig_digests"),
}


def _validate_manifest(manifest, step: int) -> dict:
    """Clear ValueError (never a downstream KeyError) for damaged manifests."""
    if not isinstance(manifest, dict):
        raise ValueError(f"step {step}: manifest is {type(manifest).__name__},"
                         f" not an object")
    tier = manifest.get("tier")
    if tier not in _TIER_KEYS:
        raise ValueError(f"step {step}: manifest tier {tier!r} unknown "
                         f"(want one of {sorted(_TIER_KEYS)})")
    missing = [key for key in _REQUIRED_KEYS + _TIER_KEYS[tier]
               if key not in manifest]
    if missing:
        raise ValueError(f"step {step}: manifest ({tier}) is missing "
                         f"required keys {missing} — corrupt or "
                         f"partially written")
    stream = manifest.get("streaming")
    if stream is not None:
        want = ("num_superchunks", "superchunk_bytes", "num_chunks",
                "stripes")
        absent = [key for key in want if key not in stream]
        if absent:
            raise ValueError(f"step {step}: streaming manifest record is "
                             f"missing keys {absent}")
        if len(stream["stripes"]) != stream["num_superchunks"]:
            raise ValueError(
                f"step {step}: streaming record claims "
                f"{stream['num_superchunks']} super-chunks but carries "
                f"{len(stream['stripes'])} stripe records")
    family = manifest.get("family", "rapidraid")
    if family not in codes.families():
        raise ValueError(
            f"step {step}: manifest names unknown code family {family!r} "
            f"— registered families: {', '.join(codes.families())}")
    return manifest


def get_manifest(store: NodeStore, step: int) -> dict:
    """First VALID manifest replica; a corrupt replica falls through to the
    next node's copy, and only-corrupt-copies raises a clear ValueError
    (so a scrubber can report the step instead of dying on JSON internals).
    """
    rel = MANIFEST.format(step=step)
    errors: list[str] = []
    found = False
    for i in range(store.n_nodes):
        if not store.has(i, rel):
            continue
        found = True
        try:
            return _validate_manifest(json.loads(store.get(i, rel)), step)
        except ValueError as e:           # JSONDecodeError is a ValueError
            errors.append(f"node {i}: {e}")
    if found:
        raise ValueError(
            f"step {step}: every manifest replica is corrupt — "
            + "; ".join(errors))
    raise FileNotFoundError(f"no manifest for step {step}")


def list_steps(store: NodeStore) -> list[int]:
    """Steps with a published manifest on any node.

    Unparseable names in a ``manifests/`` directory raise a clear
    ValueError naming the file; a ``.json.tmp`` is an interrupted
    ``NodeStore.put`` — ignored when the published manifest exists
    somewhere, reported when the step has nothing but partial writes.
    """
    import os
    import re
    pat = re.compile(r"^(\d{8})\.json(\.tmp)?$")
    steps: set[int] = set()
    partial: set[int] = set()
    for i in range(store.n_nodes):
        d = store.path(i, "manifests")
        if not os.path.isdir(d):
            continue
        for f in os.listdir(d):
            m = pat.match(f)
            if m is None:
                raise ValueError(
                    f"node {i}: unrecognized file {f!r} in manifests/ — "
                    f"want NNNNNNNN.json")
            (partial if m.group(2) else steps).add(int(m.group(1)))
    orphans = partial - steps
    if orphans:
        raise ValueError(
            f"steps {sorted(orphans)} have only partially-written manifests "
            f"(interrupted put left .json.tmp and no published copy)")
    return sorted(steps)
