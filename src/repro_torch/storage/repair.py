"""Pipelined repair & degraded reads (repair pipelining, Li et al.; PAPERS.md).

Single-shard repair is conventionally a star: the replacement node pulls k
whole shards through its one NIC. Repair pipelining slices it the way
RapidRAID slices encoding: the k helpers form a chain, each adds its term of

  c_lost = xor_h  R[:, h] * c_h          (R from repro_torch.core.fault_tolerance)

to the partial reconstructions streaming past, and the replacement node at
the chain's receiving end gets the finished shards.

On one card:

* ``pipelined_repair`` runs the helper chain backwards — position p is
  played by helper h-1-p and the wire flows toward position 0, the
  replacement (``pipeline.position_nodes(h, reverse=True)``) — as the
  forward schedule over the chain positions: one ``repair_tick`` launch per
  tick, each position reading its helper's shard in place through a row
  table, the wire carrying (|missing|, S) partial sums, so up to n-k lost
  shards are rebuilt in ONE pass;
* ``star_repair`` applies R to the k helper shards in one ``gf_encode``
  launch;
* ``degraded_read`` serves a word range of requested object blocks from
  the same range of the survivors' shards: the requested rows of the
  decode matrix in one ``gf_encode`` launch, nothing else read.

The repair plan (helpers + R, a host Gaussian elimination), its tick
operands (row table, product tables) and the decode matrix of a survivor
set are cached, and each pipelined repair runs one cached program per
(code, missing rows, survivors, batch, stripe width, num_chunks, stagger,
device) key (``repro_torch.core.jitcache``), so warm calls do no host
algebra, build no tables and copy none to the card. Entry points run on the
card unless the caller passes ``device="cpu"``, where the ticks and the
encode run the kernels' plain PyTorch versions.

``pipelined_repair_many`` repairs the same lost rows of B objects (every
object archived on a failed node set) as staggered reverse chains over the
same helpers, one ``repair_tick`` launch a tick over the object window
(``repro_torch.storage.multi``), reading the helpers' shards in place from
the (B_obj, len(ids), B) batch. Both pipelined repairs take
``superchunk_words`` / ``sink`` and stream a host-resident shard set stripe
by stripe, as ``storage.chain`` does; a streamed repair copies in every
survivor shard it is given, so a caller passes only the plan's helpers
(``repair_plan``) to copy no more than the chain reads, as
``storage.archive`` does.

``num_chunks=None`` and ``stagger=None`` resolve through the tuner
(``repro_torch.core.autotune``), over a chain of the plan's helpers. Not
ported yet: ``mesh=``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import autotune, fault_tolerance, gf, pipeline, streaming
from repro_torch.core.codes import ErasureCode
from repro_torch.kernels.gf_encode import kernel, ops
from repro_torch.storage import multi
from repro_torch.storage.chain import (_check_chunking, _resolve_device, _words,
                                       column_bitplanes, device_tables, run_program,
                                       stream_plan)


@functools.lru_cache(maxsize=None)
def _repair_plan_cached(code: ErasureCode, missing: tuple[int, ...],
                        ids: tuple[int, ...]):
    """Memoized ``code.repair_plan``: a pure function of (code, missing,
    survivors) that costs a host Gaussian elimination. R is read-only."""
    helpers, R = fault_tolerance.repair_plan(code, list(missing), list(ids))
    R.setflags(write=False)
    return tuple(helpers), R


@functools.lru_cache(maxsize=256)
def _repair_operands_cached(code: ErasureCode, missing: tuple[int, ...],
                            ids: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """The pipelined repair's tick operands for a plan, by chain position
    (``pipeline.position_nodes(h, reverse=True)``): the row of each
    position's helper among the survivors' shards, (h,) int32, and its
    product tables, (h, packs, l // 8, 256) uint32 (``kernel.repair_tables``
    of R's column). Read-only."""
    helpers, R = _repair_plan_cached(code, missing, ids)
    order = pipeline.position_nodes(len(helpers), reverse=True)
    rows = np.array([ids.index(helpers[p]) for p in order], dtype=np.int32)
    tables = kernel.repair_tables(column_bitplanes(R, code.l)[order], code.l)
    rows.setflags(write=False)
    tables.setflags(write=False)
    return rows, tables


def repair_operands(code: ErasureCode, missing, ids, device) -> tuple[np.ndarray, torch.Tensor]:
    """(row table on the host, product tables as int32 on ``device``) of
    ``pipelined_repair``'s ticks; raises ValueError if ``ids`` cannot
    rebuild ``missing``."""
    rows, tables = _repair_operands_cached(code, tuple(int(m) for m in missing),
                                           tuple(int(i) for i in ids))
    return rows, device_tables(tables, device)


@functools.lru_cache(maxsize=256)
def _decode_matrix_cached(code: ErasureCode, ids: tuple[int, ...]) -> np.ndarray:
    D = code.decode_matrix(list(ids))
    D.setflags(write=False)
    return D


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------


def repair_np(code: ErasureCode, missing, ids, shards) -> np.ndarray:
    """Reconstruct lost codeword rows on the host (numpy reference).

    ids: surviving codeword rows; shards (len(ids), B) their blocks.
    Returns (len(missing), B) — bit-exact rows of ``encode_np``'s output.
    Raises ValueError when the survivors are not decodable.
    """
    ids = list(ids)
    shards = np.asarray(shards)
    if not code.positionwise:
        return code.repair_np(list(missing), ids, shards)
    helpers, R = _repair_plan_cached(code, tuple(missing), tuple(ids))
    rows = [ids.index(h) for h in helpers]
    return gf.gf_matmul_np(R, shards[rows], code.l)


# ---------------------------------------------------------------------------
# device paths
# ---------------------------------------------------------------------------


def _survivor_shards(code: ErasureCode, ids, shards, what: str,
                     device=None) -> torch.Tensor:
    """The survivors' shards as words (on ``device``; None: where they lie)."""
    if not code.positionwise:
        raise ValueError(f"{what}: {code.family} shards are sub-packetized — "
                         f"use code.repair_np")
    return _words(shards, code.l, len(ids), what, device)


def _build_repair(code: ErasureCode, missing: tuple[int, ...], ids: tuple[int, ...],
                  B_obj: int | None, sc_words: int, num_chunks: int, stagger: int,
                  device: torch.device) -> streaming.Program:
    """The pipelined repair program of one plan and stripe geometry: the
    survivors' shards, (len(ids), sc_words) or for B_obj objects (B_obj,
    len(ids), sc_words), -> the lost rows, (|missing|, sc_words) or (B_obj,
    |missing|, sc_words). The helpers form a reverse chain, each position
    reading its helper's shard in place through the row table."""
    l = code.l
    rows_table, tables = repair_operands(code, missing, ids, device)
    h, rows = len(rows_table), len(missing)
    S = sc_words // gf.LANES[l] // num_chunks
    if B_obj is None:
        def ticks(src, out, wires):
            packed, out = src[:, None], out[None]    # (len(ids), 1, Bp), (1, rows, Bp)

            def step(wire_in, wire_out, t, lo, count):
                ops.repair_tick(wire_in, wire_out, packed, rows_table, out, tables, l, t,
                                num_chunks, lo, count, head_zero=True)
            pipeline.software_pipeline(step, h, num_chunks, (h, 1, rows, S), device=device,
                                       wires=wires)

        return streaming.Program(device=device, l=l, sc_words=sc_words, in_lead=(len(ids),),
                                 out_lead=(rows,), wire_shape=(h, 1, rows, S), ticks=ticks)

    def ticks_many(src, out, wires):
        packed = src.transpose(0, 1)                 # (len(ids), B_obj, Bp), a view

        def step(wire_in, wire_out, t, lo, count):
            ops.repair_tick(wire_in, wire_out, packed, rows_table, out, tables, l, t,
                            num_chunks, lo, count, head_zero=True, stagger=stagger)
        pipeline.staggered_pipeline(step, h, num_chunks, (rows, S), num_objects=B_obj,
                                    stagger=stagger, device=device, wires=wires)

    W = pipeline.window_size(num_chunks, B_obj, stagger)
    return streaming.Program(device=device, l=l, sc_words=sc_words,
                             in_lead=(B_obj, len(ids)), out_lead=(B_obj, rows),
                             wire_shape=(h, W, rows, S), ticks=ticks_many)


def pipelined_repair(code: ErasureCode, ids, shards, missing,
                     num_chunks: int | None = None, device=None,
                     superchunk_words: int | None = None, sink=None) -> torch.Tensor | None:
    """Repair <= n-k lost shards by streaming k survivors through a chain.

    ids: surviving codeword rows; shards (len(ids), B) words (numpy or a
    tensor). The k chosen helpers form a reverse chain toward the
    replacement node; each tick is one ``repair_tick`` launch over the
    active helpers, which read their shards where they lie in ``shards``
    (no gather), and the replacement ends up with the repaired
    (|missing|, B) words, returned on ``device``. ``num_chunks=None`` is
    tuned (``autotune.num_chunks_for``). ``superchunk_words`` / ``sink`` stream the
    repair stripe by stripe (``storage.chain.pipelined_encode``), so a lost
    node on a many-stripe object heals without the card ever holding the
    whole shards. Raises ValueError if the survivors are not decodable.
    """
    what = "pipelined_repair"
    ids = tuple(int(i) for i in ids)
    missing = tuple(int(m) for m in missing)
    dev = _resolve_device(device)
    shards = _survivor_shards(code, ids, shards, what)
    B = shards.shape[1]
    if num_chunks is None:
        helpers, _ = _repair_plan_cached(code, missing, ids)
        num_chunks = autotune.num_chunks_for("repair", code, B, chain_len=len(helpers),
                                             device=dev)
    plan, num_chunks = stream_plan(B, superchunk_words, code.l, num_chunks, what)
    return run_program(
        ("repair", code.cache_key, missing, ids, plan.sc_words, num_chunks, dev),
        lambda: _build_repair(code, missing, ids, None, plan.sc_words, num_chunks, 0, dev),
        shards, plan, sink, dev)


def pipelined_repair_many(code: ErasureCode, ids, shards, missing,
                          num_chunks: int | None = None, stagger: int | None = None,
                          device=None, superchunk_words: int | None = None,
                          sink=None) -> torch.Tensor | None:
    """B_obj concurrent repairs as staggered reverse chains over one helper set.

    ids/missing are shared across objects (after a node failure every
    object archived on that node set lost the same rows). ``shards``
    (B_obj, len(ids), B) words, numpy or a tensor -> repaired
    (B_obj, |missing|, B) words on ``device``. Each tick is one
    ``repair_tick`` launch over the object window; each chain position
    reads its helper's shard of object b in place from ``shards``.
    ``num_chunks=None`` and ``stagger=None`` are tuned (``autotune``).
    ``superchunk_words`` / ``sink`` stream the batch stripe by
    stripe. Raises ValueError if the survivors are not decodable.
    """
    what = "pipelined_repair_many"
    if not code.positionwise:
        raise ValueError(f"{what}: {code.family} shards are "
                         f"sub-packetized — use code.repair_np")
    ids = tuple(int(i) for i in ids)
    missing = tuple(int(m) for m in missing)
    dev = _resolve_device(device)
    shards = multi.batch_words(shards, code.l, len(ids), what, "shards", "len(ids)")
    B_obj, _, B = shards.shape
    if num_chunks is None:
        helpers, _ = _repair_plan_cached(code, missing, ids)
        num_chunks = autotune.num_chunks_for("repair_many", code, B, chain_len=len(helpers),
                                             extra_key=(B_obj,), device=dev)
    plan, num_chunks = stream_plan(B, superchunk_words, code.l, num_chunks, what)
    stagger = multi.tuned_stagger(code, B_obj, num_chunks, stagger, dev, what)
    return run_program(
        ("repair_many", code.cache_key, missing, ids, B_obj, plan.sc_words, num_chunks,
         stagger, dev),
        lambda: _build_repair(code, missing, ids, B_obj, plan.sc_words, num_chunks, stagger,
                              dev),
        shards, plan, sink, dev)


def star_repair(code: ErasureCode, ids, shards, missing, device=None) -> torch.Tensor:
    """Star repair: the replacement node gathers k whole helper shards and
    reconstructs locally, one ``gf_encode`` launch of R over them."""
    dev = _resolve_device(device)
    shards = _survivor_shards(code, ids, shards, "star_repair", dev)
    _check_chunking(shards.shape[1], code.l, 1, "star_repair")
    ids = [int(i) for i in ids]
    helpers, R = _repair_plan_cached(code, tuple(int(m) for m in missing), tuple(ids))
    rows = [ids.index(h) for h in helpers]
    packed = gf.pack_u32(shards, code.l)
    if rows != list(range(len(ids))):   # select through the int32 lanes
        packed = packed[torch.tensor(rows, dtype=torch.int64, device=dev)]
    return gf.unpack_u32(ops.encode_packed(R, packed, code.l), code.l)


# ---------------------------------------------------------------------------
# degraded reads: decode only the requested slice
# ---------------------------------------------------------------------------


def degraded_read_np(code: ErasureCode, ids, shard_slices,
                     block_ids) -> np.ndarray:
    """Serve object blocks from coded shards WITHOUT full-object decode.

    ids: surviving codeword rows; shard_slices (len(ids), W) the SAME word
    range of every surviving shard (only the requested slice is ever read);
    block_ids: which original blocks the caller wants. Returns
    (len(block_ids), W) — o_j[w0:w1] = xor_h D[j, h] * c_h[w0:w1], since
    decode is position-wise over words.
    """
    D = code.decode_matrix(list(ids))
    return gf.gf_matmul_np(D[list(block_ids)], np.asarray(shard_slices),
                           code.l)


def degraded_read(code: ErasureCode, ids, shard_slices, block_ids,
                  device=None) -> torch.Tensor:
    """Kernel path of ``degraded_read_np``: one ``gf_encode`` launch applies
    the requested rows of the decode matrix to the packed slices. Returns
    (len(block_ids), W) words on ``device``."""
    dev = _resolve_device(device)
    ids = tuple(int(i) for i in ids)
    slices = _words(shard_slices, code.l, len(ids), "degraded_read", dev)
    _check_chunking(slices.shape[1], code.l, 1, "degraded_read")
    D = _decode_matrix_cached(code, ids)[list(block_ids)]
    out = ops.encode_packed(D, gf.pack_u32(slices, code.l), code.l)
    return gf.unpack_u32(out, code.l)
