"""Staggered multi-object pipelined archival over one node chain.

The paper's second headline result (§VI, Fig. 4): when many objects are
archived concurrently, interleaving their coding chains over the SAME node
set keeps every node busy — object b's chain starts ``stagger`` ticks after
object b-1's, so node i combines object b's chunk while object b+1's chunk
is still in flight toward it:

  ticks(loop)      = B * (C + n - 1)
  ticks(staggered) = C + n - 1 + (B - 1) * stagger

On one card each tick is ONE launch of the tick kernel over the nodes in
the run's span, whose grid's object axis runs over the ``window_size``
slots of the wire (``repro_torch.core.pipeline.staggered_pipeline``): per
tick the work of at most W objects a node. ``stagger=1`` overlaps the
chains the most; ``stagger=num_chunks`` runs them back to back, one object
a node a tick.

Layouts are the JAX package's: objects (B_obj, k, B) -> codewords
(B_obj, n, B), survivors' shards (B_obj, n_alive, B) -> objects
(B_obj, k, B). The ticks read the objects' replica blocks and the
survivors' shards where they lie and write each object's rows in place,
through the strides of the object and node axes: no batch is transposed or
gathered. The operands are the single-object paths' cached ones
(``chain.placement_slots``, ``chain.product_tables``,
``chain.decode_tables``).

Entry points run on the card unless the caller passes ``device="cpu"``,
where the ticks run the kernels' plain PyTorch versions. Each runs one
cached program per (code, survivor set, batch, stripe width, num_chunks,
stagger, device) key, and ``superchunk_words`` / ``sink`` stream a
host-resident batch stripe by stripe, as in ``storage.chain``.

Not ported yet: the ``mesh=`` / ``order=`` placement of chain positions on
devices and the tuning behind ``num_chunks=None`` and ``stagger=None``,
which here take ``chain.DEFAULT_NUM_CHUNKS`` and a stagger of 1 (the
tuner's default).
"""
from __future__ import annotations

import torch

from repro_torch.core import gf, pipeline, streaming
from repro_torch.core.codes import ErasureCode
from repro_torch.kernels.gf_encode import ops
from repro_torch.storage.chain import (_resolve_device, decode_tables, device_tables,
                                       identity_rows, placement_slots, product_tables,
                                       run_program, stream_plan)

DEFAULT_STAGGER = 1


def check_stagger(stagger: int | None, what: str) -> int:
    """The stagger (``DEFAULT_STAGGER`` for None), checked to be >= 1."""
    if stagger is None:
        return DEFAULT_STAGGER
    if stagger < 1:
        raise ValueError(f"{what}: stagger must be >= 1, got {stagger}")
    return int(stagger)


def batch_words(x, l: int, rows: int, what: str, name: str, rows_name: str,
                device: torch.device | None = None) -> torch.Tensor:
    """A (B_obj, rows, B) batch of GF(2^l) words as a tensor on ``device``
    (None: where it lies, the host for a numpy array)."""
    x = torch.as_tensor(x, device=device)
    if x.dim() != 3 or x.shape[1] != rows:
        raise ValueError(f"{what}: {name} {tuple(x.shape)} must be "
                         f"(B_obj, {rows_name}={rows}, B)")
    if x.dtype != gf.TORCH_WORD_DTYPE[l]:
        raise ValueError(f"{what}: words must be {gf.TORCH_WORD_DTYPE[l]} for "
                         f"GF(2^{l}), got {x.dtype}")
    return x


def _build_encode_many(code: ErasureCode, B_obj: int, sc_words: int, num_chunks: int,
                       stagger: int, device: torch.device) -> streaming.Program:
    """The staggered encode program: (B_obj, k, sc_words) -> (B_obj, n,
    sc_words) words. Every (node, object) with a chunk at a tick reads its
    replica blocks in place, writes its codeword chunk into object b's row
    of the output and forwards its wire in slot b % W."""
    l, n = code.l, code.n
    slots = placement_slots(code)
    tables = device_tables(product_tables(code), device)
    S = sc_words // gf.LANES[l] // num_chunks
    W = pipeline.window_size(num_chunks, B_obj, stagger)

    def ticks(src, out, wires):
        out_nodes = out.transpose(0, 1)              # (n, B_obj, Bp), a view

        def step(wire_in, wire_out, t, lo, count):
            ops.chain_tick(wire_in, wire_out, src, slots, out_nodes, tables, l, t,
                           num_chunks, lo, count, stagger)
        pipeline.staggered_pipeline(step, n, num_chunks, (S,), num_objects=B_obj,
                                    stagger=stagger, device=device, wires=wires)

    return streaming.Program(device=device, l=l, sc_words=sc_words, in_lead=(B_obj, code.k),
                             out_lead=(B_obj, n), wire_shape=(n, W, S), ticks=ticks)


def pipelined_encode_many(code: ErasureCode, objects, num_chunks: int | None = None,
                          stagger: int | None = None, device=None,
                          superchunk_words: int | None = None,
                          sink=None) -> torch.Tensor | None:
    """Archive B_obj objects concurrently: (B_obj, k, B) -> (B_obj, n, B).

    ``objects`` is a numpy array or a tensor of uint8 (GF(2^8)) or uint16
    (GF(2^16)) words; the result is a tensor of words on ``device``. Each
    tick is one ``chain_tick`` launch over the nodes in the run's span:
    every (node, object) with a chunk at that tick reads its replica blocks
    in place through the slot table, writes its codeword chunk straight
    into object b's row of the output, and forwards its wire in slot
    b % W. ``num_chunks=None`` takes ``chain.DEFAULT_NUM_CHUNKS``,
    ``stagger=None`` takes 1. ``superchunk_words`` streams the whole batch
    stripe by stripe, each stripe one staggered run of the same cached
    program, and ``sink(s, (B_obj, n, W) words)`` takes each stripe's
    result instead of an assembled batch.
    """
    if not code.supports_chain_encode:
        raise ValueError(
            f"pipelined_encode_many: {code.family} has no chain schedule — "
            f"use code.encode_np or the fused-kernel archive path")
    what = "pipelined_encode_many"
    dev = _resolve_device(device)
    objects = batch_words(objects, code.l, code.k, what, "objects", "k")
    B_obj = objects.shape[0]
    plan, num_chunks = stream_plan(objects.shape[2], superchunk_words, code.l, num_chunks,
                                   what)
    stagger = check_stagger(stagger, what)
    return run_program(
        ("encode_many", code.cache_key, B_obj, plan.sc_words, num_chunks, stagger, dev),
        lambda: _build_encode_many(code, B_obj, plan.sc_words, num_chunks, stagger, dev),
        objects, plan, sink, dev)


def _build_decode_many(code: ErasureCode, ids: tuple[int, ...], B_obj: int,
                       sc_words: int, num_chunks: int, stagger: int,
                       device: torch.device) -> streaming.Program:
    """The staggered decode program: (B_obj, len(ids), sc_words) shards ->
    (B_obj, k, sc_words) words, every shard read in place."""
    l, k, n_alive = code.l, code.k, len(ids)
    tables = device_tables(decode_tables(code, ids), device)
    rows = identity_rows(n_alive)                    # node i reads shard i
    S = sc_words // gf.LANES[l] // num_chunks
    W = pipeline.window_size(num_chunks, B_obj, stagger)

    def ticks(src, out, wires):
        packed = src.transpose(0, 1)                 # (n_alive, B_obj, Bp), a view

        def step(wire_in, wire_out, t, lo, count):
            ops.repair_tick(wire_in, wire_out, packed, rows, out, tables, l, t,
                            num_chunks, lo, count, head_zero=True, stagger=stagger)
        pipeline.staggered_pipeline(step, n_alive, num_chunks, (k, S), num_objects=B_obj,
                                    stagger=stagger, device=device, wires=wires)

    return streaming.Program(device=device, l=l, sc_words=sc_words,
                             in_lead=(B_obj, n_alive), out_lead=(B_obj, k),
                             wire_shape=(n_alive, W, k, S), ticks=ticks)


def pipelined_decode_many(code: ErasureCode, ids, shards, num_chunks: int | None = None,
                          stagger: int | None = None, device=None,
                          superchunk_words: int | None = None,
                          sink=None) -> torch.Tensor | None:
    """Staggered multi-object pipelined decode (the dual of encode_many).

    ids: the len(ids) surviving codeword rows, shared across objects (after
    a node failure every object archived on that node set lost the same
    rows). ``shards`` (B_obj, len(ids), B) words, numpy or a tensor ->
    decoded (B_obj, k, B) words on ``device``. The survivors form one
    chain; each tick is one ``repair_tick`` launch in which every
    (node, object) with a chunk adds its column of the decode matrix times
    its shard chunk, read in place, to the k partial sums in slot b % W of
    the wire; the last node writes object b's decoded chunk. Node 0 starts
    from zero sums. ``num_chunks=None`` takes ``chain.DEFAULT_NUM_CHUNKS``,
    ``stagger=None`` takes 1. ``superchunk_words`` / ``sink`` stream the
    batch stripe by stripe, as in ``pipelined_encode_many``.
    """
    if not code.positionwise:
        raise ValueError(
            f"pipelined_decode_many: {code.family} shards are "
            f"sub-packetized — use code.decode_np")
    what = "pipelined_decode_many"
    ids = tuple(int(i) for i in ids)
    dev = _resolve_device(device)
    shards = batch_words(shards, code.l, len(ids), what, "shards", "len(ids)")
    B_obj = shards.shape[0]
    plan, num_chunks = stream_plan(shards.shape[2], superchunk_words, code.l, num_chunks,
                                   what)
    stagger = check_stagger(stagger, what)
    return run_program(
        ("decode_many", code.cache_key, ids, B_obj, plan.sc_words, num_chunks, stagger, dev),
        lambda: _build_decode_many(code, ids, B_obj, plan.sc_words, num_chunks, stagger, dev),
        shards, plan, sink, dev)
