"""Staggered multi-object pipelined archival over one node chain.

The paper's second headline result (§VI, Fig. 4): when many objects are
archived concurrently, interleaving their coding chains over the SAME node
set keeps every node busy — object b's chain starts ``stagger`` ticks after
object b-1's, so node i combines object b's chunk while object b+1's chunk
is still in flight toward it:

  ticks(loop)      = B * (C + n - 1)
  ticks(staggered) = C + n - 1 + (B - 1) * stagger

Each tick is ONE launch of the tick kernel over the nodes in the run's
span, whose grid's object axis runs over the ``window_size`` slots of the
wire (``repro_torch.core.pipeline.staggered_pipeline``): per tick the work
of at most W objects a node. ``stagger=1`` overlaps the chains the most;
``stagger=num_chunks`` runs them back to back, one object a node a tick.
That is the schedule the CPU and the placed chains run. On the card an
unplaced batch is one launch for every object, chunk and node, with no
wire: ``encode_chain`` for an encode, ``repair_chain`` for a decode.

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

``num_chunks=None`` and ``stagger=None`` resolve through the tuner
(``repro_torch.core.autotune.num_chunks_for`` / ``stagger_for``), whose
hand-tuned defaults are ``chain.DEFAULT_NUM_CHUNKS`` and a stagger of 1.

``mesh=`` / ``order=`` on ``pipelined_encode_many`` and ``mesh=`` on
``pipelined_decode_many`` place the chain positions on devices, as in
``storage.chain``: each position holds every object's replica blocks or
shard and codeword rows on its device, and a tick is one launch per
position over its object window, the window's slots crossing to the next
position by one copy.

``layout=`` on ``pipelined_encode_many`` (a ``chain.CardLayout``) archives
a batch resident on the cards as the nodes hold it (paper §IV): the input
is one (B_obj, len(layout.blocks[c]), B) tensor a card, card c's replica
blocks, and the output one (B_obj, positions, B) tensor a card, its
positions' codeword rows, left on that card. A tick is one launch a card
over its active nodes, and the wire hops between cards
(``pipeline.staggered_pipeline``'s ``groups``). Its programs are keyed by
the layout's cards; it takes the same tuner, and no stripes.
"""
from __future__ import annotations

import torch

from repro_torch.core import autotune, gf, jitcache, pipeline, streaming, trace
from repro_torch.core.codes import ErasureCode
from repro_torch.storage.chain import (CardLayout, decode_tables, device_tables,
                                       encode_ticks, identity_rows, resolve_placement,
                                       run_program, stream_plan, sums_ticks)

DEFAULT_STAGGER = 1


def tuned_stagger(code: ErasureCode, B_obj: int, num_chunks: int, stagger: int | None,
                  device: torch.device, what: str) -> int:
    """The stagger: ``autotune.stagger_for`` for None (``DEFAULT_STAGGER``
    until a cache says otherwise), else ``stagger`` checked to be >= 1."""
    if stagger is None:
        return autotune.stagger_for(code, B_obj, num_chunks, default=DEFAULT_STAGGER,
                                    device=device)
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


def resident_batch(layout: CardLayout, objects, l: int, what: str) -> list[torch.Tensor]:
    """A batch resident on a layout's cards: one (B_obj, len(blocks[c]), B)
    tensor of words a card, on card c, every card's B_obj and B alike."""
    if isinstance(objects, torch.Tensor) or len(objects) != len(layout.cards):
        raise ValueError(f"{what}: with a layout of {len(layout.cards)} cards, objects must "
                         f"be a list of one tensor a card")
    out = []
    for c, (x, d) in enumerate(zip(objects, layout.cards)):
        x = batch_words(x, l, len(layout.blocks[c]), what, f"card {c}'s blocks",
                        f"len(layout.blocks[{c}])")
        if x.device != d or (out and x.shape[::2] != out[0].shape[::2]):
            raise ValueError(f"{what}: card {c}'s blocks {tuple(x.shape)} on {x.device}, "
                             f"want (B_obj, {len(layout.blocks[c])}, B) on {d}")
        out.append(x)
    return out


def _build_encode_many(code: ErasureCode, B_obj: int, sc_words: int, num_chunks: int,
                       stagger: int, device: torch.device, placement=None,
                       layout: CardLayout | None = None):
    """The staggered encode program: (B_obj, k, sc_words) -> (B_obj, n,
    sc_words) words. Every (node, object) reads its replica blocks in place
    and writes its codeword row into object b's row of the output. Unplaced
    it keeps no wires (``chain.encode_ticks``: one ``encode_chain``);
    placed, one launch a position a tick, each forwarding its wire in slot
    b % W. Over a card ``layout``, a ``streaming.CardProgram``: card c's
    (B_obj, len(layout.blocks[c]), sc_words) -> its (B_obj, positions,
    sc_words), one launch a card a tick."""
    n = code.n
    S = sc_words // gf.LANES[code.l] // num_chunks
    W = pipeline.window_size(num_chunks, B_obj, stagger)

    def drive(step, wires):
        pipeline.staggered_pipeline(step, n, num_chunks, (S,), num_objects=B_obj,
                                    stagger=stagger, device=device, wires=wires,
                                    placement=placement,
                                    groups=None if layout is None else layout.groups)
    run = encode_ticks(code, num_chunks, stagger, device, placement, drive, layout)
    if layout is not None:
        def card_ticks(srcs, outs, wires):
            run(srcs, [out.transpose(0, 1) for out in outs], wires)   # (positions, B_obj, Bp)
        return streaming.CardProgram(
            cards=layout.cards, l=code.l, sc_words=sc_words, ticks=card_ticks,
            in_leads=[(B_obj, len(b)) for b in layout.blocks],
            out_leads=[(B_obj, g.count) for g in layout.groups])

    def ticks(src, out, wires):
        run(src, out.transpose(0, 1), wires)        # out as (n, B_obj, Bp), a view

    wire_shape = None if placement is None else (n, W, S)
    return streaming.Program(device=device, l=code.l, sc_words=sc_words,
                             in_lead=(B_obj, code.k), out_lead=(B_obj, n),
                             wire_shape=wire_shape, ticks=ticks, placement=placement)


@trace.root("encode_many")
def pipelined_encode_many(code: ErasureCode, objects, num_chunks: int | None = None,
                          stagger: int | None = None, device=None,
                          superchunk_words: int | None = None,
                          sink=None, mesh=None, order=None, layout: CardLayout | None = None):
    """Archive B_obj objects concurrently: (B_obj, k, B) -> (B_obj, n, B).

    ``objects`` is a numpy array or a tensor of uint8 (GF(2^8)) or uint16
    (GF(2^16)) words; the result is a tensor of words on ``device``. On the
    card the whole batch is one ``encode_chain`` launch. On the CPU, and
    placed, each tick is one ``chain_tick`` launch over the nodes in the
    run's span: every (node, object) with a chunk at that tick reads its
    replica blocks in place through the slot table, writes its codeword
    chunk straight into object b's row of the output, and forwards its wire
    in slot b % W. ``num_chunks=None`` and ``stagger=None`` are tuned
    (``autotune``). ``superchunk_words`` streams the whole batch
    stripe by stripe, each stripe one staggered run of the same cached
    program, and ``sink(s, (B_obj, n, W) words)`` takes each stripe's
    result instead of an assembled batch. ``mesh`` / ``order`` place the
    chain positions on devices for every object of the batch, as in
    ``chain.pipelined_encode``.

    ``layout`` (a ``chain.CardLayout`` of ``code``) archives a batch
    resident on its cards: ``objects`` is a list of one (B_obj,
    len(layout.blocks[c]), B) tensor a card, on card c, and the result a
    list of one (B_obj, positions, B) tensor a card, card c's positions'
    codeword rows, on card c (row i of card c is codeword row
    ``layout.groups[c].first + i``). No ``device``, ``mesh``, ``order``,
    ``superchunk_words`` or ``sink`` beside it. The call leaves its work on
    each card's current stream.
    """
    with trace.span("repro_torch.resolve"):
        if not code.supports_chain_encode:
            raise ValueError(
                f"pipelined_encode_many: {code.family} has no chain schedule — "
                f"use code.encode_np or the fused-kernel archive path")
        what = "pipelined_encode_many"
        if layout is not None:
            if any(v is not None for v in (device, superchunk_words, sink, mesh, order)):
                raise ValueError(f"{what}: a layout takes no device, mesh, order, "
                                 f"superchunk_words or sink")
            if layout.code_key != code.cache_key:
                raise ValueError(f"{what}: the layout was made for another code")
            objects = resident_batch(layout, objects, code.l, what)
            dev, placement, mesh = layout.cards[0], None, layout.key
            B_obj, B = objects[0].shape[0], objects[0].shape[2]
        else:
            dev, placement, mesh = resolve_placement(code.n, mesh, order, device, what)
            objects = batch_words(objects, code.l, code.k, what, "objects", "k")
            B_obj, _, B = objects.shape
        if num_chunks is None:
            num_chunks = autotune.num_chunks_for("encode_many", code, B, extra_key=(B_obj,),
                                                 device=dev)
        plan, num_chunks = stream_plan(B, superchunk_words, code.l, num_chunks, what)
        stagger = tuned_stagger(code, B_obj, num_chunks, stagger, dev, what)
    key = ("encode_many", code.cache_key, mesh, B_obj, plan.sc_words, num_chunks, stagger, dev)

    def build():
        return _build_encode_many(code, B_obj, plan.sc_words, num_chunks, stagger, dev,
                                  placement, layout)
    if layout is not None:      # resident on its cards: no stripes, nothing moved
        with trace.span("repro_torch.lookup"):
            return jitcache.get(key, build)(objects)
    return run_program(key, build, objects, plan, sink, dev)


def _build_decode_many(code: ErasureCode, ids: tuple[int, ...], B_obj: int,
                       sc_words: int, num_chunks: int, stagger: int,
                       device: torch.device, placement=None) -> streaming.Program:
    """The staggered decode program: (B_obj, len(ids), sc_words) shards ->
    (B_obj, k, sc_words) words, every shard read in place (node i reads
    shard i). Unplaced it keeps no wires; placed, one launch a position
    (``chain.sums_ticks``)."""
    l, k, n_alive = code.l, code.k, len(ids)
    S = sc_words // gf.LANES[l] // num_chunks
    W = pipeline.window_size(num_chunks, B_obj, stagger)

    def drive(step, wires):
        pipeline.staggered_pipeline(step, n_alive, num_chunks, (k, S), num_objects=B_obj,
                                    stagger=stagger, device=device, wires=wires,
                                    placement=placement)
    run = sums_ticks(l, identity_rows(n_alive), device_tables(decode_tables(code, ids), device),
                     num_chunks, stagger, device, placement, drive)

    def ticks(src, out, wires):
        run(src.transpose(0, 1), out, wires)        # (n_alive, B_obj, Bp), a view

    wire_shape = None if placement is None else (n_alive, W, k, S)
    return streaming.Program(device=device, l=l, sc_words=sc_words,
                             in_lead=(B_obj, n_alive), out_lead=(B_obj, k),
                             wire_shape=wire_shape, ticks=ticks, placement=placement)


@trace.root("decode_many")
def pipelined_decode_many(code: ErasureCode, ids, shards, num_chunks: int | None = None,
                          stagger: int | None = None, device=None,
                          superchunk_words: int | None = None,
                          sink=None, mesh=None) -> torch.Tensor | None:
    """Staggered multi-object pipelined decode (the dual of encode_many).

    ids: the len(ids) surviving codeword rows, shared across objects (after
    a node failure every object archived on that node set lost the same
    rows). ``shards`` (B_obj, len(ids), B) words, numpy or a tensor ->
    decoded (B_obj, k, B) words on ``device``. The survivors form one
    chain; every (node, object) adds its column of the decode matrix times
    its shard, read in place, to object b's k partial sums, and the last
    node writes object b's decoded blocks. Node 0 starts from zero sums. On
    the card the whole batch is one ``repair_chain`` launch; on the CPU
    each tick is one ``repair_tick`` over the object window, the sums in
    slot b % W of the wire. ``num_chunks=None`` and ``stagger=None`` are tuned
    (``autotune``). ``superchunk_words`` / ``sink`` stream the
    batch stripe by stripe, as in ``pipelined_encode_many``. ``mesh``
    (len(ids) devices) places the survivors' chain positions, as in
    ``chain.pipelined_decode``.
    """
    with trace.span("repro_torch.resolve"):
        if not code.positionwise:
            raise ValueError(
                f"pipelined_decode_many: {code.family} shards are "
                f"sub-packetized — use code.decode_np")
        what = "pipelined_decode_many"
        ids = tuple(int(i) for i in ids)
        dev, placement, mesh = resolve_placement(len(ids), mesh, None, device, what)
        shards = batch_words(shards, code.l, len(ids), what, "shards", "len(ids)")
        B_obj, _, B = shards.shape
        if num_chunks is None:
            num_chunks = autotune.num_chunks_for("decode_many", code, B, chain_len=len(ids),
                                                 extra_key=(B_obj,), device=dev)
        plan, num_chunks = stream_plan(B, superchunk_words, code.l, num_chunks, what)
        stagger = tuned_stagger(code, B_obj, num_chunks, stagger, dev, what)
    return run_program(
        ("decode_many", code.cache_key, ids, mesh, B_obj, plan.sc_words, num_chunks, stagger,
         dev),
        lambda: _build_decode_many(code, ids, B_obj, plan.sc_words, num_chunks, stagger, dev,
                                   placement),
        shards, plan, sink, dev)
