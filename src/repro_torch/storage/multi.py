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
cached program per (code, survivor set, batch, stripe width, schedule,
device) key, and ``superchunk_words`` / ``sink`` stream a host-resident
batch stripe by stripe, as in ``storage.chain``.

Where ticks run (the CPU, placed chains, card layouts), ``num_chunks=None``
and ``stagger=None`` resolve through the tuner
(``repro_torch.core.autotune.num_chunks_for`` / ``stagger_for``), whose
hand-tuned defaults are ``chain.DEFAULT_NUM_CHUNKS`` and
``chain.DEFAULT_STAGGER``, and key the program (``chain.call_plan``). The
card's one launch reads neither: an unplaced call there reaches no tuner,
and its program holds no schedule.

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

from repro_torch.core import jitcache, trace
from repro_torch.core.codes import ErasureCode
from repro_torch.storage.chain import (CardLayout, _words, build_decode, build_encode,
                                       call_plan, run_program)


def resident_batch(layout: CardLayout, objects, l: int, what: str) -> list[torch.Tensor]:
    """A batch resident on a layout's cards: one (B_obj, len(blocks[c]), B)
    tensor of words a card, on card c, every card's B_obj and B alike."""
    if isinstance(objects, torch.Tensor) or len(objects) != len(layout.cards):
        raise ValueError(f"{what}: with a layout of {len(layout.cards)} cards, objects must "
                         f"be a list of one tensor a card")
    out = []
    for c, (x, d) in enumerate(zip(objects, layout.cards)):
        x = _words(x, l, len(layout.blocks[c]), what,
                   batch=(f"card {c}'s blocks", f"len(layout.blocks[{c}])"))
        if x.device != d or (out and x.shape[::2] != out[0].shape[::2]):
            raise ValueError(f"{what}: card {c}'s blocks {tuple(x.shape)} on {x.device}, "
                             f"want (B_obj, {len(layout.blocks[c])}, B) on {d}")
        out.append(x)
    return out


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
    in slot b % W, ``num_chunks=None`` and ``stagger=None`` tuned
    (``chain.call_plan``). ``superchunk_words`` streams the whole batch
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
            B_obj, B = objects[0].shape[0], objects[0].shape[2]
        else:
            objects = _words(objects, code.l, code.k, what, batch=("objects", "k"))
            B_obj, _, B = objects.shape
        plan = call_plan(code, what, "encode_many", B, num_chunks, stagger, chain_len=code.n,
                         B_obj=B_obj, device=device, superchunk_words=superchunk_words,
                         mesh=mesh, order=order, layout=layout)

    def build():
        return build_encode(code, plan, layout)
    if layout is not None:      # resident on its cards: no stripes, nothing moved
        with trace.span("repro_torch.lookup"):
            return jitcache.get(plan.key, build)(objects)
    return run_program(plan, build, objects, sink)


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
    slot b % W of the wire, ``num_chunks=None`` and ``stagger=None`` tuned
    (``chain.call_plan``). ``superchunk_words`` / ``sink`` stream the
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
        shards = _words(shards, code.l, len(ids), what, batch=("shards", "len(ids)"))
        B_obj, _, B = shards.shape
        plan = call_plan(code, what, "decode_many", B, num_chunks, stagger, chain_len=len(ids),
                         sets=(ids,), B_obj=B_obj, device=device,
                         superchunk_words=superchunk_words, mesh=mesh)
    return run_program(plan, lambda: build_decode(code, ids, plan), shards, sink)
