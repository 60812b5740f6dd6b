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
(``chain.encode_operands``, ``chain.decode_tables``).

Entry points run on the card unless the caller passes ``device="cpu"``,
where the ticks run the kernels' plain PyTorch versions.

Not ported yet: the ``mesh=`` / ``order=`` placement of chain positions on
devices, streaming in super-chunks (``superchunk_words=`` / ``sink=``) and
the tuning behind ``num_chunks=None`` and ``stagger=None``, which here take
``chain.DEFAULT_NUM_CHUNKS`` and a stagger of 1 (the tuner's default).
"""
from __future__ import annotations

import torch

from repro_torch.core import gf, pipeline
from repro_torch.core.codes import ErasureCode
from repro_torch.kernels.gf_encode import ops
from repro_torch.storage.chain import (_check_chunking, _resolve_device, decode_operands,
                                       encode_operands, identity_rows)

DEFAULT_STAGGER = 1


def check_stagger(stagger: int | None, what: str) -> int:
    """The stagger (``DEFAULT_STAGGER`` for None), checked to be >= 1."""
    if stagger is None:
        return DEFAULT_STAGGER
    if stagger < 1:
        raise ValueError(f"{what}: stagger must be >= 1, got {stagger}")
    return int(stagger)


def batch_words(x, l: int, rows: int, what: str, name: str, rows_name: str,
                device: torch.device) -> torch.Tensor:
    """A (B_obj, rows, B) batch of GF(2^l) words as a tensor on ``device``."""
    x = torch.as_tensor(x, device=device)
    if x.dim() != 3 or x.shape[1] != rows:
        raise ValueError(f"{what}: {name} {tuple(x.shape)} must be "
                         f"(B_obj, {rows_name}={rows}, B)")
    if x.dtype != gf.TORCH_WORD_DTYPE[l]:
        raise ValueError(f"{what}: words must be {gf.TORCH_WORD_DTYPE[l]} for "
                         f"GF(2^{l}), got {x.dtype}")
    return x.contiguous()


def pipelined_encode_many(code: ErasureCode, objects, num_chunks: int | None = None,
                          stagger: int | None = None, device=None) -> torch.Tensor:
    """Archive B_obj objects concurrently: (B_obj, k, B) -> (B_obj, n, B).

    ``objects`` is a numpy array or a tensor of uint8 (GF(2^8)) or uint16
    (GF(2^16)) words; the result is a tensor of words on ``device``. Each
    tick is one ``chain_tick`` launch over the nodes in the run's span:
    every (node, object) with a chunk at that tick reads its replica blocks
    in place through the slot table, writes its codeword chunk straight
    into object b's row of the output, and forwards its wire in slot
    b % W. ``num_chunks=None`` takes ``chain.DEFAULT_NUM_CHUNKS``,
    ``stagger=None`` takes 1.
    """
    if not code.supports_chain_encode:
        raise ValueError(
            f"pipelined_encode_many: {code.family} has no chain schedule — "
            f"use code.encode_np or the fused-kernel archive path")
    dev = _resolve_device(device)
    l, n = code.l, code.n
    objects = batch_words(objects, l, code.k, "pipelined_encode_many", "objects", "k", dev)
    B_obj = objects.shape[0]
    num_chunks = _check_chunking(objects.shape[2], l, num_chunks, "pipelined_encode_many")
    stagger = check_stagger(stagger, "pipelined_encode_many")
    src, slots, tables = encode_operands(code, gf.pack_u32(objects, l))
    Bp = src.shape[-1]
    out = torch.empty((B_obj, n, Bp), dtype=torch.int32, device=dev)  # every chunk written once
    out_nodes = out.transpose(0, 1)                  # (n, B_obj, Bp), a view

    def step(wire_in, wire_out, t, lo, count):
        ops.chain_tick(wire_in, wire_out, src, slots, out_nodes, tables, l, t,
                       num_chunks, lo, count, stagger)

    pipeline.staggered_pipeline(step, n, num_chunks, (Bp // num_chunks,),
                                num_objects=B_obj, stagger=stagger, device=dev)
    return gf.unpack_u32(out, l)


def pipelined_decode_many(code: ErasureCode, ids, shards, num_chunks: int | None = None,
                          stagger: int | None = None, device=None) -> torch.Tensor:
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
    ``stagger=None`` takes 1.
    """
    if not code.positionwise:
        raise ValueError(
            f"pipelined_decode_many: {code.family} shards are "
            f"sub-packetized — use code.decode_np")
    ids = tuple(int(i) for i in ids)
    dev = _resolve_device(device)
    l, k, n_alive = code.l, code.k, len(ids)
    shards = batch_words(shards, l, n_alive, "pipelined_decode_many", "shards",
                         "len(ids)", dev)
    B_obj = shards.shape[0]
    num_chunks = _check_chunking(shards.shape[2], l, num_chunks, "pipelined_decode_many")
    stagger = check_stagger(stagger, "pipelined_decode_many")
    tables = decode_operands(code, ids, dev)
    packed = gf.pack_u32(shards, l).transpose(0, 1)   # (n_alive, B_obj, Bp), a view
    rows = identity_rows(n_alive)                      # node i reads shard i
    Bp = packed.shape[-1]
    out = torch.empty((B_obj, k, Bp), dtype=torch.int32, device=dev)  # every chunk written once

    def step(wire_in, wire_out, t, lo, count):
        ops.repair_tick(wire_in, wire_out, packed, rows, out, tables, l, t,
                        num_chunks, lo, count, head_zero=True, stagger=stagger)

    pipeline.staggered_pipeline(step, n_alive, num_chunks, (k, Bp // num_chunks),
                                num_objects=B_obj, stagger=stagger, device=dev)
    return gf.unpack_u32(out, l)
