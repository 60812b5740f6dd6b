"""Public kernel ops: the CUDA kernel for CUDA tensors, the plain version for CPU.

``chain_tick`` / ``repair_tick`` run one pipeline tick over the node axis
(the form ``repro_torch.storage.chain`` and ``storage.multi`` drive), with
the objects in lockstep or staggered over a window. ``encode_chain`` and
``repair_chain`` run a whole unplaced encode, or decode or repair, chain:
one launch on the card, the ticks of its schedule on the CPU. ``chain_step`` /
``repair_step`` keep the single-node shapes of the JAX package's ops at the
public boundary — one object, or a batch with a leading object axis — and
run as a one-node, one-chunk tick.

``encode_packed`` / ``encode_words`` apply a static (rows, k) GF matrix to
packed lanes or words through the bit-plane kernel; ``encode_mxu`` applies
it through the bit-lift kernel on the int8 tensor cores; ``encode_auto``
takes whichever of the two the tuner measured faster for the geometry
(``repro_torch.core.autotune``; the bit-plane kernel until a cache says
otherwise). ``encode_packed``'s threads a block come from the tuning cache
when the caller names none.

A tensor on the CPU takes the plain version in ``ref``; a tensor on a CUDA
device launches the kernel, and a failed build or launch raises. Nothing
falls back from one to the other.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import autotune, gf, pipeline, trace
from repro_torch.kernels.gf_encode import kernel, ref

DEFAULT_BLOCK = 512   # lanes per block of the bit-plane encode, as in the JAX package
TICK_THREADS = 256    # threads a block of the tick kernels (gf_tick.cu's kThreads)
MXU_TILE_WORDS = 64   # words a tile of the bit-lift kernel (gf_mxu.cu's kTileWords, wgmma's M)
ENCODE_THREAD_CANDIDATES = (32, 64, 128, 256)   # gf_encode's legal threads a block


# the words' signed views of the same size: torch on CUDA copies and
# transposes them where it has no kernels for uint16
_SIGNED_WORD = {8: torch.int8, 16: torch.int16}


def _route(x: torch.Tensor, cuda_fn, cpu_fn):
    if x.device.type == "cuda":
        return cuda_fn
    if x.device.type == "cpu":
        return cpu_fn
    raise ValueError(f"no kernel for device {x.device}")


def chain_tick(wire_in, wire_out, src, slots, out, tables, l: int, t: int,
               num_chunks: int, node_lo: int, node_count: int, stagger: int = 0) -> None:
    """One encode tick over nodes [node_lo, node_lo + node_count), lockstep
    (``stagger`` 0) or over a staggered object window; see
    ``kernel.chain_tick`` for shapes. Writes ``out`` and ``wire_out`` in place."""
    fn = _route(src, kernel.chain_tick, ref.chain_tick_ref)
    fn(wire_in, wire_out, src, slots, out, tables, l, t, num_chunks, node_lo,
       node_count, stagger)


def repair_tick(wire_in, wire_out, shards, shard_rows, out, tables, l: int, t: int,
                num_chunks: int, node_lo: int, node_count: int,
                head_zero: bool = False, stagger: int = 0,
                last_forwards: bool = False) -> None:
    """One decode or repair tick over nodes [node_lo, node_lo + node_count),
    lockstep or staggered; see ``kernel.repair_tick`` for shapes. Writes
    ``out`` or ``wire_out`` in place (only ``wire_out`` with
    ``last_forwards``)."""
    fn = _route(shards, kernel.repair_tick, ref.repair_tick_ref)
    fn(wire_in, wire_out, shards, shard_rows, out, tables, l, t, num_chunks,
       node_lo, node_count, head_zero, stagger, last_forwards)


def encode_chain(src, slots, out, tables, l: int, num_chunks: int | None,
                 stagger: int | None = 0) -> None:
    """A whole unplaced encode chain: ``out[i, b]`` gets node i's codeword
    row of object b, node 0 starting from a zero wire; ``slots`` a slot
    table or its ``kernel.EncodePlan``; shapes as ``kernel.encode_chain``'s.
    On the card, one launch of it in one ``repro_torch.tick`` span, which
    takes no schedule. On the CPU, the ticks of the chain's ``num_chunks``
    and ``stagger`` (``pipeline.run_chain``): one ``chain_tick`` a tick,
    looked up on this module at each tick, over fresh zeroed wires."""
    ticks = functools.partial(_encode_chain_ticks, num_chunks=num_chunks, stagger=stagger)
    _route(src, _encode_chain_cuda, ticks)(src, slots, out, tables, l)


def _encode_chain_cuda(src, slots, out, tables, l: int) -> None:
    with trace.span("repro_torch.tick"):
        kernel.encode_chain(src, slots, out, tables, l)


def _encode_chain_ticks(src, slots, out, tables, l: int, num_chunks: int,
                        stagger: int) -> None:
    slots = kernel.check_encode_chain("encode_chain", src, slots, out, tables, l)
    n, (n_obj, _, Bp) = slots.shape[0], src.shape

    def step(wire_in, wire_out, t, lo, count):
        chain_tick(wire_in, wire_out, src, slots, out, tables, l, t, num_chunks, lo, count,
                   stagger)
    pipeline.run_chain(step, n, num_chunks, (Bp // num_chunks,), num_objects=n_obj,
                       stagger=stagger, device=src.device)


def repair_chain(shards, shard_rows, out, tables, l: int, num_chunks: int | None,
                 stagger: int | None = 0) -> None:
    """A whole unplaced decode or repair chain: ``out[b]`` gets the sums the
    last of the positions of ``shard_rows`` writes, node 0 starting from
    zero sums; shapes as ``kernel.repair_chain``'s. On the card, one launch
    of it in one ``repro_torch.tick`` span, which takes no schedule. On the
    CPU, the ticks of the chain's ``num_chunks`` and ``stagger``
    (``pipeline.run_chain``): one ``repair_tick`` a tick, looked up on this
    module at each tick, over fresh zeroed wires."""
    ticks = functools.partial(_repair_chain_ticks, num_chunks=num_chunks, stagger=stagger)
    _route(shards, _repair_chain_cuda, ticks)(shards, shard_rows, out, tables, l)


def _repair_chain_cuda(shards, shard_rows, out, tables, l: int) -> None:
    with trace.span("repro_torch.tick"):
        kernel.repair_chain(shards, shard_rows, out, tables, l)


def _repair_chain_ticks(shards, shard_rows, out, tables, l: int, num_chunks: int,
                        stagger: int) -> None:
    shard_rows = kernel.check_chain("repair_chain", shards, shard_rows, out, tables, l)
    h, (_, n_obj, Bp), rows = shard_rows.shape[0], shards.shape, out.shape[1]
    # a single-object chain passes no stagger (lockstep), as it always has
    staggered = {"stagger": stagger} if stagger else {}

    def step(wire_in, wire_out, t, lo, count):
        repair_tick(wire_in, wire_out, shards, shard_rows, out, tables, l, t, num_chunks, lo,
                    count, head_zero=True, **staggered)
    pipeline.run_chain(step, h, num_chunks, (rows, Bp // num_chunks), num_objects=n_obj,
                       stagger=stagger, device=shards.device)


def chain_step(x_in: torch.Tensor, local: torch.Tensor, bp_psi: torch.Tensor,
               bp_xi: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-node RapidRAID chunk step, all int32 lanes.

    Single object (x_in (1, C), local (max_b, C)) or a batch of objects
    (x_in (O, 1, C), local (O, max_b, C)); ``bp_psi`` / ``bp_xi`` (max_b, l)
    bit-plane constants shared by the objects. Returns (c, x_out) shaped
    like ``x_in``.
    """
    single = local.dim() == 2
    if single:
        x_in, local = x_in[None], local[None]
    if local.dim() != 3:
        raise ValueError(f"chain_step: local {tuple(local.shape)} must be "
                         f"(max_b, C) or (O, max_b, C)")
    O, max_b, C = local.shape
    if tuple(x_in.shape) != (O, 1, C):
        raise ValueError(f"chain_step: x_in {tuple(x_in.shape)} must be {(O, 1, C)}")
    if bp_psi.shape != (max_b, l) or bp_xi.shape != (max_b, l):
        raise ValueError(f"chain_step: planes must be {(max_b, l)}")
    dev = local.device
    tables = kernel.product_tables(bp_psi.cpu().numpy(), bp_xi.cpu().numpy(), l)
    wire_out = torch.empty((2, O, C), dtype=torch.int32, device=dev)  # row 0 unused
    c = torch.empty((1, O, C), dtype=torch.int32, device=dev)
    # a one-node chain whose slots are the rows of `local`
    chain_tick(x_in.contiguous().view(1, O, C), wire_out, local.contiguous(),
               np.arange(max_b, dtype=np.int32)[None], c,
               torch.from_numpy(tables.view(np.int32)).to(dev)[None], l, 0, 1, 0, 1)
    c, xo = c.view(O, 1, C), wire_out[1].view(O, 1, C)
    return (c[0], xo[0]) if single else (c, xo)


def repair_step(x_in: torch.Tensor, local: torch.Tensor, bp: torch.Tensor,
                l: int) -> torch.Tensor:
    """Fused GF inner-product step (one helper's contribution), int32 lanes.

    Single object (x_in (rows, C), local (1, C)) or a batch
    (x_in (O, rows, C), local (O, 1, C)); ``bp`` (rows, l) bit-plane
    constants of the helper's coefficient column. Returns x_in ^ term.
    The product tables are built on the host on every call.
    """
    single = x_in.dim() == 2
    if single:
        x_in, local = x_in[None], local[None]
    if x_in.dim() != 3:
        raise ValueError(f"repair_step: x_in {tuple(x_in.shape)} must be "
                         f"(rows, C) or (O, rows, C)")
    O, rows, C = x_in.shape
    if tuple(local.shape) != (O, 1, C):
        raise ValueError(f"repair_step: local {tuple(local.shape)} must be {(O, 1, C)}")
    if bp.shape != (rows, l):
        raise ValueError(f"repair_step: planes must be {(rows, l)}")
    dev = x_in.device
    tables = kernel.repair_tables(bp.cpu().numpy(), l)
    # a one-node chain: node 0 is the last node, so it writes `out`, never the
    # wire; its shard is the one row of `local`, and its x_in is not zero
    wire_out = torch.empty((1, O, rows, C), dtype=torch.int32, device=dev)
    out = torch.empty((O, rows, C), dtype=torch.int32, device=dev)
    repair_tick(x_in.contiguous()[None], wire_out, local.contiguous().view(1, O, C),
                np.zeros(1, np.int32), out,
                torch.from_numpy(tables.view(np.int32)).to(dev)[None], l, 0, 1, 0, 1)
    return out[0] if single else out


def pick_block(Bp: int, preferred: int = DEFAULT_BLOCK) -> int:
    """Lanes per block of the bit-plane encode for a packed length ``Bp``.

    ``preferred`` for long buffers, else the smallest power of two covering
    ``Bp``. The kernel masks its own ragged end, so the block only sizes
    the launch; nothing is padded.
    """
    if Bp >= preferred:
        return preferred
    b = 1
    while b < Bp:
        b *= 2
    return b


def pick_tick_block(S: int) -> int:
    """Lanes one block of a tick kernel covers a grid step, for chunks of
    ``S`` lanes: ``TICK_THREADS`` threads of 4 lanes (16-byte loads) where
    ``S`` is a multiple of 4, else of 1 lane. The kernels choose this
    themselves from the shapes and strides they are given; no caller sets
    it, and the tuner only records it (``autotune.tick_block``)."""
    return TICK_THREADS * (4 if S % 4 == 0 else 1)


def _matrix_key(M) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(int(v) for v in row) for row in np.asarray(M))


@functools.lru_cache(maxsize=256)
def _operand(M_key, l: int, device: torch.device) -> torch.Tensor:
    """``kernel.mxu_operand`` of M on ``device``, cached so a warm call makes
    no host-to-device copy. Callers must not write to it."""
    return torch.from_numpy(kernel.mxu_operand(np.asarray(M_key), l)).to(device)


def _encode_threads(Bp: int, block: int) -> int:
    """Threads per block of the specialised kernel (one lane a thread) for
    ``block`` lanes per block, rounded to whole warps within its [32, 256]."""
    lanes = pick_block(Bp, block)
    return min(kernel.ENCODE_MAX_THREADS, max(32, -(-lanes // 32) * 32))


def _launch_encode(M: np.ndarray, x: torch.Tensor, l: int, threads: int) -> torch.Tensor:
    out = torch.empty((x.shape[0], M.shape[0], x.shape[-1]), dtype=torch.int32,
                      device=x.device)
    kernel.gf_encode(x.contiguous(), M, out, l, threads)
    return out


def _tuned_encode_block(M: np.ndarray, x: torch.Tensor, l: int) -> int:
    """Threads a ``gf_encode`` block for (O, k, Bp) lanes ``x`` when the
    caller names no block: the tuning cache (a search-mode miss sweeps the
    real kernel over ``ENCODE_THREAD_CANDIDATES`` and persists the
    fastest), else the kernel's own ``ENCODE_THREADS``. The cache keeps the
    reference's ``encode_packed`` key; its value is the threads."""
    return autotune.kernel_block(
        "encode_packed", l, x.shape[-1], heuristic=kernel.ENCODE_THREADS,
        candidates=ENCODE_THREAD_CANDIDATES,
        probe=lambda threads: _launch_encode(M, x, l, threads), device=x.device)


def _encode_packed_cuda(M: np.ndarray, x: torch.Tensor, l: int,
                        block: int | None) -> torch.Tensor:
    threads = (_tuned_encode_block(M, x, l) if block is None
               else _encode_threads(x.shape[-1], block))
    return _launch_encode(M, x, l, threads)


def encode_packed(M: np.ndarray, data_packed: torch.Tensor, l: int,
                  block: int | None = None) -> torch.Tensor:
    """Packed bit-plane encode: (k, Bp) int32 lanes -> (rows, Bp), or a
    batch (O, k, Bp) -> (O, rows, Bp) in one launch. ``block`` is the
    number of lanes per CUDA block; ``None`` resolves the threads through
    the tuning cache (``_tuned_encode_block``)."""
    M = np.asarray(M)
    if M.ndim != 2:
        raise ValueError(f"encode_packed: coefficients {M.shape} must be (rows, k)")
    single = data_packed.dim() == 2
    x = data_packed[None] if single else data_packed
    if x.dim() != 3 or x.shape[1] != M.shape[1]:
        raise ValueError(f"encode_packed: data {tuple(data_packed.shape)} must be "
                         f"(k={M.shape[1]}, Bp) or (O, k, Bp)")
    cuda = functools.partial(_encode_packed_cuda, block=block)
    out = _route(x, cuda, ref.encode_packed_many_ref)(M, x, l)
    return out[0] if single else out


def encode_words(M: np.ndarray, data: torch.Tensor, l: int,
                 block: int | None = None) -> torch.Tensor:
    """Word-level wrapper of ``encode_packed``: packs, encodes, unpacks.
    (k, B) words or a batch (O, k, B); B must be whole int32 lanes."""
    out = encode_packed(M, gf.pack_u32(data, l), l, block=block)
    return gf.unpack_u32(out, l)


def _encode_mxu_cuda(M: np.ndarray, data: torch.Tensor, l: int) -> torch.Tensor:
    out = torch.empty((M.shape[0], data.shape[1]), dtype=data.dtype, device=data.device)
    kernel.gf_encode_mxu(data.contiguous(), _operand(_matrix_key(M), l, data.device),
                         out, l)
    return out


def encode_mxu(M: np.ndarray, data: torch.Tensor, l: int) -> torch.Tensor:
    """Bit-lifted encode on the int8 tensor cores: (k, B) words -> (rows, B)
    words of ``gf.TORCH_WORD_DTYPE[l]``. Any B: the kernel masks the ragged
    end of its last 64-word tile, and reads and writes the words in their
    own type. A matrix whose lifted form does not fit a block's shared
    memory raises (``kernel.gf_encode_mxu``)."""
    M = np.asarray(M)
    if M.ndim != 2 or data.dim() != 2 or data.shape[0] != M.shape[1]:
        raise ValueError(f"encode_mxu: coefficients {M.shape} and data "
                         f"{tuple(data.shape)} must be (rows, k) and (k, B)")
    if data.dtype != gf.TORCH_WORD_DTYPE[l]:
        raise ValueError(f"encode_mxu: words must be {gf.TORCH_WORD_DTYPE[l]} "
                         f"for GF(2^{l}), got {data.dtype}")
    return _route(data, _encode_mxu_cuda, ref.bitlift_encode_ref)(M, data, l)


def _encode_mxu_any(M: np.ndarray, data: torch.Tensor, l: int) -> torch.Tensor:
    """``encode_mxu`` for (k, B) or a batch (O, k, B): the kernel is strictly
    (k, B), so a batch rides as one word-axis concatenation (one launch)
    and is split back after."""
    if data.dim() == 2:
        return encode_mxu(M, data, l)
    O, k, B = data.shape
    word, signed = data.dtype, _SIGNED_WORD[l]   # moved through signed views (see above)
    flat = data.view(signed).transpose(0, 1).reshape(k, O * B).view(word)
    out = encode_mxu(M, flat, l).view(signed)
    return out.reshape(-1, O, B).transpose(0, 1).contiguous().view(word)


def dispatch_for_data(M: np.ndarray, data: torch.Tensor, l: int) -> str:
    """Tuned bit-plane vs bit-lift dispatch (``"vpu"`` / ``"mxu"``) for this
    encode of (k, B) or (O, k, B) words.

    On a search-mode cache miss, times BOTH real kernels on the actual
    input and persists the winner per (backend, l, rows, k, B); otherwise
    the cached value or the hand-tuned ``"vpu"``. A kernel that fails to
    build or launch raises out of the probe.
    """
    M = np.asarray(M)
    probes = None
    if autotune.mode() == "search":
        probes = {"vpu": lambda: encode_words(M, data, l),
                  "mxu": lambda: _encode_mxu_any(M, data, l)}
    return autotune.dispatch_for(l, int(M.shape[0]), int(data.shape[-2]),
                                 int(data.shape[-1]), probes=probes, device=data.device)


def encode_auto(M: np.ndarray, data: torch.Tensor, l: int) -> torch.Tensor:
    """Dispatch-tuned word-level encode: the bit-plane ``gf_encode`` or the
    bit-lift ``gf_encode_mxu``, whichever the tuner measured faster for
    this (l, shape, backend). (k, B) or a batch (O, k, B) words, B whole
    int32 lanes."""
    if dispatch_for_data(M, data, l) == "mxu":
        return _encode_mxu_any(M, data, l)
    return encode_words(M, data, l)


def encode_block_for(M: np.ndarray, data: torch.Tensor, l: int) -> int:
    """Resolve (probing in search mode) the tuned threads of a ``gf_encode``
    block for this (k, B) word geometry on the data's device; used by
    ``autotune.prewarm``. On the CPU, where the plain version runs, the
    kernel's own ``ENCODE_THREADS``."""
    if data.device.type != "cuda":
        return kernel.ENCODE_THREADS
    return _tuned_encode_block(np.asarray(M), gf.pack_u32(data, l)[None], l)


def mxu_block_for(M: np.ndarray, data: torch.Tensor, l: int) -> int:
    """The bit-lift kernel's tile width for this geometry: ``MXU_TILE_WORDS``
    (64 words, wgmma's M). The kernel fixes it and masks a ragged last tile,
    so there is nothing to sweep (the reference tunes a Pallas tile here)."""
    del M, data, l
    return MXU_TILE_WORDS
