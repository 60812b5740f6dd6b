"""RapidRAID pipelined encoding and decoding along a node chain (paper Fig. 2).

On one card the n storage nodes of the chain are the leading node axis of
device tensors. Node i holds its replica block(s), receives the running
combination from its predecessor, keeps its codeword block (xi path) and
forwards the updated combination (psi path). Blocks stream through the
pipeline (``repro_torch.core.pipeline``) in ``num_chunks`` chunks, and each
tick is ONE launch of the hand-written CUDA tick kernel over the active
nodes (``repro_torch.kernels.gf_encode``) on packed int32 lanes. The encode
tick reads each node's replica blocks in place through a slot table, so
the placement is never copied; the decode tick reads the survivors' shards
in place through a row table.

Entry points run on the card unless the caller passes ``device="cpu"``,
where the ticks run the kernels' plain PyTorch versions. Asking for a CUDA
device on a machine without one raises.

Not ported yet: the ``mesh=`` / ``order=`` placement of chain positions on
devices (on one card a chain position is a row of a tensor, so the order
has no effect on values), streaming in super-chunks (``superchunk_words=``
/ ``sink=``) and the tuning behind ``num_chunks=None``, which here takes
the hand-tuned ``DEFAULT_NUM_CHUNKS``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import gf, pipeline
from repro_torch.core.codes import ErasureCode
from repro_torch.kernels.gf_encode import kernel, ops

DEFAULT_NUM_CHUNKS = 8


def _resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def column_bitplanes(M: np.ndarray, l: int) -> np.ndarray:
    """Per-chain-node bit-plane constants for a GF coefficient matrix.

    (rows, cols) M -> (cols, rows, l) uint32 with
    ``out[c, r, b] = M[r, c] * alpha^b``: chain node c applies column c of M
    to its local stream — the layout pipelined decode feeds the ticks.
    """
    return gf.bitplane_table(np.asarray(M).T, l)


@functools.lru_cache(maxsize=None)
def bitplane_coeff_planes(code: ErasureCode) -> tuple[np.ndarray, np.ndarray]:
    """(bp_psi, bp_xi), each (n, max_b, l) uint32 with bp[i,s,j] = coef*alpha^j.

    Cached per code: the planes are a pure function of the (hashable) code.
    """
    sched = code.chain
    bp_psi = gf.bitplane_table(sched.psi, code.l)
    bp_xi = gf.bitplane_table(sched.xi, code.l)
    bp_psi.setflags(write=False)   # shared cached copies — freeze them
    bp_xi.setflags(write=False)
    return bp_psi, bp_xi


@functools.lru_cache(maxsize=None)
def placement_indices(code: ErasureCode) -> tuple[np.ndarray, np.ndarray]:
    """Static gather spec for replica placement: (idx, valid), both (n, max_b).

    ``local[i, s] = data[idx[i, s]] if valid[i, s] else 0``.
    """
    sched = code.chain
    idx = sched.local_blocks.astype(np.int32)
    valid = sched.block_valid.copy()
    idx.setflags(write=False)      # shared cached copies — freeze them
    valid.setflags(write=False)
    return idx, valid


@functools.lru_cache(maxsize=None)
def placement_slots(code: ErasureCode) -> np.ndarray:
    """The encode tick's slot table, (n, max_b) int32: node i's slot s
    holds object block ``slots[i, s]``, or nothing where it is -1."""
    idx, valid = placement_indices(code)
    slots = np.where(valid, idx, -1).astype(np.int32)
    slots.setflags(write=False)    # shared cached copy — freeze it
    return slots


@functools.lru_cache(maxsize=None)
def product_tables(code: ErasureCode) -> np.ndarray:
    """The encode tick's product tables, (n, max_b, l // 8, 256) uint32
    (``kernel.product_tables`` of ``bitplane_coeff_planes``). Cached per
    code, so only a code's first encode builds them."""
    tables = kernel.product_tables(*bitplane_coeff_planes(code), code.l)
    tables.setflags(write=False)   # shared cached copy — freeze it
    return tables


def build_local_blocks(code: ErasureCode, data: np.ndarray) -> np.ndarray:
    """Replica placement on the host: (n, max_b, B) words; padded slots are zero.

    What the encode tick's slot table reads (``placement_slots``).
    """
    idx, valid = placement_indices(code)
    data = np.asarray(data)
    return np.where(valid[:, :, None], data[idx], 0).astype(data.dtype)


def _check_chunking(B: int, l: int, num_chunks: int | None, what: str) -> int:
    """The chunk count (``DEFAULT_NUM_CHUNKS`` for None), checked to cut a
    block of B words into chunks of whole uint32 lanes."""
    if num_chunks is None:
        num_chunks = DEFAULT_NUM_CHUNKS
    lanes = gf.LANES[l]
    if num_chunks < 1:
        raise ValueError(f"{what}: num_chunks must be >= 1, got {num_chunks}")
    if B % (lanes * num_chunks):
        if num_chunks == 1:
            raise ValueError(
                f"{what}: block length {B} must be whole uint32 lanes "
                f"({lanes} GF(2^{l}) words each)")
        raise ValueError(
            f"{what}: block length {B} must divide into {num_chunks} chunks "
            f"of whole uint32 lanes ({lanes} GF(2^{l}) words each)")
    return num_chunks


def device_tables(tables: np.ndarray, device: torch.device) -> torch.Tensor:
    """Cached uint32 product tables as the int32 tensor a tick takes."""
    return torch.from_numpy(tables.view(np.int32).copy()).to(device)


def _words(x, l: int, rows: int, what: str, device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(x, device=device)
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{what}: words {tuple(x.shape)} must be ({rows}, B)")
    if x.dtype != gf.TORCH_WORD_DTYPE[l]:
        raise ValueError(f"{what}: words must be {gf.TORCH_WORD_DTYPE[l]} for "
                         f"GF(2^{l}), got {x.dtype}")
    return x


def encode_operands(code: ErasureCode, data_packed: torch.Tensor):
    """Operands of the encode ticks for ``data_packed``, one object (k, Bp)
    or a batch (B_obj, k, Bp) of int32: ``src`` (B_obj, k, Bp), a view of
    the data (the ticks read the replica blocks in place), ``slots`` (n,
    max_b) int32 on the host, and the product tables (n, max_b, l // 8,
    256) int32 on the data's device."""
    src = data_packed[None] if data_packed.dim() == 2 else data_packed
    return (src, placement_slots(code),
            device_tables(product_tables(code), data_packed.device))


def pipelined_encode(code: ErasureCode, data, num_chunks: int | None = None,
                     device=None) -> torch.Tensor:
    """Archive object ``data`` (k, B) words -> codeword blocks (n, B) words.

    ``data`` is a numpy array or a tensor of uint8 (GF(2^8)) or uint16
    (GF(2^16)) words; the result is a tensor of words on ``device``.
    The ticks read each node's replica blocks in place through the slot
    table and write every active node's codeword chunk straight into the
    (n, Bp) output; nodes without a chunk in a tick are not launched at
    all. The wire has n rows: the last node's forward is never read.
    ``num_chunks=None`` takes ``DEFAULT_NUM_CHUNKS``.
    """
    if not code.supports_chain_encode:
        raise ValueError(
            f"pipelined_encode: {code.family} has no chain schedule — "
            f"use code.encode_np")
    dev = _resolve_device(device)
    l, n = code.l, code.n
    data = _words(data, l, code.k, "pipelined_encode", dev)
    num_chunks = _check_chunking(data.shape[1], l, num_chunks, "pipelined_encode")
    src, slots, tables = encode_operands(code, gf.pack_u32(data, l))
    Bp = src.shape[-1]
    out = torch.empty((n, 1, Bp), dtype=torch.int32, device=dev)  # every chunk written once

    def step(wire_in, wire_out, t, lo, count):
        ops.chain_tick(wire_in, wire_out, src, slots, out, tables, l, t,
                       num_chunks, lo, count)

    pipeline.software_pipeline(step, n, num_chunks, (n, 1, Bp // num_chunks),
                               device=dev)
    return gf.unpack_u32(out[:, 0], l)


@functools.lru_cache(maxsize=256)
def decode_planes(code: ErasureCode, ids: tuple[int, ...]) -> np.ndarray:
    """Bit-plane constants of the decode matrix's columns, (n_alive, k, l)
    uint32. Cached per (code, survivor set): the host Gaussian elimination
    runs once, not on every read. Raises ValueError if ``ids`` are not
    decodable."""
    planes = column_bitplanes(code.decode_matrix(list(ids)), code.l)
    planes.setflags(write=False)   # shared cached copy — freeze it
    return planes


@functools.lru_cache(maxsize=256)
def decode_tables(code: ErasureCode, ids: tuple[int, ...]) -> np.ndarray:
    """The decode ticks' product tables, (n_alive, packs, l // 8, 256)
    uint32 (``kernel.repair_tables`` of ``decode_planes``): node i's
    products for the k rows of column i of the decode matrix. Cached per
    (code, survivor set), so a warm decode builds nothing."""
    tables = kernel.repair_tables(decode_planes(code, ids), code.l)
    tables.setflags(write=False)   # shared cached copy — freeze it
    return tables


@functools.lru_cache(maxsize=None)
def identity_rows(n: int) -> np.ndarray:
    """The row table of a chain whose node i reads shard i, (n,) int32,
    frozen (the ticks check a frozen table once)."""
    rows = np.arange(n, dtype=np.int32)
    rows.setflags(write=False)
    return rows


def decode_operands(code: ErasureCode, ids, device: torch.device) -> torch.Tensor:
    """``decode_tables`` as int32 on ``device``."""
    return device_tables(decode_tables(code, tuple(int(i) for i in ids)), device)


def pipelined_decode(code: ErasureCode, ids, shards, num_chunks: int | None = None,
                     device=None) -> torch.Tensor:
    """Pipelined RapidRAID decode (paper §III's pipelined decoding).

    The len(ids) shard-holding nodes form a chain; the wire carries the k
    running partial output blocks, and node i adds D[:, i] * c_i as the
    stream passes, one repair-tick launch per tick, reading its shard in
    place. Only the LAST node's (k, Bp) sums are kept: they are the decoded
    object, written straight into the output (the JAX package materializes
    every node's (k, Bp) and keeps the last). Node 0 starts from zero sums
    and reads no wire. ``shards`` (len(ids), B) words as a numpy array or
    tensor; returns the (k, B) object as a tensor of words on ``device``.
    ``num_chunks=None`` takes ``DEFAULT_NUM_CHUNKS``.
    """
    if not code.positionwise:
        raise ValueError(
            f"pipelined_decode: {code.family} shards are sub-packetized — "
            f"use code.decode_np")
    ids = tuple(int(i) for i in ids)
    dev = _resolve_device(device)
    l, k, n_alive = code.l, code.k, len(ids)
    shards = _words(shards, l, n_alive, "pipelined_decode", dev)
    num_chunks = _check_chunking(shards.shape[1], l, num_chunks, "pipelined_decode")
    tables = decode_operands(code, ids, dev)
    packed = gf.pack_u32(shards, l)[:, None]         # (n_alive, 1, Bp), a view
    rows = identity_rows(n_alive)                    # node i reads shard i
    Bp = packed.shape[-1]
    out = torch.empty((1, k, Bp), dtype=torch.int32, device=dev)  # every chunk written once

    def step(wire_in, wire_out, t, lo, count):
        ops.repair_tick(wire_in, wire_out, packed, rows, out, tables, l, t,
                        num_chunks, lo, count, head_zero=True)

    pipeline.software_pipeline(step, n_alive, num_chunks,
                               (n_alive, 1, k, Bp // num_chunks), device=dev)
    return gf.unpack_u32(out[0], l)


def order_chain(node_speeds: np.ndarray, n: int, k: int) -> np.ndarray:
    """Straggler mitigation: permutation assigning nodes to chain positions.

    Chain positions are not symmetric: position 0 never receives, position
    n-1 never forwards (no psi work), and for n < 2k the middle 2k-n
    positions process two blocks (double compute + double replica traffic).
    Put the slowest nodes at the chain ends and the fastest in the middle,
    so per-tick latency (the pipeline's critical path) is minimized.
    """
    node_speeds = np.asarray(node_speeds, dtype=float)
    if node_speeds.shape != (n,):
        raise ValueError(f"order_chain: {node_speeds.shape} speeds for n={n}")
    order = np.argsort(node_speeds)  # slowest first
    heavy = list(range(n - k, k))    # two-block positions (empty when n == 2k)
    light = [p for p in range(n) if p not in heavy]
    # light positions sorted so the very ends are filled with the slowest
    light.sort(key=lambda p: min(p, n - 1 - p))
    perm = np.zeros(n, dtype=int)
    for pos, node in zip(light, order[: len(light)]):
        perm[pos] = node
    for pos, node in zip(heavy, order[len(light):][::-1]):  # fastest in middle
        perm[pos] = node
    return perm
