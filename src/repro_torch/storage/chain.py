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

Warm fast path: each entry point runs one cached program per (code,
survivor set, stripe width, num_chunks, device) key
(``repro_torch.core.jitcache``): the product tables cross to the device
once, when the program is built, not on every call. ``superchunk_words``
streams an object held on the host through the card in independent stripes
of that width (``repro_torch.core.streaming``): every stripe replays one
CUDA graph of the program's ticks, copies overlap the ticks on streams of
their own, and ``sink(s, words)`` takes each stripe's result instead of a
whole-object output. The single-stripe plan is the monolithic call, which
reads its input in place with no graph.

Not ported yet: the ``mesh=`` / ``order=`` placement of chain positions on
devices (on one card a chain position is a row of a tensor, so the order
has no effect on values) and the tuning behind ``num_chunks=None``, which
here takes the hand-tuned ``DEFAULT_NUM_CHUNKS``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import gf, jitcache, pipeline, streaming
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
    if dev.type == "cuda" and dev.index is None:   # the card a tensor .to(dev) lands on
        dev = torch.device("cuda", torch.cuda.current_device())
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


def _chunks(num_chunks: int | None, what: str) -> int:
    """The chunk count, ``DEFAULT_NUM_CHUNKS`` for None, checked >= 1."""
    if num_chunks is None:
        return DEFAULT_NUM_CHUNKS
    if num_chunks < 1:
        raise ValueError(f"{what}: num_chunks must be >= 1, got {num_chunks}")
    return num_chunks


def _check_chunking(B: int, l: int, num_chunks: int | None, what: str) -> int:
    """The chunk count (``DEFAULT_NUM_CHUNKS`` for None), checked to cut a
    block of B words into chunks of whole uint32 lanes."""
    num_chunks = _chunks(num_chunks, what)
    lanes = gf.LANES[l]
    if B % (lanes * num_chunks):
        if num_chunks == 1:
            raise ValueError(
                f"{what}: block length {B} must be whole uint32 lanes "
                f"({lanes} GF(2^{l}) words each)")
        raise ValueError(
            f"{what}: block length {B} must divide into {num_chunks} chunks "
            f"of whole uint32 lanes ({lanes} GF(2^{l}) words each)")
    return num_chunks


def stream_plan(total_words: int, superchunk_words: int | None, l: int,
                num_chunks: int | None, what: str) -> tuple[streaming.StreamPlan, int]:
    """(the stripe plan, the chunk count) of a pipelined call, the stripe
    width checked to cut into whole-lane chunks."""
    num_chunks = _chunks(num_chunks, what)
    plan = streaming.plan_stream(total_words, superchunk_words, l=l, num_chunks=num_chunks)
    _check_chunking(plan.sc_words, l, num_chunks, what)
    return plan, num_chunks


def run_program(key, build, x: torch.Tensor, plan: streaming.StreamPlan, sink,
                device: torch.device):
    """The cached program of ``key`` (built by ``build`` on a miss) over
    ``x``: in place on ``device`` for the single-stripe plan, else stripe
    by stripe from the host (a CUDA ``x`` is brought to the host first, as
    the JAX package's streaming takes host arrays)."""
    program = jitcache.get(key, build)
    if not plan.streaming:
        x = x.to(device)
    return streaming.run_words(program, x, plan, sink=sink)


def device_tables(tables: np.ndarray, device: torch.device) -> torch.Tensor:
    """Cached uint32 product tables as the int32 tensor a tick takes, copied
    to ``device``: a program does it once, when it is built."""
    return torch.from_numpy(tables.view(np.int32).copy()).to(device)


def _words(x, l: int, rows: int, what: str, device: torch.device | None = None) -> torch.Tensor:
    """(rows, B) GF(2^l) words as a tensor on ``device`` (None: where it lies,
    the host for a numpy array)."""
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


def _build_encode(code: ErasureCode, sc_words: int, num_chunks: int,
                  device: torch.device) -> streaming.Program:
    """The encode program of one stripe geometry: (k, sc_words) words ->
    (n, sc_words). The ticks read each node's replica blocks in place
    through the slot table and write every active node's codeword chunk
    straight into the (n, Bp) output; the wire has n rows (the last node's
    forward is never read)."""
    l, n = code.l, code.n
    slots = placement_slots(code)
    tables = device_tables(product_tables(code), device)
    S = sc_words // gf.LANES[l] // num_chunks

    def ticks(src, out, wires):
        src, out = src[None], out[:, None]       # (1, k, Bp), (n, 1, Bp): views

        def step(wire_in, wire_out, t, lo, count):
            ops.chain_tick(wire_in, wire_out, src, slots, out, tables, l, t,
                           num_chunks, lo, count)
        pipeline.software_pipeline(step, n, num_chunks, (n, 1, S), device=device,
                                   wires=wires)

    return streaming.Program(device=device, l=l, sc_words=sc_words, in_lead=(code.k,),
                             out_lead=(n,), wire_shape=(n, 1, S), ticks=ticks)


def pipelined_encode(code: ErasureCode, data, num_chunks: int | None = None,
                     device=None, superchunk_words: int | None = None,
                     sink=None) -> torch.Tensor | None:
    """Archive object ``data`` (k, B) words -> codeword blocks (n, B) words.

    ``data`` is a numpy array or a tensor of uint8 (GF(2^8)) or uint16
    (GF(2^16)) words; the result is a tensor of words on ``device``.
    Each tick is one ``chain_tick`` launch over the active nodes, reading
    the replica blocks in place. ``num_chunks=None`` takes
    ``DEFAULT_NUM_CHUNKS``.

    ``superchunk_words`` streams a host-resident object through the card
    as independent stripes of that many words a block, each one replay of
    the same cached program; the result is then a CPU tensor, or, with
    ``sink``, ``sink(s, coded_stripe)`` receives each trimmed (n, W) words
    array and None is returned. Stripes encode bit-identically to the
    monolithic call; the default single-stripe plan IS the monolithic call.
    """
    if not code.supports_chain_encode:
        raise ValueError(
            f"pipelined_encode: {code.family} has no chain schedule — "
            f"use code.encode_np")
    dev = _resolve_device(device)
    data = _words(data, code.l, code.k, "pipelined_encode")
    plan, num_chunks = stream_plan(data.shape[1], superchunk_words, code.l, num_chunks,
                                   "pipelined_encode")
    return run_program(("encode", code.cache_key, plan.sc_words, num_chunks, dev),
                       lambda: _build_encode(code, plan.sc_words, num_chunks, dev),
                       data, plan, sink, dev)


def encode_program(code: ErasureCode, sc_words: int, num_chunks: int = DEFAULT_NUM_CHUNKS,
                   device=None) -> streaming.Program:
    """The cached encode program of one stripe geometry, (k, sc_words) ->
    (n, sc_words) words: what a store-driven stream
    (``storage.archive.archive_step`` with ``superchunk_bytes``) hands to
    ``streaming.execute`` itself. Same key as ``pipelined_encode``, so a
    store-driven and an in-memory stream of one geometry share a program."""
    if not code.supports_chain_encode:
        raise ValueError(f"encode_program: {code.family} has no chain schedule")
    dev = _resolve_device(device)
    num_chunks = _check_chunking(sc_words, code.l, num_chunks, "encode_program")
    return jitcache.get(("encode", code.cache_key, sc_words, num_chunks, dev),
                        lambda: _build_encode(code, sc_words, num_chunks, dev))


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


def _build_decode(code: ErasureCode, ids: tuple[int, ...], sc_words: int,
                  num_chunks: int, device: torch.device) -> streaming.Program:
    """The decode program of one survivor set and stripe geometry:
    (len(ids), sc_words) shards -> (k, sc_words) words. Node i reads shard
    i in place; only the last node's sums are kept, written straight into
    the output; node 0 starts from zero sums and reads no wire."""
    l, k, n_alive = code.l, code.k, len(ids)
    tables = device_tables(decode_tables(code, ids), device)
    rows = identity_rows(n_alive)
    S = sc_words // gf.LANES[l] // num_chunks

    def ticks(src, out, wires):
        packed, out = src[:, None], out[None]    # (n_alive, 1, Bp), (1, k, Bp): views

        def step(wire_in, wire_out, t, lo, count):
            ops.repair_tick(wire_in, wire_out, packed, rows, out, tables, l, t,
                            num_chunks, lo, count, head_zero=True)
        pipeline.software_pipeline(step, n_alive, num_chunks, (n_alive, 1, k, S),
                                   device=device, wires=wires)

    return streaming.Program(device=device, l=l, sc_words=sc_words, in_lead=(n_alive,),
                             out_lead=(k,), wire_shape=(n_alive, 1, k, S), ticks=ticks)


def pipelined_decode(code: ErasureCode, ids, shards, num_chunks: int | None = None,
                     device=None, superchunk_words: int | None = None,
                     sink=None) -> torch.Tensor | None:
    """Pipelined RapidRAID decode (paper §III's pipelined decoding).

    The len(ids) shard-holding nodes form a chain; the wire carries the k
    running partial output blocks, and node i adds D[:, i] * c_i as the
    stream passes, one repair-tick launch per tick, reading its shard in
    place. Only the LAST node's (k, Bp) sums are kept: they are the decoded
    object (the JAX package materializes every node's (k, Bp) and keeps
    the last). ``shards`` (len(ids), B) words as a numpy array or tensor;
    returns the (k, B) object as a tensor of words on ``device``.
    ``num_chunks=None`` takes ``DEFAULT_NUM_CHUNKS``. ``superchunk_words``
    / ``sink`` stream the decode as in ``pipelined_encode``: decode applies
    D per word, so the stripes concatenate to the monolithic result.
    """
    if not code.positionwise:
        raise ValueError(
            f"pipelined_decode: {code.family} shards are sub-packetized — "
            f"use code.decode_np")
    ids = tuple(int(i) for i in ids)
    dev = _resolve_device(device)
    shards = _words(shards, code.l, len(ids), "pipelined_decode")
    plan, num_chunks = stream_plan(shards.shape[1], superchunk_words, code.l, num_chunks,
                                   "pipelined_decode")
    return run_program(("decode", code.cache_key, ids, plan.sc_words, num_chunks, dev),
                       lambda: _build_decode(code, ids, plan.sc_words, num_chunks, dev),
                       shards, plan, sink, dev)


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
