"""Plain PyTorch versions of the CUDA kernels in ``csrc/``.

Each function states the math of the JAX kernel its CUDA kernel replaces:
shifts and masks on packed int32 lanes for the ticks and the bit-plane
encode (the CUDA ticks look products up in tables instead; an entry is
the xor of the planes of its byte's set bits, so both compute the same),
table arithmetic on words for ``encode_words_ref``, and a float32
product of 0/1 bit-planes for the bit-lift. The CPU path runs them, the tests
hold the JAX package against them, and ``chip_smoke.py`` holds the kernels
against them on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gf
from repro_torch.kernels.gf_encode import kernel

# Columns of the bit-lift reference per product: the lifted bits of the
# (16,11) GF(2^16) object would otherwise be 176 x 2^25 float32 values.
BITLIFT_CHUNK = 1 << 20


def encode_packed_ref(M: np.ndarray, data_packed: torch.Tensor, l: int) -> torch.Tensor:
    """(rows, k) static coefficients x (k, Bp) packed int32 -> (rows, Bp)."""
    return gf.gf_matvec_packed(M, data_packed, l)


def encode_packed_many_ref(M: np.ndarray, data_packed: torch.Tensor,
                           l: int) -> torch.Tensor:
    """Per-object version of the batched encode: (O, k, Bp) -> (O, rows, Bp)."""
    return torch.stack([gf.gf_matvec_packed(M, obj, l) for obj in data_packed])


def encode_words_ref(M: np.ndarray, data: torch.Tensor, l: int) -> torch.Tensor:
    """(rows, k) x (k, B) words -> (rows, B) words (table arithmetic)."""
    return gf.gf_matmul(M, data, l)


def bitlift_encode_ref(M: np.ndarray, data: torch.Tensor, l: int) -> torch.Tensor:
    """Plain version of ``kernel.gf_encode_mxu``: (rows, k) x (k, B) words ->
    (rows, B) words through the lifted F2 matrix.

    The product is taken in float32 (torch has no int32 matmul on CUDA),
    which is exact here: the operands are 0/1 and every sum is at most
    k*l < 2^24. TF32 is turned off around the products, so exactness does
    not rest on how it rounds. B is walked in ``BITLIFT_CHUNK`` columns.
    """
    rows, k = np.asarray(M).shape
    lifted = torch.from_numpy(kernel.bitlift_matrix(M, l)).to(data.device,
                                                              torch.float32)
    x = data.to(torch.int32)
    out = torch.empty((rows, x.shape[1]), dtype=torch.int32, device=data.device)
    shifts = torch.arange(l, dtype=torch.int32, device=data.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c0 in range(0, x.shape[1], BITLIFT_CHUNK):
            xs = x[:, c0:c0 + BITLIFT_CHUNK]
            bits = (xs[:, None, :] >> shifts[None, :, None]) & 1    # (k, l, C)
            y = lifted @ bits.reshape(k * l, -1).to(torch.float32)
            y = (y.to(torch.int32) & 1).reshape(rows, l, -1)
            out[:, c0:c0 + BITLIFT_CHUNK] = (y << shifts[None, :, None]).sum(1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.to(gf.TORCH_WORD_DTYPE[l])


def chain_step_ref(x_in: torch.Tensor, local: torch.Tensor, psi: np.ndarray,
                   xi: np.ndarray, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One storage-node chunk step (Eqs. 3-4), packed int32.

    x_in (1, C); local (max_b, C); psi/xi (max_b,) GF words.
    Returns (c, x_out), each (1, C).
    """
    c = x_in.clone()
    xo = x_in.clone()
    for s in range(local.shape[0]):
        c ^= gf.gf_mul_const_packed(local[s][None], int(xi[s]), l)
        xo ^= gf.gf_mul_const_packed(local[s][None], int(psi[s]), l)
    return c, xo


def repair_step_ref(x_in: torch.Tensor, local: torch.Tensor, coeffs: np.ndarray,
                    l: int) -> torch.Tensor:
    """One helper's GF inner-product contribution, packed int32.

    x_in (rows, C) partial sums; local (C,) the helper's shard chunk;
    coeffs (rows,) the helper's column of the decode or repair matrix.
    Returns x_in ^ coeffs[r] * local for every row r.
    """
    return torch.stack([x_in[r] ^ gf.gf_mul_const_packed(local, int(c), l)
                        for r, c in enumerate(np.asarray(coeffs))])


def _tick_objects(t: int, node_lo: int, node_count: int, W: int, n_obj: int,
                  num_chunks: int, stagger: int, device):
    """The tick's nodes (a,) and, for each (node, window slot), the object
    b it works, its chunk ch and whether it has one, each (a, W).

    Lockstep (stagger 0): slot w is object w at chunk t - i. Staggered:
    node i works chunk t - i - b * stagger of object b, in slot b % W; the
    first object of the window is the first whose chunk is below
    num_chunks, and slot w holds the one of the next W that is w mod W.
    """
    nodes = torch.arange(node_lo, node_lo + node_count, device=device)
    d = (t - nodes)[:, None]
    w = torch.arange(W, device=device)[None, :]
    if stagger == 0:
        b = w.expand(node_count, W)
        ch = d.expand(node_count, W)
    else:
        first = (-torch.div(num_chunks - 1 - d, stagger, rounding_mode="floor")).clamp(min=0)
        b = first + torch.remainder(w - first, W)
        ch = d - b * stagger
    return nodes, b, ch, (b < n_obj) & (ch >= 0) & (ch < num_chunks)


def table_planes(tables: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit-planes (bp_psi, bp_xi), each (..., l), behind product tables
    (..., l // 8, 256): plane 8j + b is table j's entry for 1 << b."""
    ent = tables[..., [1 << b for b in range(8)]].reshape(tables.shape[:-2] + (l,))
    return (ent >> 16) & 0xFFFF, ent & 0xFFFF


def chain_tick_ref(wire_in: torch.Tensor, wire_out: torch.Tensor,
                   src: torch.Tensor, slots, out: torch.Tensor,
                   tables: torch.Tensor, l: int, t: int, num_chunks: int,
                   node_lo: int, node_count: int, stagger: int = 0) -> None:
    """Plain version of ``kernel.chain_tick``: same operands, same in-place
    writes. Gathers each (node, window slot)'s blocks by indexing ``src``
    and does the JAX kernel's bit-plane arithmetic: every mask
    ``(x >> b) & LSB`` feeds both the xi (kept) and the psi (forwarded)
    accumulator, over all active nodes and slots at once; a slot with no
    object at this tick writes nothing.

    Of the tables it reads only the single-bit entries (``table_planes``),
    which are the bit-planes ``c * alpha^b`` themselves; the kernel reads
    every entry. So it trusts the table builder for those entries alone:
    ``chip_smoke.py`` and the tests hold them against ``gf.bitplane_table``
    of the coefficients.
    """
    n_obj, R, Bp = src.shape
    slots = torch.tensor(np.asarray(slots), dtype=torch.int64)
    n, max_b = slots.shape
    W, S = wire_in.shape[1], Bp // num_chunks
    nodes, b, ch, active = _tick_objects(t, node_lo, node_count, W, n_obj, num_chunks,
                                         stagger, src.device)
    idx = slots[node_lo:node_lo + node_count].to(src.device)       # (a, max_b)
    blocks = src.unflatten(-1, (num_chunks, S))[
        b.clamp(max=n_obj - 1)[:, :, None], idx.clamp(min=0)[:, None, :],
        ch.clamp(0, num_chunks - 1)[:, :, None]]                     # (a, W, max_b, S)
    blocks = blocks * (idx >= 0)[:, None, :, None]
    bp_psi, bp_xi = table_planes(tables[nodes], l)                # (a, max_b, l)
    x = wire_in[node_lo:node_lo + node_count]                      # (a, W, S)
    c = x.clone()
    xo = x.clone()
    for s in range(max_b):
        for bit in range(l):
            m = (blocks[:, :, s] >> bit) & gf.LSB_MASK[l]
            c ^= m * bp_xi[:, s, bit][:, None, None]
            xo ^= m * bp_psi[:, s, bit][:, None, None]
    a, w = active.nonzero(as_tuple=True)
    out.unflatten(-1, (num_chunks, S))[nodes[a], b[a, w], ch[a, w]] = c[a, w]
    # nodes whose wire row exists forward (an n-row wire_out drops the last)
    a, w = (active & (nodes + 1 < wire_out.shape[0])[:, None]).nonzero(as_tuple=True)
    wire_out[nodes[a] + 1, w] = xo[a, w]


def repair_table_planes(tables: torch.Tensor, l: int, rows: int) -> torch.Tensor:
    """The bit-planes (..., rows, l) behind repair tables (..., packs, l // 8,
    256): plane 8j + b of row ``(32 // l) * p + r`` is bits [l*r, l*r + l)
    of table (p, j)'s entry for 1 << b."""
    ent = tables[..., [1 << b for b in range(8)]].reshape(tables.shape[:-2] + (l,))
    per = 32 // l
    planes = torch.stack([(ent >> (l * r)) & ((1 << l) - 1) for r in range(per)], dim=-2)
    return planes.reshape(tables.shape[:-3] + (-1, l))[..., :rows, :]


def repair_tick_ref(wire_in: torch.Tensor, wire_out: torch.Tensor,
                    shards: torch.Tensor, shard_rows, out: torch.Tensor,
                    tables: torch.Tensor, l: int, t: int, num_chunks: int,
                    node_lo: int, node_count: int, head_zero: bool = False,
                    stagger: int = 0, last_forwards: bool = False) -> None:
    """Plain version of ``kernel.repair_tick``: same operands, same in-place
    writes. Gathers each (node, window slot)'s shard chunk through the row
    table and does the JAX kernel's bit-plane arithmetic, one mask per bit
    shared by all rows; the last node of the chain writes the output chunk
    instead of the wire, unless ``last_forwards`` (it then forwards to
    ``wire_out[n]``, and ``out`` may be None), and a slot with no object at
    this tick writes nothing. With ``head_zero`` node 0 starts from zero
    sums.

    Of the tables it reads only the single-bit entries
    (``repair_table_planes``), which are the bit-planes ``D[r] * alpha^b``;
    the tests and ``chip_smoke.py`` hold those against
    ``gf.bitplane_table`` of the coefficients.
    """
    R, n_obj, Bp = shards.shape
    n, rows = tables.shape[0], wire_in.shape[2]
    W, S = wire_in.shape[1], Bp // num_chunks
    nodes, b, ch, active = _tick_objects(t, node_lo, node_count, W, n_obj, num_chunks,
                                         stagger, shards.device)
    idx = torch.tensor(np.asarray(shard_rows)[node_lo:node_lo + node_count],
                       dtype=torch.int64, device=shards.device)
    bp = repair_table_planes(tables[nodes], l, rows)             # (a, rows, l)
    acc = wire_in[node_lo:node_lo + node_count].clone()          # (a, W, rows, S)
    if head_zero and node_lo == 0:
        acc[0] = 0
    blocks = shards.unflatten(-1, (num_chunks, S))[
        idx[:, None], b.clamp(max=n_obj - 1), ch.clamp(0, num_chunks - 1)]   # (a, W, S)
    for bit in range(l):
        m = (blocks >> bit) & gf.LSB_MASK[l]
        acc ^= m[:, :, None, :] * bp[:, :, bit][:, None, :, None]
    last = (nodes == n - 1)[:, None] & (not last_forwards)
    a, w = (active & ~last).nonzero(as_tuple=True)
    wire_out[nodes[a] + 1, w] = acc[a, w]
    if not last_forwards:   # the last node finishes the stream: its sums are the output chunk
        a, w = (active & last).nonzero(as_tuple=True)
        out.unflatten(-1, (num_chunks, S))[b[a, w], :, ch[a, w]] = acc[a, w]
