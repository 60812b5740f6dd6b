"""Finite-field GF(2^l) arithmetic for erasure coding, l in {8, 16}.

Three execution styles, bit-exact against each other:

1. Host (numpy) table arithmetic — builds generator and decode matrices,
   runs Gaussian elimination and draws coefficients (Jerasure's
   log/antilog approach, as in the paper).
2. The same table arithmetic on torch word tensors (``gf_mul``,
   ``gf_matmul``) — the word-level reference on any device.
3. Packed **bit-plane** arithmetic on torch tensors — a multiply by a
   coefficient ``c`` is ``xor_j bit_j(x) * (c * alpha^j)``, with 4 bytes
   (or 2 halfwords) packed per 32-bit lane. No gathers; pure
   shift/mask/mul/xor. The CUDA tick kernels in
   ``repro_torch.kernels.gf_encode`` are built on this formulation.

Packed lanes are carried as ``torch.int32``: the arithmetic right shift is
harmless under the LSB mask (the masked bits stop at bit 31, 24+7 for l=8
and 16+15 for l=16), and ``mask * const`` wraps mod 2^32, so the bits are
those of the uint32 formulation.
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch

# Primitive polynomials (same ones Jerasure uses).
PRIM_POLY = {8: 0x11D, 16: 0x1100B}
WORD_DTYPE = {8: np.uint8, 16: np.uint16}
TORCH_WORD_DTYPE = {8: torch.uint8, 16: torch.uint16}
# Packed-lane constants: words per 32-bit lane and the "every word's LSB" mask.
LANES = {8: 4, 16: 2}
LSB_MASK = {8: 0x01010101, 16: 0x00010001}


@functools.lru_cache(maxsize=None)
def gf_tables(l: int) -> tuple[np.ndarray, np.ndarray]:
    """(exp, log) tables. ``exp`` is doubled so exp[log a + log b] needs no mod."""
    if l not in PRIM_POLY:
        raise ValueError(f"unsupported field GF(2^{l})")
    q = 1 << l
    exp = np.zeros(2 * (q - 1), dtype=np.int64)
    log = np.zeros(q, dtype=np.int64)
    x = 1
    for i in range(q - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & q:  # PRIM_POLY includes the x^l bit, so this clears it too
            x ^= PRIM_POLY[l]
    exp[q - 1:] = exp[: q - 1]
    return exp, log


# ---------------------------------------------------------------------------
# Host (numpy) arithmetic
# ---------------------------------------------------------------------------

def gf_mul_np(a, b, l: int):
    """Elementwise GF(2^l) product of numpy arrays (any int dtype)."""
    exp, log = gf_tables(l)
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    out = exp[log[a] + log[b]]
    out = np.where((a == 0) | (b == 0), 0, out)
    return out.astype(WORD_DTYPE[l])


def gf_inv_scalar(a: int, l: int) -> int:
    if a == 0:
        raise ZeroDivisionError("no inverse of 0")
    exp, log = gf_tables(l)
    q = 1 << l
    return int(exp[(q - 1 - log[a]) % (q - 1)])


def gf_mul_scalar(a: int, b: int, l: int) -> int:
    return int(gf_mul_np(np.int64(a), np.int64(b), l))


def gf_pow_scalar(a: int, e: int, l: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    exp, log = gf_tables(l)
    q = 1 << l
    return int(exp[(int(log[a]) * e) % (q - 1)])


def gf_matmul_np(A: np.ndarray, B: np.ndarray, l: int) -> np.ndarray:
    """GF matrix product: A (n,k) x B (k,...) -> (n,...), xor-accumulated."""
    A = np.asarray(A)
    B = np.asarray(B)
    n, k = A.shape
    if B[0].size >= TABLE_MATMUL_MIN_COLS[l]:
        return _gf_matmul_tables(A, B, l)
    out = np.zeros((n,) + B.shape[1:], dtype=WORD_DTYPE[l])
    for j in range(k):
        out ^= gf_mul_np(A[:, j].reshape((n,) + (1,) * (B.ndim - 1)), B[j][None], l)
    return out


#: columns of B from which ``gf_matmul_np`` builds a product table per column
#: of A (2^l rows each) rather than multiplying through int64 log/exp arrays
#: of B's size per column: past it building the tables costs less than the
#: gathers they save.
TABLE_MATMUL_MIN_COLS = {8: 1 << 10, 16: 1 << 18}


def _gf_matmul_tables(A: np.ndarray, B: np.ndarray, l: int) -> np.ndarray:
    """``gf_matmul_np`` through tables: T_j[x] = A[:, j] * x for every field
    element x, gathered at B[j] and xor-accumulated in (cols, n) order."""
    n, k = A.shape
    field = np.arange(1 << l, dtype=np.int64)[:, None]
    flat = B.reshape(k, -1)
    acc = np.zeros((flat.shape[1], n), dtype=WORD_DTYPE[l])
    for j in range(k):
        acc ^= gf_mul_np(field, A[:, j][None, :], l)[flat[j]]
    return np.ascontiguousarray(acc.T).reshape((n,) + B.shape[1:])


def gf_rank_np(M: np.ndarray, l: int) -> int:
    """Rank over GF(2^l) via Gaussian elimination, vectorized per pivot step."""
    exp, log = gf_tables(l)
    M = np.array(M, dtype=np.int64, copy=True)
    rows, cols = M.shape
    rank = 0
    for c in range(cols):
        col = M[rank:, c]
        nz = np.nonzero(col)[0]
        if nz.size == 0:
            continue
        piv = rank + int(nz[0])
        if piv != rank:
            M[[rank, piv]] = M[[piv, rank]]
        # normalize pivot row, then eliminate column c from ALL other rows at once
        inv = gf_inv_scalar(int(M[rank, c]), l)
        pivrow = gf_mul_np(M[rank], np.int64(inv), l).astype(np.int64)
        M[rank] = pivrow
        factors = M[:, c].copy()
        factors[rank] = 0
        nzr = np.nonzero(factors)[0]
        if nzr.size:
            upd = exp[log[factors[nzr]][:, None] + log[pivrow][None, :]]
            upd = np.where(pivrow[None, :] == 0, 0, upd)
            M[nzr] ^= upd
        rank += 1
        if rank == rows:
            break
    return rank


def gf_inv_matrix_np(M: np.ndarray, l: int) -> np.ndarray:
    """Inverse of a square GF(2^l) matrix (host Gaussian elimination)."""
    M = np.array(M, dtype=np.int64, copy=True)
    k = M.shape[0]
    if M.shape != (k, k):
        raise ValueError(f"gf_inv_matrix_np: matrix {M.shape} is not square")
    aug = np.concatenate([M, np.eye(k, dtype=np.int64)], axis=1)
    for c in range(k):
        piv = None
        for r in range(c, k):
            if aug[r, c] != 0:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular GF matrix")
        aug[[c, piv]] = aug[[piv, c]]
        inv = gf_inv_scalar(int(aug[c, c]), l)
        aug[c] = gf_mul_np(aug[c], np.int64(inv), l)
        for r in range(k):
            if r != c and aug[r, c] != 0:
                aug[r] ^= gf_mul_np(aug[c], aug[r, c], l).astype(np.int64)
    return aug[:, k:].astype(WORD_DTYPE[l])


# ---------------------------------------------------------------------------
# torch table arithmetic (the plain word-level reference on a device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _torch_tables(l: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    exp, log = gf_tables(l)
    return (torch.from_numpy(exp).to(device), torch.from_numpy(log).to(device))


def gf_mul(a: torch.Tensor, b: torch.Tensor, l: int) -> torch.Tensor:
    """Elementwise GF(2^l) product of word tensors (broadcasts) -> words.

    The table gather runs on int64 indices: torch's CUDA build has no
    indexing kernel for uint16.
    """
    exp, log = _torch_tables(l, a.device)
    ai = a.to(torch.int64)
    bi = b.to(torch.int64)
    prod = torch.where((ai == 0) | (bi == 0), 0, exp[log[ai] + log[bi]])
    return prod.to(TORCH_WORD_DTYPE[l])


def gf_matmul(A, B: torch.Tensor, l: int) -> torch.Tensor:
    """A (n, k) coefficients (numpy or tensor) x B (k, ...) words -> (n, ...)."""
    A = torch.as_tensor(np.asarray(A, dtype=np.int64), device=B.device)
    n, k = A.shape
    if B.shape[0] != k:
        raise ValueError(f"gf_matmul: {k} coefficient columns but {B.shape[0]} rows")
    out = torch.zeros((n,) + tuple(B.shape[1:]), dtype=torch.int64, device=B.device)
    for j in range(k):
        term = gf_mul(A[:, j].reshape((n,) + (1,) * (B.dim() - 1)), B[j][None], l)
        out ^= term.to(torch.int64)
    return out.to(TORCH_WORD_DTYPE[l])


# ---------------------------------------------------------------------------
# Packed bit-plane arithmetic on torch int32 lanes
# ---------------------------------------------------------------------------

def pack_u32(x: torch.Tensor, l: int) -> torch.Tensor:
    """Pack GF(2^l) words (uint8/uint16) along the last dim into int32 lanes.

    Little-endian within the lane, so on a contiguous last axis this is the
    zero-copy dtype view ``x.view(torch.int32)``. Last dim must be a
    multiple of ``LANES[l]``.
    """
    if sys.byteorder != "little":
        raise RuntimeError("pack_u32 needs a little-endian host")
    if x.dtype != TORCH_WORD_DTYPE[l]:
        raise ValueError(f"pack_u32: words must be {TORCH_WORD_DTYPE[l]} for "
                         f"GF(2^{l}), got {x.dtype}")
    if x.dim() == 0 or x.shape[-1] % LANES[l]:
        raise ValueError(f"pack_u32: last dim of {tuple(x.shape)} must be a "
                         f"multiple of {LANES[l]} words")
    return x.contiguous().view(torch.int32)


def unpack_u32(xp: torch.Tensor, l: int) -> torch.Tensor:
    """Inverse of ``pack_u32``: int32 lanes -> GF(2^l) words (a dtype view)."""
    if xp.dtype != torch.int32:
        raise ValueError(f"unpack_u32: lanes must be int32, got {xp.dtype}")
    return xp.contiguous().view(TORCH_WORD_DTYPE[l])


def bitplane_consts(c: int, l: int) -> list[int]:
    """Per-bit constants for multiply-by-c: const_j = c * alpha^j (alpha = x)."""
    return [gf_mul_scalar(c, 1 << j, l) for j in range(l)]


def bitplane_table(M, l: int) -> np.ndarray:
    """Vectorized ``bitplane_consts`` over a whole coefficient array.

    (...,) GF(2^l) coefficients -> (..., l) uint32 with
    ``out[..., j] = M[...] * alpha^j``.
    """
    M = np.asarray(M, dtype=np.int64)
    pows = np.asarray([1 << j for j in range(l)], dtype=np.int64)
    return gf_mul_np(M[..., None], pows, l).astype(np.uint32)


def gf_mul_const_packed(xp: torch.Tensor, c: int, l: int) -> torch.Tensor:
    """Multiply packed int32 lanes by coefficient c; pure shift/mask/mul/xor.

    Each lane byte/halfword b satisfies ``c*b = xor_j bit_j(b) * (c*alpha^j)``;
    since mask lanes are in {0,1} and const_j < 2^l, the integer product never
    carries across packed lanes.
    """
    acc = torch.zeros_like(xp)
    if c == 0:
        return acc
    for j, const_j in enumerate(bitplane_consts(c, l)):
        if const_j:
            acc ^= ((xp >> j) & LSB_MASK[l]) * const_j
    return acc


def gf_matvec_packed(coeffs: np.ndarray, Xp: torch.Tensor, l: int) -> torch.Tensor:
    """coeffs (n,k) numpy x packed blocks Xp (k, Bp) int32 -> (n, Bp) int32.

    One mask per (input row, bit), shared by every output row.
    """
    coeffs = np.asarray(coeffs)
    n, k = coeffs.shape
    if Xp.shape[0] != k:
        raise ValueError(f"gf_matvec_packed: {k} coefficient columns but "
                         f"{Xp.shape[0]} packed rows")
    planes = bitplane_table(coeffs, l)            # (n, k, l)
    out = torch.zeros((n,) + tuple(Xp.shape[1:]), dtype=torch.int32,
                      device=Xp.device)
    for j in range(k):
        for b in range(l):
            rows = [i for i in range(n) if planes[i, j, b]]
            if not rows:
                continue
            m = (Xp[j] >> b) & LSB_MASK[l]
            for i in rows:
                out[i] ^= m * int(planes[i, j, b])
    return out
