"""Classical systematic Reed-Solomon erasure code (the paper's CEC baseline).

Cauchy generator construction, as in Jerasure's cauchy_good codes used by the
paper: G = [I_k ; C] with C[i, j] = 1 / (x_i + y_j) over GF(2^l) for distinct
points {x_i} and {y_j}. Every k x k submatrix of G is invertible, so the code
is MDS: any k of the n = k + m blocks reconstruct the object.

The code is a pure function of (n, k, l): nothing is drawn, so a code built
here is the same code as anywhere else with those parameters.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import gf


def cauchy_matrix(m: int, k: int, l: int) -> np.ndarray:
    if m + k > (1 << l):
        raise ValueError(f"(m+k)={m+k} points do not fit in GF(2^{l})")
    y = np.arange(k, dtype=np.int64)          # y_j = j
    x = np.arange(k, k + m, dtype=np.int64)   # x_i = k + i, disjoint from y
    C = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            C[i, j] = gf.gf_inv_scalar(int(x[i] ^ y[j]), l)
    return C.astype(gf.WORD_DTYPE[l])


@dataclasses.dataclass(frozen=True)
class ClassicalRSCode:
    n: int
    k: int
    l: int

    @functools.cached_property
    def G(self) -> np.ndarray:
        ident = np.eye(self.k, dtype=gf.WORD_DTYPE[self.l])
        return np.concatenate([ident, cauchy_matrix(self.n - self.k, self.k, self.l)])

    @functools.cached_property
    def parity_matrix(self) -> np.ndarray:
        return self.G[self.k:]

    @property
    def storage_overhead(self) -> float:
        return self.n / self.k


def make_code(n: int, k: int, l: int = 8) -> ClassicalRSCode:
    return ClassicalRSCode(n=n, k=k, l=l)


def encode(code: ClassicalRSCode, data: torch.Tensor) -> torch.Tensor:
    """data (k, B) words -> parity blocks (m, B); the codeword is [data; parity]."""
    return gf.gf_matmul(code.parity_matrix, data, code.l)


def encode_np(code: ClassicalRSCode, data: np.ndarray) -> np.ndarray:
    return gf.gf_matmul_np(code.parity_matrix, data, code.l)


def decode_matrix(code: ClassicalRSCode, ids) -> np.ndarray:
    ids = list(ids)
    G_sub = code.G[ids].astype(np.int64)
    if gf.gf_rank_np(G_sub, code.l) < code.k:
        raise ValueError(f"shard set {ids} is not decodable")
    chosen: list[int] = []
    for pos in range(len(ids)):
        if gf.gf_rank_np(G_sub[chosen + [pos]], code.l) == len(chosen) + 1:
            chosen.append(pos)
        if len(chosen) == code.k:
            break
    inv = gf.gf_inv_matrix_np(G_sub[chosen], code.l)
    D = np.zeros((code.k, len(ids)), dtype=gf.WORD_DTYPE[code.l])
    D[:, chosen] = inv
    return D


def decode(code: ClassicalRSCode, ids, shards: torch.Tensor) -> torch.Tensor:
    return gf.gf_matmul(decode_matrix(code, ids), shards, code.l)


def decode_np(code: ClassicalRSCode, ids, shards: np.ndarray) -> np.ndarray:
    return gf.gf_matmul_np(decode_matrix(code, ids), shards, code.l)
