"""Plain reference of RapidRAID coding over GF(2^l), the yardstick of `correct`.

It imports numpy and torch and nothing else: nothing of the program under
test and nothing of JAX. From a configuration it takes only what the paper
defines, n, k, l and the seed of the coefficient draw, and works out the
rest itself:

- the field: log / antilog tables over the primitive polynomials that the
  paper's implementation (Jerasure) uses, 0x11D for GF(2^8) and 0x1100B for
  GF(2^16), built here from the polynomial;
- the coefficients: psi then xi, one per (node, block) slot, drawn as
  ``np.random.default_rng(seed).integers(1, 2^l, size)`` (paper §V-A, the
  seeded draw of the RapidRAID construction);
- the replica placement (§IV: replica 1 on nodes 0..k-1, replica 2 on nodes
  n-k..n-1) and the generator matrix, unrolled from the chain's recurrences
  (Eqs. 3-4): node i keeps c_i = x_{i-1,i} + sum_j o_j xi and forwards
  x_{i,i+1} = x_{i-1,i} + sum_j o_j psi;
- ranks, decode matrices D (D @ c[ids] = o) and repair matrices R
  (R @ c[helpers] = c[lost]) by Gauss-Jordan elimination on Python integers.

``apply`` multiplies a coefficient matrix into word rows on whatever device
the words are on: a product by a constant c is exp[log x + log c], with
x = 0 masked, and the terms are xor-accumulated. It works in column blocks
so that a 64 MiB block never needs more than a few hundred MiB at once.
Words travel as uint8 / uint16 tensors and are computed as int32 in [0, 2^l).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

PRIM_POLY = {8: 0x11D, 16: 0x1100B}
WORD_DTYPE = {8: torch.uint8, 16: torch.uint16}
#: words a column block of ``apply`` holds
BLOCK_COLS = 1 << 23


def placement(n: int, k: int) -> list[list[int]]:
    """The blocks each of the n nodes holds before archival."""
    if not k <= n <= 2 * k:
        raise ValueError(f"need k <= n <= 2k, got ({n}, {k})")
    return [([i] if i < k else []) + ([i - (n - k)] if i >= n - k else [])
            for i in range(n)]


class Field:
    """GF(2^l) by log / antilog tables, on the host and on one device."""

    def __init__(self, l: int, device=None):
        if l not in PRIM_POLY:
            raise ValueError(f"no field GF(2^{l})")
        self.l, self.q = l, 1 << l
        exp = np.zeros(2 * (self.q - 1), dtype=np.int64)
        log = np.zeros(self.q, dtype=np.int64)
        x = 1
        for i in range(self.q - 1):
            exp[i], log[x] = x, i
            x <<= 1
            if x & self.q:
                x ^= PRIM_POLY[l]
        exp[self.q - 1:] = exp[:self.q - 1]
        self.exp, self.log = exp, log
        self.device = torch.device("cpu" if device is None else device)
        self.exp_t = torch.tensor(exp, dtype=torch.int32, device=self.device)
        self.log_t = torch.tensor(log, dtype=torch.int32, device=self.device)

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("0 has no inverse")
        return int(self.exp[(self.q - 1 - self.log[a]) % (self.q - 1)])

    def gauss(self, M) -> tuple[int, np.ndarray | None]:
        """(rank of M, and for a square M of full rank its inverse, else None)."""
        M = [[int(v) for v in row] for row in np.asarray(M)]
        rows, cols = len(M), len(M[0])
        square = rows == cols
        aug = [row + ([int(r == c) for c in range(rows)] if square else [])
               for r, row in enumerate(M)]
        rank = 0
        for c in range(cols):
            piv = next((r for r in range(rank, rows) if aug[r][c]), None)
            if piv is None:
                continue
            aug[rank], aug[piv] = aug[piv], aug[rank]
            s = self.inv(aug[rank][c])
            aug[rank] = [self.mul(s, v) for v in aug[rank]]
            for r in range(rows):
                f = aug[r][c]
                if r != rank and f:
                    aug[r] = [v ^ self.mul(f, p) for v, p in zip(aug[r], aug[rank])]
            rank += 1
        if not square or rank < rows:
            return rank, None
        return rank, np.array([row[cols:] for row in aug], dtype=np.int64)

    def matmul(self, A, B) -> np.ndarray:
        """A (r, m) @ B (m, c) over the field, on the host."""
        A, B = np.asarray(A, dtype=np.int64), np.asarray(B, dtype=np.int64)
        out = np.zeros((A.shape[0], B.shape[1]), dtype=np.int64)
        for i, j in itertools.product(range(A.shape[0]), range(B.shape[1])):
            acc = 0
            for t in range(A.shape[1]):
                acc ^= self.mul(int(A[i, t]), int(B[t, j]))
            out[i, j] = acc
        return out


def draw_coefficients(n: int, k: int, l: int, seed: int) -> tuple[list[int], list[int]]:
    """(psi, xi): one nonzero coefficient per (node, block) slot, psi for
    every node but the last (it forwards nothing), drawn psi first."""
    place = placement(n, k)
    n_xi = sum(len(b) for b in place)
    n_psi = n_xi - len(place[-1])
    rng = np.random.default_rng(seed)
    psi = [int(v) for v in rng.integers(1, 1 << l, size=n_psi)]
    xi = [int(v) for v in rng.integers(1, 1 << l, size=n_xi)]
    return psi, xi


def to_int32(words: torch.Tensor, l: int) -> torch.Tensor:
    """uint8 / uint16 words as int32 in [0, 2^l)."""
    if l == 16:
        return words.view(torch.int16).to(torch.int32) & 0xFFFF
    return words.to(torch.int32)


def to_words(x: torch.Tensor, l: int) -> torch.Tensor:
    """int32 in [0, 2^l) as uint8 / uint16 words."""
    if l == 16:
        return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16).view(torch.uint16)
    return x.to(torch.uint8)


class Code:
    """The RapidRAID (n, k) code over GF(2^l) drawn from ``seed``."""

    def __init__(self, n: int, k: int, l: int, seed: int, device=None):
        self.n, self.k, self.l = n, k, l
        self.field = Field(l, device)
        self.place = placement(n, k)
        self.psi, self.xi = draw_coefficients(n, k, l, seed)
        self.G = self._generator()

    def _generator(self) -> np.ndarray:
        """(n, k): row i holds the coefficients of c_i over the k blocks."""
        G = np.zeros((self.n, self.k), dtype=np.int64)
        x = np.zeros(self.k, dtype=np.int64)     # the forwarded combination
        pi = ci = 0
        for i, blocks in enumerate(self.place):
            row = x.copy()
            for b in blocks:
                row[b] ^= self.xi[ci]
                ci += 1
            G[i] = row
            if i < self.n - 1:
                for b in blocks:
                    x[b] ^= self.psi[pi]
                    pi += 1
        return G

    def decodable(self, ids) -> bool:
        return self.field.gauss(self.G[list(ids)])[0] == self.k

    def decode_matrix(self, ids) -> np.ndarray:
        """(k, k) D with D @ c[ids] = o, for k decodable survivors ``ids``."""
        ids = list(ids)
        if len(ids) != self.k:
            raise ValueError(f"decode from exactly k={self.k} survivors, got {len(ids)}")
        _, inv = self.field.gauss(self.G[ids])
        if inv is None:
            raise ValueError(f"survivors {ids} cannot be decoded")
        return inv

    def repair_matrix(self, lost, survivors) -> tuple[list[int], np.ndarray]:
        """(helpers, R): the first k survivors, in order, whose rows are
        independent, and R (|lost|, k) with R @ c[helpers] = c[lost]."""
        helpers: list[int] = []
        for s in survivors:
            if self.field.gauss(self.G[helpers + [s]])[0] == len(helpers) + 1:
                helpers.append(int(s))
            if len(helpers) == self.k:
                break
        if len(helpers) < self.k:
            raise ValueError(f"survivors {list(survivors)} cannot rebuild {list(lost)}")
        R = self.field.matmul(self.G[list(lost)], self.decode_matrix(helpers))
        return helpers, R

    def on(self, device) -> Field:
        """The field with its tables on ``device``."""
        if self.field.device != torch.device(device):
            self.field = Field(self.l, device)
        return self.field

    def apply(self, M, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """M (r, m) coefficients into X (m, W) words -> (r, W) words."""
        return apply(self.on(X.device), M, X, out)

    def apply_narrow(self, M, X: torch.Tensor) -> torch.Tensor:
        """The control: M applied to every byte of the words X in GF(2^8),
        each coefficient cut to its low byte, the field below the
        configuration's (the step a change might take for smaller tables)."""
        narrow = Field(8, X.device)
        M8 = np.asarray(M, dtype=np.int64) & 0xFF
        return apply(narrow, M8, X.contiguous().view(torch.uint8)).view(X.dtype)

    def encode(self, data: torch.Tensor, rows=None, out=None) -> torch.Tensor:
        """Codeword rows ``rows`` (default all n) of one object (k, W)."""
        G = self.G if rows is None else self.G[list(rows)]
        return self.apply(G, data, out)


def apply(F: Field, M, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """M (r, m) coefficients of GF(2^l) into X (m, W) words -> (r, W) words,
    on X's device, column block by column block; into ``out`` when given."""
    M = np.asarray(M, dtype=np.int64)
    r, m = M.shape
    if X.shape[0] != m:
        raise ValueError(f"{m} coefficient columns but {X.shape[0]} word rows")
    W = X.shape[1]
    if out is None:
        out = torch.empty((r, W), dtype=WORD_DTYPE[F.l], device=X.device)
    for lo in range(0, W, BLOCK_COLS):
        hi = min(W, lo + BLOCK_COLS)
        acc = torch.zeros((r, hi - lo), dtype=torch.int32, device=X.device)
        for j in range(m):
            col = [(i, int(F.log[M[i, j]])) for i in range(r) if M[i, j]]
            if not col:
                continue
            x = to_int32(X[j, lo:hi], F.l)
            zero = x == 0
            lx = F.log_t.index_select(0, x)
            for i, lc in col:
                acc[i] ^= F.exp_t.index_select(0, lx + lc).masked_fill_(zero, 0)
        out[:, lo:hi] = to_words(acc, F.l)
    return out
