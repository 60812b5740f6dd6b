"""Minimum-bandwidth regenerating (MBR) code — product-matrix construction.

The regenerating-code point of Dimakis et al. ("Network Coding for
Distributed Storage", PAPERS.md), realized with the exact product-matrix
construction of Rashmi, Shah & Kumar at the MBR extreme: repair of one
lost node pulls exactly beta = 1 sub-block from each of d helpers — total
repair bandwidth d * (shard/alpha) = ONE shard, versus the k full shards a
positionwise code reads. The price is storage: each node keeps alpha = d
sub-blocks, so overhead is n*d / M_sub > n/k.

Construction (d = n - 1, alpha = d, beta = 1, M_sub = k*d - k(k-1)/2):

* Psi (n x d) Vandermonde, row i = (1, x_i, ..., x_i^{d-1}) with distinct
  nonzero x_i = i + 1 — any d rows invertible, any k rows of the first k
  columns (Phi) invertible.
* Message matrix M (d x d) symmetric: M = [[S, T], [T^T, 0]] with S a
  symmetric k x k block and T k x (d-k); total distinct symbols = M_sub.
* Node i stores Psi_i @ M (alpha sub-blocks of W words each).
* Repair of node f: helper j sends mu_j = (Psi_j @ M) @ Psi_f^T (one
  sub-block); stacking d helpers, Psi_H @ (M Psi_f^T) = U, so
  M Psi_f^T = Psi_H^{-1} U, and the lost content Psi_f @ M is its
  transpose by symmetry of M.

The flattened generator ``G`` (n*alpha x M_sub) expresses every stored
sub-block as a linear combination of message symbols, so the generic rank
machinery (decodability) and the static-coefficient encode
(``storage.atomic.encode_local`` of ``G`` over ``to_message(data)``) work
unchanged; decode/repair override the positionwise defaults because shards
are sub-packetized (``rows_per_node = alpha``), and the positionwise device
paths (pipelined decode and repair) refuse the family.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import gf
from repro_torch.core.codes import base


@dataclasses.dataclass(frozen=True)
class MBRCode(base.ErasureCode):
    n: int
    k: int
    l: int = 16
    seed: int = 0  # construction is deterministic; kept for spec parity

    family = "mbr"

    def __post_init__(self):
        if not 1 <= self.k < self.n:
            raise ValueError(f"need 1 <= k < n, got (n={self.n}, k={self.k})")
        if self.n >= (1 << self.l):
            raise ValueError(
                f"need n < 2^l distinct Vandermonde points, got "
                f"(n={self.n}, l={self.l})")

    # -- geometry ----------------------------------------------------------
    @property
    def d(self) -> int:
        """Repair fan-in: helpers contacted to regenerate one node."""
        return self.n - 1

    @property
    def alpha(self) -> int:
        return self.d

    @property
    def sub_message(self) -> int:
        """Message symbols per codeword column (k*d - k(k-1)/2)."""
        return self.k * self.d - self.k * (self.k - 1) // 2

    # sub-packetized: alpha sub-blocks per node, no positionwise shards
    positionwise = False

    @property
    def rows_per_node(self) -> int:
        return self.alpha

    @property
    def storage_overhead(self) -> float:
        return self.n * self.alpha / self.sub_message

    def sub_block_words(self, block_words: int) -> int:
        """Words per sub-block W: lane-aligned ceil(k*B / M_sub)."""
        lanes = gf.LANES[self.l]
        w0 = -(-self.k * block_words // self.sub_message)
        return -(-w0 // lanes) * lanes

    def shard_words(self, block_words: int) -> int:
        return self.alpha * self.sub_block_words(block_words)

    def repair_transfer_words(self, block_words: int) -> int:
        """d helpers x beta=1 sub-block each == exactly one shard."""
        return self.d * self.sub_block_words(block_words)

    # -- matrices ----------------------------------------------------------
    @functools.cached_property
    def psi(self) -> np.ndarray:
        """(n, d) Vandermonde encoding matrix over GF(2^l)."""
        P = np.zeros((self.n, self.d), dtype=np.int64)
        for i in range(self.n):
            for j in range(self.d):
                P[i, j] = gf.gf_pow_scalar(i + 1, j, self.l)
        return P.astype(gf.WORD_DTYPE[self.l])

    def _sym_index(self, b: int, a: int) -> int | None:
        """Message-symbol index of cell M[b, a], or None for the zero block."""
        k, d = self.k, self.d
        if b >= k and a >= k:
            return None
        if b >= k or a >= k:  # T / T^T blocks
            i, j = (b, a) if b < k else (a, b)
            return k * (k + 1) // 2 + i * (d - k) + (j - k)
        i, j = min(b, a), max(b, a)  # symmetric S block
        return i * k - i * (i - 1) // 2 + (j - i)

    @functools.cached_property
    def G(self) -> np.ndarray:
        """(n*alpha, M_sub) flattened generator: sub-block (i, a) as a
        linear combination of the M_sub message symbols."""
        G = np.zeros((self.n * self.alpha, self.sub_message), dtype=np.int64)
        psi = self.psi.astype(np.int64)
        for i in range(self.n):
            for a in range(self.alpha):
                for b in range(self.d):
                    m = self._sym_index(b, a)
                    if m is not None:
                        G[i * self.alpha + a, m] ^= int(psi[i, b])
        return G.astype(gf.WORD_DTYPE[self.l])

    # -- message packing ---------------------------------------------------
    def to_message(self, data: np.ndarray) -> np.ndarray:
        """(k, B) object words -> (M_sub, W) message, zero-padded tail."""
        k, B = data.shape
        assert k == self.k
        W = self.sub_block_words(B)
        buf = np.zeros(self.sub_message * W, dtype=gf.WORD_DTYPE[self.l])
        buf[:k * B] = np.asarray(data, dtype=buf.dtype).reshape(-1)
        return buf.reshape(self.sub_message, W)

    def from_message(self, msg: np.ndarray, block_words: int) -> np.ndarray:
        return msg.reshape(-1)[:self.k * block_words].reshape(
            self.k, block_words)

    def _infer_block_words(self, W: int) -> int:
        total = self.sub_message * W
        if total % self.k:
            raise ValueError(
                f"cannot infer object size from padded {self.family} shards"
                f" — pass block_words")
        return total // self.k

    # -- encode / decode ---------------------------------------------------
    def encode_np(self, data: np.ndarray) -> np.ndarray:
        msg = self.to_message(np.asarray(data))
        rows = gf.gf_matmul_np(self.G, msg, self.l)  # (n*alpha, W)
        return rows.reshape(self.n, self.alpha * msg.shape[1])

    def decode_np(self, ids, shards: np.ndarray,
                  block_words: int | None = None) -> np.ndarray:
        ids = list(ids)
        shards = np.asarray(shards)
        W = shards.shape[1] // self.alpha
        rows = shards.reshape(len(ids) * self.alpha, W)
        sub = self.node_rows(ids)
        G_sub = self.G[sub].astype(np.int64)
        try:
            chosen = base.independent_rows(G_sub, self.sub_message, self.l)
        except ValueError as e:
            raise ValueError(
                f"shard set {ids} is not decodable: {e}") from None
        inv = gf.gf_inv_matrix_np(G_sub[chosen], self.l)
        msg = gf.gf_matmul_np(inv, rows[chosen], self.l)
        if block_words is None:
            block_words = self._infer_block_words(W)
        return self.from_message(msg, block_words)

    # -- repair ------------------------------------------------------------
    def helper_summand(self, failed: int, helper: int,
                       shard: np.ndarray) -> np.ndarray:
        """The beta=1 sub-block helper ``helper`` TRANSMITS to repair
        ``failed``: mu = Psi_helper M Psi_failed^T = shard-rows . Psi_failed.
        Shape (W,) — this is the entire per-helper repair traffic."""
        rows = np.asarray(shard).reshape(self.alpha, -1)
        coef = self.psi[failed].astype(np.int64)[None, :]  # (1, d)
        return gf.gf_matmul_np(coef, rows, self.l)[0]

    def combine_summands(self, failed: int, helper_ids,
                         mus: np.ndarray) -> np.ndarray:
        """Regenerate node ``failed`` from the d helper summands."""
        helper_ids = list(helper_ids)
        assert len(helper_ids) == self.d and failed not in helper_ids
        psi_h = self.psi[helper_ids].astype(np.int64)  # (d, d)
        inv = gf.gf_inv_matrix_np(psi_h, self.l)
        x = gf.gf_matmul_np(inv, np.asarray(mus), self.l)  # (d, W) = M Psi_f^T
        # lost content Psi_f M == (M Psi_f^T)^T rows, by symmetry of M
        return x.reshape(1, self.alpha * x.shape[1])

    def repair_helpers(self, missing, alive):
        missing = list(missing)
        alive = list(alive)
        if len(missing) == 1 and len(alive) >= self.d:
            return alive[:self.d]
        chosen: list[int] = []
        for i in alive:  # shortest decodable prefix (any k nodes suffice)
            chosen.append(i)
            if self.decodable(chosen):
                return chosen
        raise ValueError(
            f"survivors {alive} cannot regenerate rows {missing} — "
            f"not decodable")

    def repair_np(self, missing, ids, shards: np.ndarray) -> np.ndarray:
        missing = list(missing)
        ids = list(ids)
        shards = np.asarray(shards)
        if len(missing) == 1 and len(ids) >= self.d:
            f = missing[0]
            helpers = ids[:self.d]
            mus = np.stack([
                self.helper_summand(f, h, shards[ids.index(h)])
                for h in helpers])
            return self.combine_summands(f, helpers, mus)
        # multi-loss (or degraded helper set): decode the message from any
        # decodable sub-row subset and re-encode the lost nodes
        W = shards.shape[1] // self.alpha
        rows = shards.reshape(len(ids) * self.alpha, W)
        sub = self.node_rows(ids)
        G_sub = self.G[sub].astype(np.int64)
        chosen = base.independent_rows(G_sub, self.sub_message, self.l)
        inv = gf.gf_inv_matrix_np(G_sub[chosen], self.l)
        msg = gf.gf_matmul_np(inv, rows[chosen], self.l)
        lost = gf.gf_matmul_np(self.G[self.node_rows(missing)], msg, self.l)
        return lost.reshape(len(missing), self.alpha * W)


def make(n: int, k: int, l: int = 16, seed: int = 0) -> MBRCode:
    return MBRCode(n=n, k=k, l=l, seed=seed)
