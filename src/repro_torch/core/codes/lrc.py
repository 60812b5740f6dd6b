"""Locally Repairable Code (LRC) family — local XOR groups + global parities.

Following Sathiamoorthy et al. ("XORing Elephants", PAPERS.md): the k data
blocks are stored systematically and split into ``g`` contiguous local
groups; each group gets one XOR parity (coefficient 1 over GF(2^l), i.e. a
plain XOR of the group members), and the remaining ``n - k - g`` rows are
global parities with seeded random nonzero coefficients over all k blocks.

Layout of the n codeword rows:

  rows 0..k-1        data blocks (systematic)
  rows k..k+g-1      local XOR parities, one per group
  rows k+g..n-1      global parities

The family's point: a SINGLE lost shard whose local group is otherwise
intact is repaired by XORing the surviving group members + group parity —
``repair_plan`` returns only those helpers (≤ locality shards, an all-ones
R row), and because the plan flows through the same repair paths as
RapidRAID (``storage.repair.pipelined_repair`` runs it as a chain of those
helpers, ``star_repair`` as one static encode over them), a repair touches
only the local group. The code is NOT MDS: some (n-k)-loss patterns are
undecodable, the price of locality. It has no chain schedule: it encodes
through its generator (``storage.atomic.encode_local``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from repro_torch.core import gf
from repro_torch.core.codes import base


def num_groups(n: int, k: int) -> int:
    """Default group count: roughly half the parity budget goes local."""
    return max(1, min(k, math.ceil((n - k) / 2)))


@dataclasses.dataclass(frozen=True)
class LRCCode(base.ErasureCode):
    n: int
    k: int
    l: int = 16
    seed: int = 0

    family = "lrc"

    def __post_init__(self):
        if not 1 <= self.k < self.n:
            raise ValueError(f"need 1 <= k < n, got (n={self.n}, k={self.k})")
        if self.n - self.k < num_groups(self.n, self.k) + 1:
            raise ValueError(
                f"(n={self.n}, k={self.k}) leaves no room for a global "
                f"parity next to {num_groups(self.n, self.k)} local groups")

    @functools.cached_property
    def groups(self) -> tuple[tuple[int, ...], ...]:
        """Contiguous data-block groups; group gi's parity is row k + gi."""
        g = num_groups(self.n, self.k)
        return tuple(tuple(int(b) for b in part)
                     for part in np.array_split(np.arange(self.k), g))

    @property
    def n_local(self) -> int:
        return len(self.groups)

    @property
    def n_global(self) -> int:
        return self.n - self.k - self.n_local

    @property
    def locality(self) -> int:
        """Max shards read to repair one lost data/local-parity shard."""
        return max(len(grp) for grp in self.groups)

    @functools.cached_property
    def G(self) -> np.ndarray:
        dt = gf.WORD_DTYPE[self.l]
        G = np.zeros((self.n, self.k), dtype=dt)
        G[:self.k] = np.eye(self.k, dtype=dt)
        for gi, grp in enumerate(self.groups):
            G[self.k + gi, list(grp)] = 1  # XOR parity
        rng = np.random.default_rng(self.seed)
        q = 1 << self.l
        for r in range(self.n_global):
            G[self.k + self.n_local + r] = rng.integers(
                1, q, size=self.k, dtype=np.int64).astype(dt)
        return G

    def row_group(self, row: int) -> int | None:
        """Local group index of a data/local-parity row; None for globals."""
        if row < self.k:
            for gi, grp in enumerate(self.groups):
                if row in grp:
                    return gi
            raise AssertionError(row)
        if row < self.k + self.n_local:
            return row - self.k
        return None

    def group_rows(self, gi: int) -> tuple[int, ...]:
        """All codeword rows of group gi: its data members + its parity."""
        return tuple(self.groups[gi]) + (self.k + gi,)

    def repair_plan(self, missing, alive):
        """Locality-aware plan: one lost shard with an intact group is
        rebuilt by XOR over the other group rows; anything else falls back
        to the generic global plan."""
        missing = list(missing)
        alive = list(alive)
        if len(missing) == 1:
            gi = self.row_group(missing[0])
            if gi is not None:
                helpers = [r for r in self.group_rows(gi) if r != missing[0]]
                if all(r in alive for r in helpers):
                    R = np.ones((1, len(helpers)),
                                dtype=gf.WORD_DTYPE[self.l])
                    return helpers, R
        return base.matrix_repair_plan(self, missing, alive)

    def repair_transfer_words(self, block_words: int) -> int:
        return self.locality * block_words


def make(n: int, k: int, l: int = 16, seed: int = 0) -> LRCCode:
    return LRCCode(n=n, k=k, l=l, seed=seed)
