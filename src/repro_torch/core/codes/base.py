"""Erasure-code API shared by every code family.

The pipelined encode, decode and repair in ``repro_torch.storage`` need
only a small surface from a code: its geometry ``(n, k, l)``, a generator
matrix over GF(2^l), a decode matrix for a survivor subset and a repair
plan ``(helpers, R)`` with ``R @ c[helpers] = c[missing]``.
:class:`ErasureCode` pins that surface down, so the families (RapidRAID,
LRC, MBR) run through the same kernels; :class:`CodeSpec` — ``(family, n,
k, l, seed)`` — carries a code's identity in a hashable, serializable form,
and ``repro_torch.core.codes.from_spec`` rebuilds the code from it.

Topology hints route a family down the paths it supports:

* ``supports_chain_encode`` — the family has a RapidRAID-style chain
  schedule (``.chain``) and can use the pipelined encode path.
* ``positionwise`` — shards are node-granular positionwise linear
  combinations of the data blocks (one generator row per node), so decode
  and repair can run through the GF inner-product tick kernel.
  Sub-packetized families (regenerating codes store ``rows_per_node > 1``
  sub-blocks a node) set it False and bring their own
  ``encode_np``/``decode_np``/``repair_np``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Iterable

import numpy as np

from repro_torch.core import gf


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """Serializable code identity: enough to reconstruct the code exactly."""
    family: str
    n: int
    k: int
    l: int = 16
    seed: int = 0

    def to_manifest(self) -> dict:
        return {"family": self.family, "n": self.n, "k": self.k,
                "l": self.l, "seed": self.seed}

    @staticmethod
    def from_manifest(manifest: dict) -> "CodeSpec":
        # manifests written before code families existed are RapidRAID
        return CodeSpec(family=str(manifest.get("family", "rapidraid")),
                        n=int(manifest["n"]), k=int(manifest["k"]),
                        l=int(manifest["l"]),
                        seed=int(manifest.get("seed", 0)))


def independent_rows(G_sub: np.ndarray, k: int, l: int) -> list[int]:
    """Greedy positions of k linearly independent rows of ``G_sub``.

    Raises ValueError when rank < k.
    """
    G_sub = np.asarray(G_sub, dtype=np.int64)
    rank = gf.gf_rank_np(G_sub, l)
    if rank < k:
        raise ValueError(
            f"only rank {rank} of the required {k} available — not decodable")
    chosen: list[int] = []
    for pos in range(G_sub.shape[0]):
        trial = chosen + [pos]
        if gf.gf_rank_np(G_sub[trial], l) == len(trial):
            chosen.append(pos)
        if len(chosen) == k:
            break
    return chosen


class ErasureCode:
    """Base class for code families; concrete families are frozen dataclasses
    with (at least) fields ``n``, ``k``, ``l``, ``seed`` and a class-level
    ``family`` string.
    """

    family = "abstract"

    # -- identity ----------------------------------------------------------
    @property
    def spec(self) -> CodeSpec:
        """Hashable + serializable identity."""
        return CodeSpec(family=self.family, n=self.n, k=self.k, l=self.l,
                        seed=self.seed)

    @property
    def cache_key(self):
        """Hashable identity for caches keyed by code.

        The spec for canonical codes; families whose instances can carry
        state beyond the spec (hand-picked RapidRAID coefficients) override
        this to avoid cross-code collisions.
        """
        return self.spec

    # -- topology hints ----------------------------------------------------
    #: has a RapidRAID-style ``.chain`` schedule → pipelined chain encode
    supports_chain_encode = False
    #: node-granular positionwise shards → fused-kernel decode
    positionwise = True
    #: sub-blocks stored per node (generator rows per node)
    rows_per_node = 1

    @property
    def storage_overhead(self) -> float:
        return self.n / self.k

    def shard_words(self, block_words: int) -> int:
        """Stored words per node for a (k, block_words) object."""
        return block_words

    def repair_transfer_words(self, block_words: int) -> int:
        """Words crossing the network to repair ONE lost node (model)."""
        helpers, _ = self.repair_plan([0], list(range(1, self.n)))
        return len(helpers) * self.shard_words(block_words)

    # -- matrix surface ----------------------------------------------------
    @property
    def G(self) -> np.ndarray:
        """(n * rows_per_node, sub_k) generator over GF(2^l)."""
        raise NotImplementedError

    @property
    def sub_k(self) -> int:
        """Message symbols per codeword column (== k when rows_per_node == 1)."""
        return self.G.shape[1]

    def node_rows(self, ids: Iterable[int]) -> list[int]:
        """Generator row indices held by the given nodes, in node order."""
        r = self.rows_per_node
        return [i * r + a for i in ids for a in range(r)]

    # -- encode / decode ---------------------------------------------------
    def to_message(self, data: np.ndarray) -> np.ndarray:
        """Message view fed to the flattened generator ``G``: identity for
        positionwise codes, the padded (M_sub, W) packing for
        sub-packetized families. ``G @ to_message(data)`` reshaped to
        (n, shard_words) is every family's static-kernel encode."""
        return np.asarray(data)

    def encode_np(self, data: np.ndarray) -> np.ndarray:
        """(k, B) words -> (n, shard_words(B)) shards (host oracle)."""
        data = np.asarray(data)
        if data.shape[0] != self.k:
            raise ValueError(f"encode_np: data {data.shape} must have k={self.k} rows")
        return gf.gf_matmul_np(self.G, data, self.l)

    def decode_matrix(self, ids) -> np.ndarray:
        """(k x len(ids)) D with ``D @ c[ids] = o``; positionwise only.

        Raises ValueError if ids are not decodable.
        """
        if not self.positionwise:
            raise NotImplementedError(
                f"{self.family} is sub-packetized; use decode_np")
        ids = list(ids)
        G_sub = self.G[ids].astype(np.int64)
        try:
            chosen = independent_rows(G_sub, self.k, self.l)
        except ValueError as e:
            raise ValueError(f"shard set {ids} is not decodable: {e}") from None
        inv = gf.gf_inv_matrix_np(G_sub[chosen], self.l)  # (k, k)
        D = np.zeros((self.k, len(ids)), dtype=gf.WORD_DTYPE[self.l])
        D[:, chosen] = inv
        return D

    def decode_np(self, ids, shards: np.ndarray,
                  block_words: int | None = None) -> np.ndarray:
        """Reconstruct the (k, B) object from any decodable shard subset.

        ``block_words`` disambiguates trailing padding for sub-packetized
        families; positionwise families ignore it.
        """
        D = self.decode_matrix(ids)
        return gf.gf_matmul_np(D, np.asarray(shards), self.l)

    def decodable(self, ids: Iterable[int]) -> bool:
        """True iff the given (alive) node set can reconstruct the object."""
        return _decodable_cached(self, tuple(sorted(set(ids))))

    def max_tolerated_losses(self) -> int:
        """Largest f with EVERY f-node loss pattern still decodable."""
        return _max_losses_cached(self)

    # -- repair ------------------------------------------------------------
    def repair_plan(self, missing: Iterable[int],
                    alive: Iterable[int]) -> tuple[list[int], np.ndarray]:
        """Helpers and coefficients reconstructing lost codeword rows.

        Returns ``(helpers, R)`` with ``R @ c[helpers] = c[missing]`` —
        one GF inner product over the helper shards per lost row, no full
        decode. Raises ValueError (before touching data) when survivors
        are not decodable. Families with locality (LRC) override this to
        return plans touching fewer helpers.
        """
        return matrix_repair_plan(self, missing, alive)

    def repair_helpers(self, missing: Iterable[int],
                       alive: Iterable[int]) -> list[int]:
        """The survivor rows a repair of ``missing`` must read. Default: the
        plan's helper list; sub-packetized families override (their plan
        is not a positionwise matrix)."""
        return self.repair_plan(list(missing), list(alive))[0]

    def repair_np(self, missing, ids, shards: np.ndarray) -> np.ndarray:
        """Rebuild the lost shards from surviving shards (host oracle)."""
        helpers, R = self.repair_plan(list(missing), list(ids))
        ids = list(ids)
        sel = np.asarray(shards)[[ids.index(h) for h in helpers]]
        return gf.gf_matmul_np(R, sel, self.l)


def matrix_repair_plan(code, missing: Iterable[int],
                       alive: Iterable[int]) -> tuple[list[int], np.ndarray]:
    """Generic generator-matrix repair plan (any positionwise code).

    Picks a decodable k-subset H of the surviving rows (greedy independent
    rows of G) and returns ``(helpers, R)`` with R = G_missing @ G_H^{-1}.
    """
    missing = list(missing)
    alive = list(alive)
    if set(missing) & set(alive):
        raise ValueError(
            f"rows {set(missing) & set(alive)} both missing and alive")
    if not code.positionwise:
        raise NotImplementedError(
            f"{code.family} is sub-packetized; use repair_np")
    G_alive = code.G[alive].astype(np.int64)
    chosen = independent_rows(G_alive, code.k, code.l)  # ValueError if not
    helpers = [alive[p] for p in chosen]
    inv = gf.gf_inv_matrix_np(G_alive[chosen], code.l)  # (k, k)
    R = gf.gf_matmul_np(code.G[missing], inv, code.l)   # (|missing|, k)
    return helpers, R


@functools.lru_cache(maxsize=4096)
def _decodable_cached(code: ErasureCode, ids: tuple[int, ...]) -> bool:
    rows = code.node_rows(ids)
    return gf.gf_rank_np(code.G[rows].astype(np.int64), code.l) == code.sub_k


@functools.lru_cache(maxsize=128)
def _max_losses_cached(code: ErasureCode) -> int:
    nodes = range(code.n)
    for f in range(1, code.n - code.k + 1):
        for lost in itertools.combinations(nodes, f):
            if not code.decodable(set(nodes) - set(lost)):
                return f - 1
    return code.n - code.k
