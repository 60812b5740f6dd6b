"""RapidRAID pipelined erasure codes (paper §IV–V).

A RapidRAID (n, k) code, n <= 2k, archives an object of k blocks that is
initially stored as TWO replicas overlapped over n nodes:

  * replica 1 on nodes 0..k-1        (node i holds block i)
  * replica 2 on nodes n-k..n-1      (node n-k+i holds block i)

(for n == 2k the replicas are disjoint; for n < 2k the middle 2k-n nodes hold
two blocks each — the paper's (6,4) example).

The encoding is a chain: node i receives the running combination x_{i-1,i}
from its predecessor and

  x_{i,i+1} = x_{i-1,i} + sum_{o_j in node i} o_j * psi   (Eq. 3, forwarded)
  c_i       = x_{i-1,i} + sum_{o_j in node i} o_j * xi    (Eq. 4, kept)

with one fresh psi/xi coefficient per (node, local block) slot. The resulting
code is linear and non-systematic; its (n x k) generator matrix is built here
by unrolling the recursion symbolically over GF(2^l).

The code itself is host numpy: the coefficients are the only drawn state of
the system, and ``code_from_reference`` carries them over from another
implementation's code record. ``encode`` / ``decode`` apply its matrices to
word tensors with the port's table arithmetic (``gf.gf_matmul``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import gf
from repro_torch.core.codes import base as code_base


def placement(n: int, k: int) -> tuple[tuple[int, ...], ...]:
    """Blocks (0-based ids) held by each of the n nodes before archival."""
    if not k <= n <= 2 * k:
        raise ValueError(f"need k <= n <= 2k, got (n={n}, k={k})")
    nodes = []
    for i in range(n):
        blocks = []
        if i < k:
            blocks.append(i)
        if i >= n - k:
            blocks.append(i - (n - k))
        nodes.append(tuple(blocks))
    return tuple(nodes)


def coeff_slots(n: int, k: int) -> tuple[int, int]:
    """Number of (psi, xi) coefficients: one per (node, block) slot.

    The last node never forwards, so it consumes no psi slots.
    """
    place = placement(n, k)
    n_xi = sum(len(b) for b in place)
    n_psi = n_xi - len(place[-1])
    return n_psi, n_xi


def build_generator(n: int, k: int, psi, xi, l: int) -> np.ndarray:
    """Unroll Eqs. (3)-(4) into the (n x k) generator matrix over GF(2^l)."""
    place = placement(n, k)
    n_psi, n_xi = coeff_slots(n, k)
    psi = np.asarray(psi, dtype=np.int64)
    xi = np.asarray(xi, dtype=np.int64)
    if psi.shape != (n_psi,) or xi.shape != (n_xi,):
        raise ValueError(f"({n},{k}) needs {n_psi} psi and {n_xi} xi "
                         f"coefficients, got {psi.shape} and {xi.shape}")
    G = np.zeros((n, k), dtype=np.int64)
    x = np.zeros(k, dtype=np.int64)  # coefficients of the forwarded combination
    pi = ci = 0
    for i in range(n):
        row = x.copy()
        for b in place[i]:
            row[b] ^= xi[ci]
            ci += 1
        G[i] = row
        if i < n - 1:
            for b in place[i]:
                x[b] ^= psi[pi]
                pi += 1
    return G.astype(gf.WORD_DTYPE[l])


@dataclasses.dataclass(frozen=True)
class RapidRAIDCode(code_base.ErasureCode):
    n: int
    k: int
    l: int
    psi: tuple[int, ...]
    xi: tuple[int, ...]
    seed: int = 0  # PRNG seed the psi/xi were drawn from (spec identity)

    family = "rapidraid"
    supports_chain_encode = True  # has a .chain pipeline schedule

    @functools.cached_property
    def place(self) -> tuple[tuple[int, ...], ...]:
        return placement(self.n, self.k)

    @functools.cached_property
    def G(self) -> np.ndarray:
        return build_generator(self.n, self.k, self.psi, self.xi, self.l)

    @functools.cached_property
    def chain(self) -> "ChainSchedule":
        return chain_schedule(self)

    @functools.cached_property
    def cache_key(self):
        # hand-built coefficient sets share a spec with the canonical
        # seeded draw; only canonical codes may key caches by spec
        if self == RapidRAIDCode.make(self.n, self.k, l=self.l,
                                      seed=self.seed):
            return self.spec
        return self

    @classmethod
    def make(cls, n: int, k: int, l: int = 16, seed: int = 0) -> "RapidRAIDCode":
        """Draw nonzero psi/xi coefficients from a seeded PRNG (paper §V-A).

        The canonical constructor: the same ``np.random.default_rng(seed)``
        draw, in the same order, as every other implementation of the code,
        so a spec reconstructs exactly this code.
        """
        n_psi, n_xi = coeff_slots(n, k)
        rng = np.random.default_rng(seed)
        q = 1 << l
        psi = tuple(int(v) for v in rng.integers(1, q, size=n_psi))
        xi = tuple(int(v) for v in rng.integers(1, q, size=n_xi))
        return cls(n=n, k=k, l=l, psi=psi, xi=xi, seed=seed)


def _make_canonical(n: int, k: int, l: int = 16, seed: int = 0) -> RapidRAIDCode:
    """Registry constructor for the ``rapidraid`` family."""
    return RapidRAIDCode.make(n, k, l=l, seed=seed)


def code_from_reference(params: dict) -> RapidRAIDCode:
    """The port's code for a code record given as plain values.

    ``params`` holds the fields ``n, k, l, psi, xi`` (and optionally
    ``seed``), e.g. ``dataclasses.asdict`` of another implementation's
    RapidRAID code. The coefficients are the code's only drawn state, so the
    result encodes and decodes exactly like the code it came from.
    """
    n, k, l = int(params["n"]), int(params["k"]), int(params["l"])
    if l not in gf.PRIM_POLY:
        raise ValueError(f"unsupported field GF(2^{l})")
    psi = tuple(int(v) for v in params["psi"])
    xi = tuple(int(v) for v in params["xi"])
    n_psi, n_xi = coeff_slots(n, k)
    if len(psi) != n_psi or len(xi) != n_xi:
        raise ValueError(f"({n},{k}) needs {n_psi} psi and {n_xi} xi "
                         f"coefficients, got {len(psi)} and {len(xi)}")
    if not all(0 < v < (1 << l) for v in psi + xi):
        raise ValueError(f"coefficients must be nonzero words of GF(2^{l})")
    return RapidRAIDCode(n=n, k=k, l=l, psi=psi, xi=xi,
                         seed=int(params.get("seed", 0)))


@dataclasses.dataclass(frozen=True)
class ChainSchedule:
    """Dense per-node view of the chain used by the pipelined data plane.

    Every node is padded to ``max_blocks`` local blocks; padded slots carry
    coefficient 0 so they contribute nothing.
    """
    n: int
    k: int
    l: int
    max_blocks: int
    local_blocks: np.ndarray   # (n, max_blocks) int32 block id (0 for padding)
    block_valid: np.ndarray    # (n, max_blocks) bool
    psi: np.ndarray            # (n, max_blocks) word, 0-padded; row n-1 all 0
    xi: np.ndarray             # (n, max_blocks) word, 0-padded


def chain_schedule(code: RapidRAIDCode) -> ChainSchedule:
    place = placement(code.n, code.k)
    mb = max(len(b) for b in place)
    dt = gf.WORD_DTYPE[code.l]
    local = np.zeros((code.n, mb), dtype=np.int32)
    valid = np.zeros((code.n, mb), dtype=bool)
    psi = np.zeros((code.n, mb), dtype=dt)
    xi = np.zeros((code.n, mb), dtype=dt)
    pi = ci = 0
    for i, blocks in enumerate(place):
        for s, b in enumerate(blocks):
            local[i, s] = b
            valid[i, s] = True
            xi[i, s] = code.xi[ci]
            ci += 1
            if i < code.n - 1:
                psi[i, s] = code.psi[pi]
                pi += 1
    return ChainSchedule(n=code.n, k=code.k, l=code.l, max_blocks=mb,
                         local_blocks=local, block_valid=valid, psi=psi, xi=xi)


def pipeline_encode_local(code: RapidRAIDCode, data: np.ndarray,
                          num_chunks: int = 4) -> tuple[np.ndarray, int]:
    """Chunk-granular simulation of the chain (oracle for storage.chain).

    Walks the pipeline schedule tick by tick exactly as the pipelined
    encode does: at tick t node i processes chunk t - i. Returns the
    codeword blocks and the number of ticks (= num_chunks + n - 1). The
    single-object special case of the staggered multi-chain below.
    """
    if data.shape[0] != code.k:
        raise ValueError(f"data {data.shape} must have k={code.k} rows")
    out, ticks = pipeline_encode_local_many(code, data[None],
                                            num_chunks=num_chunks)
    return out[0], ticks


def pipeline_encode_local_many(code: RapidRAIDCode, objects: np.ndarray,
                               num_chunks: int = 4,
                               stagger: int = 1) -> tuple[np.ndarray, int]:
    """Tick-exact simulation of the STAGGERED multi-chain: object b's chunk
    schedule is shifted by ``b * stagger`` ticks, so node i streams object b
    while object b+1 is in flight behind it — the paper's concurrent
    multi-object archival (§VI).

    objects (B_obj, k, B) words -> ((B_obj, n, B) codewords, ticks) with
    ticks = num_chunks + n - 1 + (B_obj - 1) * stagger.
    """
    n, k, l = code.n, code.k, code.l
    sched = code.chain
    B_obj, kk, B = objects.shape
    if kk != k or B % num_chunks or stagger < 1:
        raise ValueError(f"objects {objects.shape} need k={k} rows, a length "
                         f"divisible by num_chunks={num_chunks} and stagger >= 1")
    S = B // num_chunks
    dt = gf.WORD_DTYPE[l]
    out = np.zeros((B_obj, n, B), dtype=dt)
    # x_wire[b, i] = object b's chunk most recently forwarded by node i
    x_wire = np.zeros((B_obj, n, S), dtype=dt)
    ticks = num_chunks + n - 1 + (B_obj - 1) * stagger
    for t in range(ticks):
        new_wire = x_wire.copy()
        for i in range(n):      # all nodes act concurrently within a tick
            for b in range(B_obj):
                ch = t - i - b * stagger
                if not (0 <= ch < num_chunks):
                    continue
                sl = slice(ch * S, (ch + 1) * S)
                x_in = (x_wire[b, i - 1] if i > 0
                        else np.zeros(S, dtype=dt))
                c = x_in.copy()
                x_out = x_in.copy()
                for s in range(sched.max_blocks):
                    if not sched.block_valid[i, s]:
                        continue
                    blk = objects[b, sched.local_blocks[i, s], sl]
                    c ^= gf.gf_mul_np(blk, sched.xi[i, s], l)
                    x_out ^= gf.gf_mul_np(blk, sched.psi[i, s], l)
                out[b, i, sl] = c
                new_wire[b, i] = x_out
        x_wire = new_wire
    return out, ticks


# ---------------------------------------------------------------------------
# Matrix-form encode / decode (one device; the chain is repro_torch.storage)
# ---------------------------------------------------------------------------

def encode(code: RapidRAIDCode, data: torch.Tensor) -> torch.Tensor:
    """Matrix-form encode: data (k, B) words -> codeword blocks (n, B)."""
    if data.shape[0] != code.k:
        raise ValueError(f"data {tuple(data.shape)} must have k={code.k} rows")
    return gf.gf_matmul(code.G, data, code.l)


def decode_matrix(code, ids: list[int] | tuple[int, ...]) -> np.ndarray:
    """(k x len(ids)) matrix D with D @ c[ids] = o. Raises if ids are not decodable."""
    return code.decode_matrix(ids)


def decode(code, ids, shards: torch.Tensor) -> torch.Tensor:
    """Reconstruct the k original blocks from any decodable shard subset."""
    D = code.decode_matrix(ids)
    return gf.gf_matmul(D, shards, code.l)
