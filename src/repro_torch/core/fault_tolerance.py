"""Fault-tolerance analysis of RapidRAID codes (paper §V-A, Fig. 3, Table I).

* k-subset enumeration: a codeword subset S (|S| = k) is decodable iff
  rank(G_S) = k. The code is MDS iff every k-subset is decodable.
* natural vs accidental dependencies: a dependent k-subset is *natural* if it
  stays dependent for independently re-drawn random coefficients (structural,
  caused by the pipeline recursion); otherwise it is *accidental* (bad luck in
  the coefficient draw). We detect natural dependencies as the intersection of
  dependent sets across ``trials`` random codes over GF(2^16) — the chance an
  accidental dependency survives t independent draws is ~(2^16)^-t.
* static resilience: P(object recoverable | each node fails iid w.p. p),
  reported as "number of 9s" (Table I).
"""
from __future__ import annotations

import itertools
import math
from typing import Iterable

import numpy as np

from repro_torch.core import codes, gf, rapidraid


def dependent_ksubsets(G: np.ndarray, k: int, l: int) -> list[tuple[int, ...]]:
    """All k-subsets S of codeword indices with rank(G_S) < k."""
    n = G.shape[0]
    dep = []
    for S in itertools.combinations(range(n), k):
        if gf.gf_rank_np(G[list(S)], l) < k:
            dep.append(S)
    return dep


def natural_dependencies(n: int, k: int, l: int = 16, trials: int = 3,
                         seed: int = 0) -> set[tuple[int, ...]]:
    """Structural dependent k-subsets of the (n,k) RapidRAID construction."""
    common: set[tuple[int, ...]] | None = None
    for t in range(trials):
        code = rapidraid.RapidRAIDCode.make(n, k, l=l, seed=seed + 1000 * t + 1)
        dep = set(dependent_ksubsets(code.G, k, l))
        common = dep if common is None else (common & dep)
        if not common:
            break
    return common or set()


def is_mds(code) -> bool:
    return not dependent_ksubsets(code.G, code.k, code.l)


def search_coefficients(n: int, k: int, l: int, target: int | None = None,
                        max_trials: int = 32, seed: int = 0):
    """Random coefficient search (paper §V-A / §VI-A).

    Returns (best_code, best_dependent_count, n_trials_used). Stops early when
    the dependent count reaches ``target`` (the natural-dependency count —
    i.e. zero accidental dependencies remain).
    """
    best = None
    best_cnt = None
    for t in range(max_trials):
        code = rapidraid.RapidRAIDCode.make(n, k, l=l, seed=seed + t)
        cnt = len(dependent_ksubsets(code.G, k, l))
        if best_cnt is None or cnt < best_cnt:
            best, best_cnt = code, cnt
        if target is not None and best_cnt <= target:
            break
    return best, best_cnt, t + 1


# ---------------------------------------------------------------------------
# Static resilience (Table I)
# ---------------------------------------------------------------------------

def recoverability_by_size(G: np.ndarray, k: int, l: int) -> dict[int, int]:
    """#recoverable survivor-sets per size j (k <= j <= n).

    Uses monotonicity: S (|S| > k) is recoverable iff it contains at least one
    independent k-subset, so we early-exit on the first independent k-subset.
    """
    n = G.shape[0]
    dep = set(dependent_ksubsets(G, k, l))
    counts: dict[int, int] = {}
    for j in range(k, n + 1):
        good = 0
        for S in itertools.combinations(range(n), j):
            if any(sub not in dep for sub in itertools.combinations(S, k)):
                good += 1
        counts[j] = good
    return counts


def static_resilience_code(G: np.ndarray, k: int, l: int, p: float) -> float:
    """P(recover) with iid node-failure probability p, exact enumeration."""
    n = G.shape[0]
    counts = recoverability_by_size(G, k, l)
    return sum(cnt * (1 - p) ** j * p ** (n - j) for j, cnt in counts.items())


def static_resilience_mds(n: int, k: int, p: float) -> float:
    return sum(math.comb(n, j) * (1 - p) ** j * p ** (n - j) for j in range(k, n + 1))


def static_resilience_replication(replicas: int, p: float) -> float:
    """Per-block resilience of an r-way replicated object (paper's baseline)."""
    return 1.0 - p ** replicas


def nines(p_success: float) -> int:
    """'Number of 9s': floor(-log10(P(failure))). Table I metric."""
    p_fail = 1.0 - p_success
    if p_fail <= 0:
        return 99
    return int(math.floor(-math.log10(p_fail) + 1e-6))


# ---------------------------------------------------------------------------
# Repair planning (runtime repair / degraded reads, repro_torch.storage.repair)
# ---------------------------------------------------------------------------

def repair_plan(code, missing: Iterable[int],
                alive: Iterable[int]) -> tuple[list[int], np.ndarray]:
    """Helpers and coefficients reconstructing lost codeword rows.

    Dispatches to the code's own plan (``code.repair_plan``) when the code
    speaks the ErasureCode API — locality-aware families (LRC) return
    plans touching only the local group. The generic fallback picks a
    decodable k-subset H of the surviving rows (greedy independent rows of
    G) and returns ``(helpers, R)`` with ``R`` the (len(missing), k) GF
    matrix satisfying ``R @ c[helpers] = c[missing]``:
    R = G_missing @ G_H^{-1}. One GF inner product over the helper shards
    per lost row — no full-object decode.

    Raises ValueError (cleanly, before touching any data) when the
    survivors are not decodable.
    """
    if isinstance(code, codes.ErasureCode):
        return code.repair_plan(missing, alive)
    return codes.matrix_repair_plan(code, missing, alive)


def repair_matrix(code, missing: Iterable[int],
                  alive: Iterable[int]) -> np.ndarray:
    """(len(missing), len(alive)) R' with R' @ c[alive] = c[missing].

    Columns for survivors outside the chosen helper k-subset are zero —
    convenient when the caller already holds all surviving shards in
    ``alive`` order.
    """
    missing = list(missing)
    alive = list(alive)
    helpers, R = repair_plan(code, missing, alive)
    out = np.zeros((len(missing), len(alive)), dtype=gf.WORD_DTYPE[code.l])
    for col, h in enumerate(helpers):
        out[:, alive.index(h)] = R[:, col]
    return out


def resilience_table(code, probs: Iterable[float] = (0.2, 0.1, 0.01, 0.001)):
    """Reproduce Table I rows for a given RapidRAID code."""
    counts = recoverability_by_size(code.G, code.k, code.l)  # enumerate once
    n = code.n
    rows = {}
    for p in probs:
        p_rr = sum(c * (1 - p) ** j * p ** (n - j) for j, c in counts.items())
        rows[p] = {
            "3-replica": nines(static_resilience_replication(3, p)),
            f"({code.n},{code.k}) classical EC": nines(
                static_resilience_mds(code.n, code.k, p)),
            f"({code.n},{code.k}) RapidRAID": nines(p_rr),
        }
    return rows
