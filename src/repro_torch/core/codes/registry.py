"""Registry of erasure-code families, keyed by the manifest ``family`` tag.

Families register a *constructor path* (``"module:attr"``) rather than the
class itself so registration stays import-cycle-free: ``rapidraid.py``
imports ``codes.base`` (which triggers ``codes/__init__``), and the
constructor module is only imported at first ``make()``.

Canonical codes are memoized per spec, so two ``make()`` calls with the
same ``(family, n, k, l, seed)`` return the SAME object — the per-code
caches of the storage paths (product tables, decode tables, repair plans)
stay warm across call sites.
"""
from __future__ import annotations

import functools
import importlib

from repro_torch.core.codes.base import CodeSpec, ErasureCode

_REGISTRY: dict[str, str] = {}


def register(family: str, constructor_path: str) -> None:
    """Register ``family`` -> ``"module:attr"``; attr(n, k, l=, seed=)."""
    _REGISTRY[family] = constructor_path


def families() -> tuple[str, ...]:
    """Registered family names, sorted (for stable error messages)."""
    return tuple(sorted(_REGISTRY))


def _constructor(family: str):
    try:
        path = _REGISTRY[family]
    except KeyError:
        raise ValueError(
            f"unknown code family {family!r}; registered families: "
            f"{', '.join(families())}") from None
    mod_name, _, attr = path.partition(":")
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr)


@functools.lru_cache(maxsize=512)
def _make_cached(family: str, n: int, k: int, l: int, seed: int) -> ErasureCode:
    return _constructor(family)(n, k, l=l, seed=seed)


def make(family: str, n: int, k: int, l: int = 16, seed: int = 0) -> ErasureCode:
    """Build (or fetch the canonical memoized instance of) a code."""
    return _make_cached(family, int(n), int(k), int(l), int(seed))


def from_spec(spec: CodeSpec) -> ErasureCode:
    """Reconstruct the exact code a manifest/jitcache spec describes."""
    return make(spec.family, spec.n, spec.k, l=spec.l, seed=spec.seed)
