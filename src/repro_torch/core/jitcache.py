"""Shared program cache for the warm archival fast path.

Every pipelined entry point in ``repro_torch.storage`` (encode, decode and
repair, their staggered multi-object variants) runs one **program** per
logical key

    (entry point, code, survivor or missing set, batch, stripe width,
     num_chunks, stagger, device)

built once and memoized here. A program holds what a call needs that does
not depend on the data: the product tables on the device (copied from the
host once, not on every call), the frozen slot and row tables, and, for a
streamed run, the stripe buffers, the wires and one captured CUDA graph a
buffer slot (``repro_torch.core.streaming``). The shape element of a key is
the stripe width (``plan.sc_words``): a monolithic call's plan has
``sc_words == total_words``, and an object split into S stripes maps every
stripe onto one key, so S stripes build one program.

The cache is unbounded by design, as the JAX package's is: an archival
fleet runs a handful of code geometries and block lengths, so the key
population is small and every entry is a warm path worth keeping. Callers
with unbounded shape diversity bucket their shapes upstream or call
``clear()``, which also frees the programs' device buffers.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.core import trace

_programs: dict[Any, Callable] = {}
_stats = {"hits": 0, "misses": 0}


def get(key: Any, builder: Callable[[], Callable]) -> Callable:
    """Return the program for ``key``, building it on first use.

    ``key`` must be hashable and capture everything the built program holds
    that does not depend on the data (code, survivor set, stripe width,
    chunk count, stagger, device); ``builder`` is invoked only on a miss,
    in a ``repro_torch.build`` span.
    """
    try:
        fn = _programs[key]
    except KeyError:
        _stats["misses"] += 1
        with trace.span("repro_torch.build"):
            fn = _programs[key] = builder()
        return fn
    _stats["hits"] += 1
    return fn


def stats() -> dict[str, int]:
    """Cache hit/miss/size counters (process-wide)."""
    return {**_stats, "size": len(_programs)}


def compile_counts() -> dict[str, int]:
    """Per-program build counts: {repr(key): times built or captured}.

    A program counts one when it is made, and one more for each further
    signature it captured graphs for (``streaming.Program._cache_size``); a
    warm entry point called twice with identical shapes shows 1.
    """
    return {repr(key): fn._cache_size() for key, fn in _programs.items()}


def entry_counts(entry: str) -> dict[str, int]:
    """``compile_counts`` filtered to one entry point (``key[0] == entry``)."""
    return {repr(key): fn._cache_size() for key, fn in _programs.items()
            if isinstance(key, tuple) and key and key[0] == entry}


def clear() -> None:
    """Drop every cached program (and its device buffers) and reset the
    counters."""
    _programs.clear()
    _stats["hits"] = 0
    _stats["misses"] = 0
