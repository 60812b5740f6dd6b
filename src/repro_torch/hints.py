"""Activation-placement hint registry (import-cycle-free leaf module).

Model code stays placement-agnostic: layers call ``hint(x, "act")`` at
residual boundaries. With no hints installed — every run on one card —
``hint`` is the identity. The API is the JAX package's (``repro.hints``),
so a later multi-card slice can install a placement per site: an installed
hint is a callable applied to the tensor.

``scan_unroll`` / ``unrolled_scans`` keep the JAX package's cost-accounting
flag. The port's layer loops are Python loops, so nothing reads it yet.
"""
from __future__ import annotations

import contextlib

_HINTS: dict[str, object] = {}


def hint(x, site: str):
    place = _HINTS.get(site)
    return x if place is None else place(x)


def set_hints(hints: dict[str, object]) -> None:
    _HINTS.clear()
    _HINTS.update(hints)


def clear_hints() -> None:
    _HINTS.clear()


@contextlib.contextmanager
def hints_installed(hints: dict[str, object]):
    old = dict(_HINTS)
    set_hints(hints)
    try:
        yield
    finally:
        set_hints(old)


_UNROLL_SCANS = False


def scan_unroll() -> bool:
    return _UNROLL_SCANS


@contextlib.contextmanager
def unrolled_scans():
    global _UNROLL_SCANS
    old = _UNROLL_SCANS
    _UNROLL_SCANS = True
    try:
        yield
    finally:
        _UNROLL_SCANS = old
