"""Pluggable erasure-code families on one shared pipelined data plane.

Public surface::

    from repro_torch.core import codes
    code = codes.make("lrc", 16, 11, l=16, seed=0)   # by family name
    code = codes.from_spec(codes.CodeSpec.from_manifest(manifest))
    codes.families()                                  # registered names

Families register lazily (constructor paths, resolved at first ``make``)
so this package imports without dragging in every family module and stays
cycle-free with ``repro_torch.core.rapidraid``.
"""
from repro_torch.core.codes.base import (CodeSpec, ErasureCode, independent_rows,
                                         matrix_repair_plan)
from repro_torch.core.codes.registry import families, from_spec, make, register

register("rapidraid", "repro_torch.core.rapidraid:_make_canonical")
register("lrc", "repro_torch.core.codes.lrc:make")
register("mbr", "repro_torch.core.codes.regenerating:make")

__all__ = ["CodeSpec", "ErasureCode", "independent_rows",
           "matrix_repair_plan", "families", "from_spec", "make", "register"]
