"""Collective-traffic accounting from the sharded step's ledger.

The JAX package reads its collectives out of the optimized, SPMD-partitioned
HLO text (``repro.launch.hlo``): every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute instruction, its output
shape and dtype, and its replica group size. The port has no compiler and so
no HLO: GSPMD's collectives are explicit calls in
``repro_torch.train.spmd``, and each call records those same four fields
(``spmd.Collective``: op, dtype, each device's output shape, group size) in
the step's ``Ledger``. This module reads the records instead of the text,
with the JAX package's byte sizes and ring factors, so a step's collective
bytes are counted as the JAX package counts an HLO program's. Bytes are
*per-device link bytes*:

  all-reduce       2 (g-1)/g * |out|      (reduce-scatter + all-gather)
  all-gather         (g-1)/g * |out|
  reduce-scatter     (g-1)   * |out|      (operand = g * |out|)
  all-to-all         (g-1)/g * |out|
  collective-permute          |out|
"""
from __future__ import annotations

import dataclasses
import math

import torch

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# torch dtypes by their HLO element-type names
_HLO_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.uint16: "u16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.uint32: "u32", torch.float32: "f32", torch.int64: "s64",
    torch.uint64: "u64", torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128",
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    per_op: dict[str, float]          # op kind -> per-device link bytes
    count: dict[str, int]
    total_bytes: float

    def summary(self) -> dict:
        return {"per_op_bytes": self.per_op, "per_op_count": self.count,
                "total_bytes": self.total_bytes}


def hlo_dtype(dtype) -> str:
    """The HLO element-type name of a torch dtype (a name passes through)."""
    return dtype if isinstance(dtype, str) else _HLO_NAMES[dtype]


def _shape_bytes(dtype, shape) -> float:
    return math.prod(int(d) for d in shape) * _DTYPE_BYTES.get(hlo_dtype(dtype), 4)


def collective_bytes(records) -> CollectiveStats:
    """Per-device link bytes by op over ``records``: ``(op, dtype, per-device
    output shape, group size)`` tuples such as ``spmd.Collective``."""
    per_op: dict[str, float] = {}
    count: dict[str, int] = {}
    for op, dtype, shape, g in records:
        if op not in _COLLECTIVES:
            raise ValueError(f"unknown collective {op!r}")
        out_bytes = _shape_bytes(dtype, shape)
        if op == "collective-permute":
            link = out_bytes
        elif op == "all-reduce":
            link = 2 * (g - 1) / max(g, 1) * out_bytes
        elif op == "all-gather":
            link = (g - 1) / max(g, 1) * out_bytes
        elif op == "reduce-scatter":
            link = (g - 1) * out_bytes
        else:   # all-to-all
            link = (g - 1) / max(g, 1) * out_bytes
        per_op[op] = per_op.get(op, 0.0) + link
        count[op] = count.get(op, 0) + 1
    return CollectiveStats(per_op=per_op, count=count,
                           total_bytes=sum(per_op.values()))
