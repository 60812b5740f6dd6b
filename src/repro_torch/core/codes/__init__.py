"""Erasure-code API of the port: ``CodeSpec`` identity and the ``ErasureCode``
surface the storage data plane uses. The family registry is not ported yet."""
from repro_torch.core.codes.base import (CodeSpec, ErasureCode, independent_rows,
                                         matrix_repair_plan)

__all__ = ["CodeSpec", "ErasureCode", "independent_rows", "matrix_repair_plan"]
