"""Erasure-code API of the port: ``CodeSpec`` identity and the ``ErasureCode``
surface the chain data plane uses. The family registry is not ported yet."""
from repro_torch.core.codes.base import CodeSpec, ErasureCode, independent_rows

__all__ = ["CodeSpec", "ErasureCode", "independent_rows"]
