"""Roofline terms from a step's counts, with NVIDIA H100 SXM constants.

  compute term    = FLOPs_per_chip / peak_FLOPs
  memory term     = HBM_bytes_per_chip / HBM_bw
  collective term = collective_link_bytes_per_chip / link_bw

The JAX package's ``repro.launch.roofline`` with its TPU v5e constants
replaced by the H100 SXM's. The collective bytes come from
``repro_torch.launch.hlo.collective_bytes`` over the sharded step's ledger.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column:
PEAK_FLOPS = 989.4e12      # BF16 Tensor Core FLOP/s, dense (1,979 TFLOPS with sparsity)
HBM_BW = 3.35e12           # bytes/s, HBM3 ("GPU memory bandwidth 3.35TB/s")
ICI_BW = 450e9             # bytes/s, NVLink 4 in one direction (900GB/s both ways)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float           # per-chip flops
    hbm_bytes: float       # per-chip bytes accessed
    coll_bytes: float      # per-chip collective link bytes
    model_flops: float     # useful (6ND-style) flops per chip

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / FLOPs (catches remat/redundancy waste)."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (step_time * peak): the roofline fraction we report."""
        t = self.step_time_s
        return self.model_flops / (t * PEAK_FLOPS) if t else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops, "bound": self.bound,
            "step_time_s": self.step_time_s,
            "useful_ratio": self.useful_ratio, "mfu": self.mfu,
        }


def model_flops_per_chip(kind: str, n_active_params: int, tokens_global: int,
                         n_chips: int) -> float:
    """6*N*D for training, 2*N*D for inference (per chip)."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_active_params * tokens_global / n_chips


def make_roofline(flops: float, hbm_bytes: float, coll_bytes: float,
                  model_flops: float) -> Roofline:
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm_bytes / HBM_BW,
        collective_s=coll_bytes / ICI_BW,
        flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes,
        model_flops=model_flops)
