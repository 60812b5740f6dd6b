"""Assigned input shapes and meta-device input specs (no allocation).

The JAX package's ``repro.configs.shapes`` on the port. Four shapes per
architecture (LM family):
  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill (logits + KV cache)
  decode_32k   seq 32768,  global_batch 128   -> serve_step (1 token, full KV)
  long_500k    seq 524288, global_batch 1     -> serve_step; sub-quadratic
                                                  archs only (ssm / hybrid)

The stand-ins for ``jax.ShapeDtypeStruct`` are tensors on the ``meta``
device: the shapes and dtypes of the inputs, with no storage.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as model_lib


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: model_lib.ModelConfig, shape_name: str) -> bool:
    """Per the assignment: long_500k only for sub-quadratic archs."""
    if shape_name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def shape_cells(cfg: model_lib.ModelConfig) -> list[str]:
    return [s for s in SHAPES if applicable(cfg, s)]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: model_lib.ModelConfig, shape_name: str) -> dict:
    """Meta-device stand-ins for every model input of this cell.

    train  -> {"batch": {tokens, labels, [mrope_pos], [enc_frames]}}
    prefill-> {"tokens", [mrope_pos], [enc_frames]}
    decode -> {"token", "pos", "cache"}  (the cache from ``init_cache`` on
              the meta device)
    """
    sh = SHAPES[shape_name]
    B, S = sh.batch, sh.seq
    if sh.kind == "train":
        batch = {"tokens": _sds((B, S), torch.int32),
                 "labels": _sds((B, S), torch.int32)}
        if cfg.mrope_sections is not None:
            batch["mrope_pos"] = _sds((3, B, S), torch.int32)
        if cfg.family == "encdec":
            batch["enc_frames"] = _sds((B, cfg.enc_ctx, cfg.d_model), torch.bfloat16)
        return {"batch": batch}
    if sh.kind == "prefill":
        specs = {"tokens": _sds((B, S), torch.int32)}
        if cfg.mrope_sections is not None:
            specs["mrope_pos"] = _sds((3, B, S), torch.int32)
        if cfg.family == "encdec":
            specs["enc_frames"] = _sds((B, cfg.enc_ctx, cfg.d_model), torch.bfloat16)
        return specs
    # decode: one new token against a seq-long cache
    return {"token": _sds((B, 1), torch.int32),
            "pos": _sds((), torch.int32),
            "cache": model_lib.init_cache(cfg, B, S, device="meta")}
