"""Architecture config registry: ``get_config("qwen3-4b")`` etc.

One module per assigned architecture (exact published dims) + a reduced
``smoke`` variant of the same family for CPU tests: the JAX package's
``repro.configs``, field for field. ``repro_torch.configs.shapes`` holds the
assigned input shapes and their meta-device input specs.
"""
from __future__ import annotations

from repro_torch.configs import (grok_1_314b, hymba_1_5b, minicpm3_4b,
                           mistral_nemo_12b, phi35_moe_42b, qwen2_vl_72b,
                           qwen3_1_7b, qwen3_4b, rwkv6_3b, whisper_base)
from repro_torch.models.model import ModelConfig

_MODULES = (hymba_1_5b, minicpm3_4b, qwen3_1_7b, qwen3_4b, mistral_nemo_12b,
            rwkv6_3b, phi35_moe_42b, grok_1_314b, qwen2_vl_72b, whisper_base)

ARCHS: tuple[str, ...] = tuple(m.ID for m in _MODULES)
_BY_ID = {m.ID: m for m in _MODULES}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _BY_ID:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCHS)}")
    mod = _BY_ID[arch]
    return mod.smoke_config() if smoke else mod.config()
