"""Decoder-only LM stack for the dense and MoE families.

The JAX package's ``repro.models.transformer`` in plain PyTorch. Parameters
keep its stacked layout — every leaf of ``layers`` has a leading L axis — so
the tree has the reference's paths and shapes (and the port's checkpoint
manager saves it as the JAX package would). The layer loop is a Python loop
over slices of the stack.

Families:
  dense — [norm -> attn (GQA, MLA or M-RoPE GQA) -> +] [norm -> swiglu -> +]
  moe   — [norm -> attn -> +] [norm -> top-k MoE -> +]  (aux loss carried)

The ``ssm`` and ``hybrid`` families raise ``NotImplementedError``: their
mixers (``repro.models.ssm``) are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.hints import hint
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib

Params = dict[str, Any]
FAMILIES = ("dense", "moe")
UNPORTED = "the {family} family's layers (ROADMAP Queue 1: models/ssm.py and " \
           "models/encdec.py with their serving paths) are not ported yet"


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(UNPORTED.format(family=cfg.family))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg, dtype) -> Params:
    """Every layer's parameters, stacked along a leading L axis."""
    check_family(cfg)
    lead = (cfg.n_layers,)
    p: Params = {"norm1": L.rmsnorm_init(cfg.d_model, dtype, lead, gen.device),
                 "norm2": L.rmsnorm_init(cfg.d_model, dtype, lead, gen.device)}
    p["attn"] = (L.mla_init if cfg.mla else L.gqa_init)(gen, cfg, dtype, lead)
    if cfg.family == "moe":
        p["moe"] = moe_lib.moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, lead)
    return p


def layer_slice(stacked: Params, i) -> Params:
    """Layer ``i`` (an index or a slice) of a stacked tree, as views."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------


def window_flags(cfg) -> list[bool]:
    """Per-layer bool: True -> sliding-window attention."""
    if cfg.sliding_window is None:
        return [False] * cfg.n_layers
    return [i not in cfg.global_layers for i in range(cfg.n_layers)]


def _window(cfg, use_window: bool):
    return cfg.sliding_window if cfg.sliding_window is not None and use_window else None


def _ffn(p: Params, cfg, x: torch.Tensor):
    h = L.rmsnorm(p["norm2"], x)
    if cfg.family == "moe":
        return moe_lib.moe_forward(p["moe"], cfg, h)
    return L.mlp(p["mlp"], h), torch.zeros((), dtype=torch.float32, device=x.device)


def _attn(p: Params, cfg, h: torch.Tensor, use_window: bool, mrope_pos, return_kv: bool):
    if cfg.mla:
        return L.mla_attn(p["attn"], cfg, h, return_kv=return_kv)
    return L.gqa_attn(p["attn"], cfg, h, window=_window(cfg, use_window),
                      mrope_pos=mrope_pos, return_kv=return_kv)


def decoder_layer(p: Params, cfg, x: torch.Tensor, use_window: bool, mrope_pos):
    x = hint(x + _attn(p, cfg, L.rmsnorm(p["norm1"], x), use_window, mrope_pos, False), "act")
    f, aux = _ffn(p, cfg, x)
    return hint(x + f, "act"), aux


def run_stack(stacked: Params, cfg, x: torch.Tensor, mrope_pos=None):
    """Run the layer stack; returns (hidden, mean aux loss)."""
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, flag in enumerate(window_flags(cfg)):
        x, a = decoder_layer(layer_slice(stacked, i), cfg, x, flag, mrope_pos)
        aux = aux + a
    return x, aux / cfg.n_layers


def run_stack_prefill(stacked: Params, cfg, x: torch.Tensor, mrope_pos=None):
    """Forward pass that returns (hidden, per-layer stacked decode cache)."""
    check_family(cfg)
    caches = []
    for i, flag in enumerate(window_flags(cfg)):
        p = layer_slice(stacked, i)
        attn, kv = _attn(p, cfg, L.rmsnorm(p["norm1"], x), flag, mrope_pos, True)
        x = x + attn
        f, _ = _ffn(p, cfg, x)
        x = hint(x + f, "act")
        caches.append(kv)
    return x, {key: torch.stack([c[key] for c in caches]) for key in caches[0]}


# ---------------------------------------------------------------------------
# decode (single-token serve step with per-layer cache)
# ---------------------------------------------------------------------------


def _cache_shapes(cfg, batch: int, seq: int) -> dict[str, tuple]:
    if cfg.mla:
        return {"c": (batch, seq, cfg.mla_kv_lora), "k_rope": (batch, seq, cfg.mla_qk_rope_dim)}
    return {"k": (batch, seq, cfg.n_kv_heads, cfg.head_dim),
            "v": (batch, seq, cfg.n_kv_heads, cfg.head_dim)}


def stack_cache_init(cfg, batch: int, seq: int, dtype, device=None) -> Params:
    """Zero KV caches (GQA ``k`` / ``v``, MLA ``c`` / ``k_rope``) stacked
    over the layers."""
    check_family(cfg)
    return {key: torch.zeros((cfg.n_layers,) + shape, dtype=dtype, device=device)
            for key, shape in _cache_shapes(cfg, batch, seq).items()}


def run_stack_decode(stacked: Params, cfg, x: torch.Tensor, caches: Params, pos: int):
    """One token through the stack; each layer's cache is written at ``pos``
    in place. Returns (hidden, caches)."""
    check_family(cfg)
    pos = int(pos)
    for i, flag in enumerate(window_flags(cfg)):
        p = layer_slice(stacked, i)
        cache = layer_slice(caches, i)
        h = L.rmsnorm(p["norm1"], x)
        if cfg.mla:
            attn, _ = L.mla_decode(p["attn"], cfg, h, cache, pos)
        else:
            S = cache["k"].shape[1]
            window = None if cfg.sliding_window is None else (
                cfg.sliding_window if flag else S + 1)
            attn, _ = L.gqa_decode(p["attn"], cfg, h, cache, pos, window=window)
        x = x + attn
        f, _ = _ffn(p, cfg, x)
        x = hint(x + f, "act")
    return x, caches
