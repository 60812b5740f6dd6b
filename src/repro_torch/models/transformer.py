"""Decoder-only LM stack covering the dense, MoE, SSM and hybrid families.

The JAX package's ``repro.models.transformer`` in plain PyTorch. Parameters
keep its stacked layout — every leaf of ``layers`` has a leading L axis — so
the tree has the reference's paths and shapes (and the port's checkpoint
manager saves it as the JAX package would). The layer loop is a Python loop
over slices of the stack; the per-layer choice between sliding-window and
global attention (Hymba) is a Python bool, so a windowed layer's prefill
takes the banded path.

Families:
  dense  — [norm -> attn (GQA, MLA or M-RoPE GQA) -> +] [norm -> swiglu -> +]
  moe    — [norm -> attn -> +] [norm -> top-k MoE -> +]  (aux loss carried)
  hybrid — [norm -> (attn || mamba) mean -> +] [norm -> swiglu -> +]  (Hymba)
  ssm    — [norm -> rwkv6 time mix -> +] [norm -> rwkv6 channel mix -> +]
(The encoder-decoder family lives in ``repro_torch.models.encdec``.)
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.hints import hint
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

Params = dict[str, Any]
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg, dtype) -> Params:
    """Every layer's parameters, stacked along a leading L axis."""
    lead = (cfg.n_layers,)
    p: Params = {"norm1": L.rmsnorm_init(cfg.d_model, dtype, lead, gen.device),
                 "norm2": L.rmsnorm_init(cfg.d_model, dtype, lead, gen.device)}
    if cfg.family == "ssm":
        p["time"] = ssm_lib.rwkv_time_init(gen, cfg, dtype, lead)
        p["chan"] = ssm_lib.rwkv_channel_init(gen, cfg, dtype, lead)
        return p
    p["attn"] = (L.mla_init if cfg.mla else L.gqa_init)(gen, cfg, dtype, lead)
    if cfg.family == "hybrid":
        p["mamba"] = ssm_lib.mamba_init(gen, cfg, dtype, lead)
        p["attn_out_norm"] = L.rmsnorm_init(cfg.d_model, dtype, lead, gen.device)
        p["mamba_out_norm"] = L.rmsnorm_init(cfg.d_model, dtype, lead, gen.device)
    if cfg.family == "moe":
        p["moe"] = moe_lib.moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, lead)
    return p


def layer_slice(stacked: Params, i) -> Params:
    """Layer ``i`` (an index or a slice) of a stacked tree, as views."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _stack(trees: list) -> Params:
    """Stack same-shaped trees leaf by leaf along a new leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict) else
            torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def _write(dst: Params, src: Params) -> None:
    """Copy every leaf of ``src`` into ``dst``'s (view) leaves in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        else:
            dst[k].copy_(v)


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------


def window_flags(cfg) -> list[bool]:
    """Per-layer bool: True -> sliding-window attention (Hymba's SWA layers)."""
    if cfg.sliding_window is None:
        return [False] * cfg.n_layers
    return [i not in cfg.global_layers for i in range(cfg.n_layers)]


def _window(cfg, use_window: bool):
    return cfg.sliding_window if cfg.sliding_window is not None and use_window else None


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(p: Params, cfg, x: torch.Tensor):
    h = L.rmsnorm(p["norm2"], x)
    if cfg.family == "ssm":
        return ssm_lib.rwkv_channel_forward(p["chan"], h, ssm_lib._shift(h)), _zero(x)
    if cfg.family == "moe":
        return moe_lib.moe_forward(p["moe"], cfg, h)
    return L.mlp(p["mlp"], h), _zero(x)


def _attn(p: Params, cfg, h: torch.Tensor, use_window: bool, mrope_pos, return_kv: bool,
          proj=None):
    if cfg.mla:
        return L.mla_attn(p["attn"], cfg, h, return_kv=return_kv, proj=proj)
    return L.gqa_attn(p["attn"], cfg, h, window=_window(cfg, use_window),
                      mrope_pos=mrope_pos, return_kv=return_kv, proj=proj)


def _hybrid_mix(p: Params, attn: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Hymba: the mean of the normed attention and SSM branches."""
    return 0.5 * (L.rmsnorm(p["attn_out_norm"], attn) + L.rmsnorm(p["mamba_out_norm"], m))


def _mixer(p: Params, cfg, x: torch.Tensor, use_window: bool, mrope_pos):
    """Sequence-mixing sublayer (attention / hybrid / rwkv time mix)."""
    h = L.rmsnorm(p["norm1"], x)
    if cfg.family == "ssm":
        return ssm_lib.rwkv_time_forward(p["time"], cfg, h)
    attn = _attn(p, cfg, h, use_window, mrope_pos, False)
    if cfg.family == "hybrid":
        return _hybrid_mix(p, attn, ssm_lib.mamba_forward(p["mamba"], cfg, h))
    return attn


def decoder_layer(p: Params, cfg, x: torch.Tensor, use_window: bool, mrope_pos):
    x = hint(x + _mixer(p, cfg, x, use_window, mrope_pos), "act")
    f, aux = _ffn(p, cfg, x)
    return hint(x + f, "act"), aux


def run_stack(stacked: Params, cfg, x: torch.Tensor, mrope_pos=None):
    """Run the layer stack; returns (hidden, mean aux loss). With
    ``cfg.remat`` and autograd on, each layer keeps only its input and is
    recomputed in the backward pass."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = _zero(x)
    for i, flag in enumerate(window_flags(cfg)):
        p = layer_slice(stacked, i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(decoder_layer, p, cfg, x, flag, mrope_pos,
                                                     use_reentrant=False)
        else:
            x, a = decoder_layer(p, cfg, x, flag, mrope_pos)
        aux = aux + a
    return x, aux / cfg.n_layers


def decoder_layer_prefill(p: Params, cfg, x: torch.Tensor, use_window: bool, mrope_pos):
    """One layer's forward that also returns its decode cache."""
    h = L.rmsnorm(p["norm1"], x)
    if cfg.family == "ssm":
        t, tc = ssm_lib.rwkv_time_forward(p["time"], cfg, h, return_state=True)
        x = x + t
        h2 = L.rmsnorm(p["norm2"], x)
        c = ssm_lib.rwkv_channel_forward(p["chan"], h2, ssm_lib._shift(h2))
        return x + c, {"time": tc, "chan_x_prev": h2[:, -1:]}
    mix, cache = _attn(p, cfg, h, use_window, mrope_pos, True)
    if cfg.family == "hybrid":
        m, cache["mamba"] = ssm_lib.mamba_forward(p["mamba"], cfg, h, return_state=True)
        mix = _hybrid_mix(p, mix, m)
    x = x + mix
    f, _ = _ffn(p, cfg, x)
    return x + f, cache


def run_stack_prefill(stacked: Params, cfg, x: torch.Tensor, mrope_pos=None):
    """Forward pass that returns (hidden, per-layer stacked decode cache)."""
    caches = []
    for i, flag in enumerate(window_flags(cfg)):
        x, cache = decoder_layer_prefill(layer_slice(stacked, i), cfg, x, flag, mrope_pos)
        x = hint(x, "act")
        caches.append(cache)
    return x, _stack(caches)


# ---------------------------------------------------------------------------
# decode (single-token serve step with per-layer cache)
# ---------------------------------------------------------------------------


def stack_cache_init(cfg, batch: int, seq: int, dtype, device=None) -> Params:
    """Zero decode caches stacked over the layers: GQA ``k`` / ``v`` or MLA
    ``c`` / ``k_rope`` in ``dtype``, plus Hymba's ``mamba`` state; RWKV's
    ``time`` state and token shifts. Recurrent ``state`` leaves are float32."""
    lead = (cfg.n_layers,)
    if cfg.family == "ssm":
        return ssm_lib.rwkv_cache_init(cfg, batch, dtype, lead, device)
    if cfg.mla:
        shapes = {"c": (batch, seq, cfg.mla_kv_lora), "k_rope": (batch, seq, cfg.mla_qk_rope_dim)}
    else:
        shapes = {"k": (batch, seq, cfg.n_kv_heads, cfg.head_dim),
                  "v": (batch, seq, cfg.n_kv_heads, cfg.head_dim)}
    cache: Params = {key: torch.zeros(lead + shape, dtype=dtype, device=device)
                     for key, shape in shapes.items()}
    if cfg.family == "hybrid":
        cache["mamba"] = ssm_lib.mamba_cache_init(cfg, batch, dtype, lead, device)
    return cache


def decoder_layer_decode(p: Params, cfg, x: torch.Tensor, cache: Params, pos: int,
                         use_window: bool):
    """One token through one layer. ``cache`` is the layer's view of the
    stacked cache: KV is written at ``pos``, recurrent states are copied
    over in place."""
    h = L.rmsnorm(p["norm1"], x)
    if cfg.family == "ssm":
        t, tc = ssm_lib.rwkv_time_decode(p["time"], cfg, h, cache["time"])
        _write(cache["time"], tc)
        x = x + t
        h2 = L.rmsnorm(p["norm2"], x)
        c = ssm_lib.rwkv_channel_forward(p["chan"], h2, cache["chan_x_prev"])
        cache["chan_x_prev"].copy_(h2)
        return x + c
    if cfg.mla:
        mix, _ = L.mla_decode(p["attn"], cfg, h, cache, pos)
    else:
        S = cache["k"].shape[1]
        window = None if cfg.sliding_window is None else (
            cfg.sliding_window if use_window else S + 1)
        mix, _ = L.gqa_decode(p["attn"], cfg, h, cache, pos, window=window)
    if cfg.family == "hybrid":
        m, mc = ssm_lib.mamba_decode(p["mamba"], cfg, h, cache["mamba"])
        _write(cache["mamba"], mc)
        mix = _hybrid_mix(p, mix, m)
    x = x + mix
    f, _ = _ffn(p, cfg, x)
    return x + f


def run_stack_decode(stacked: Params, cfg, x: torch.Tensor, caches: Params, pos: int):
    """One token through the stack; each layer's cache is updated in place.
    Returns (hidden, caches)."""
    pos = int(pos)
    for i, flag in enumerate(window_flags(cfg)):
        x = hint(decoder_layer_decode(layer_slice(stacked, i), cfg, x,
                                      layer_slice(caches, i), pos, flag), "act")
    return x, caches
