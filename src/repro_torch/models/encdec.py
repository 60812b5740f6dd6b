"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The JAX package's ``repro.models.encdec`` in plain PyTorch. The encoder
takes precomputed frame embeddings (B, enc_ctx, d_model) in place of the
mel + conv frontend, adds fixed sinusoidal positions and runs bidirectional
attention; the decoder uses RoPE (not Whisper's learned positions, so no
parameter shape depends on the request length) with causal self-attention
and cross-attention into the encoder states. Layers are stacked on a
leading axis, as in the reference's tree (``enc_layers``, ``enc_norm``,
``dec_layers``), and run as Python loops over slices of the stack.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.hints import hint
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_slice as _layer

Params = dict[str, Any]
F32 = torch.float32


def sinusoid_pos(n_ctx: int, d: int) -> np.ndarray:
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1))
    ang = np.arange(n_ctx)[:, None] * freqs[None]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def cross_attn_init(gen, cfg, dtype, lead: tuple[int, ...] = ()) -> Params:
    d, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": L.dense_init(gen, d, H * Dh, dtype, lead),
        "wk": L.dense_init(gen, d, H * Dh, dtype, lead),
        "wv": L.dense_init(gen, d, H * Dh, dtype, lead),
        "wo": L.dense_init(gen, H * Dh, d, dtype, lead),
    }


def cross_kv(p: Params, cfg, enc_out: torch.Tensor):
    B, T, _ = enc_out.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(B, T, H, Dh)
    v = (enc_out @ p["wv"]).reshape(B, T, H, Dh)
    return k, v


def cross_attn(p: Params, cfg, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, proj=None):
    """x (B,S,D) queries against fixed encoder K/V (B,T,H,Dh): a float32
    softmax over all T frames."""
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    s = torch.einsum("bshd,bthd->bhst", q.to(F32), k.to(F32)) / np.sqrt(Dh)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", pr, v.to(F32))
    return L.out_proj(o.reshape(B, S, H * Dh).to(x.dtype), p["wo"], proj)


def encdec_init(gen, cfg, dtype) -> Params:
    d, dev = cfg.d_model, gen.device
    enc, dec = (cfg.enc_layers,), (cfg.n_layers,)
    return {
        "enc_layers": {"norm1": L.rmsnorm_init(d, dtype, enc, dev),
                       "attn": L.gqa_init(gen, cfg, dtype, enc),
                       "norm2": L.rmsnorm_init(d, dtype, enc, dev),
                       "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype, enc)},
        "enc_norm": L.rmsnorm_init(d, dtype, device=dev),
        "dec_layers": {"norm1": L.rmsnorm_init(d, dtype, dec, dev),
                       "attn": L.gqa_init(gen, cfg, dtype, dec),
                       "norm_x": L.rmsnorm_init(d, dtype, dec, dev),
                       "xattn": cross_attn_init(gen, cfg, dtype, dec),
                       "norm2": L.rmsnorm_init(d, dtype, dec, dev),
                       "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype, dec)},
    }


def enc_attn(p: Params, cfg, h: torch.Tensor, proj=None) -> torch.Tensor:
    """The encoder's bidirectional self-attention of normed h (B,T,D)."""
    B, T, _ = h.shape
    H, Kh, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(B, T, H, Dh)
    k = (h @ p["wk"]).reshape(B, T, Kh, Dh)
    v = (h @ p["wv"]).reshape(B, T, Kh, Dh)
    o = L.chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return L.out_proj(o.reshape(B, T, H * Dh), p["wo"], proj)


def _enc_layer(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = x + enc_attn(p["attn"], cfg, L.rmsnorm(p["norm1"], x))
    return x + L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x))


def encode_audio(p: Params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, enc_ctx, D) precomputed embeddings (frontend stub)."""
    pos = torch.from_numpy(sinusoid_pos(frames.shape[1], cfg.d_model))
    x = frames + pos.to(device=frames.device, dtype=frames.dtype)[None]
    for i in range(cfg.enc_layers):
        x = hint(_enc_layer(_layer(p["enc_layers"], i), cfg, x), "act")
    return L.rmsnorm(p["enc_norm"], x)


def _dec_layer(p: Params, cfg, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor):
    x = x + L.gqa_attn(p["attn"], cfg, L.rmsnorm(p["norm1"], x), window=None)
    x = x + cross_attn(p["xattn"], cfg, L.rmsnorm(p["norm_x"], x), xk, xv)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x))


def run_decoder(p: Params, cfg, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder stack over the encoder states; ``cfg.remat`` recomputes
    each layer in the backward pass (only its input is kept)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer(p["dec_layers"], i)
        xk, xv = cross_kv(lp["xattn"], cfg, enc_out)
        if remat:
            x = torch.utils.checkpoint.checkpoint(_dec_layer, lp, cfg, x, xk, xv,
                                                  use_reentrant=False)
        else:
            x = _dec_layer(lp, cfg, x, xk, xv)
        x = hint(x, "act")
    return x


# ---------------------------------------------------------------------------
# decode step: self-attention KV cache + precomputed cross K/V
# ---------------------------------------------------------------------------


def dec_cache_init(cfg, batch: int, seq: int, dtype, device=None) -> Params:
    H, Kh, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = (cfg.n_layers, batch)
    return {"k": torch.zeros(lead + (seq, Kh, Dh), dtype=dtype, device=device),
            "v": torch.zeros(lead + (seq, Kh, Dh), dtype=dtype, device=device),
            "xk": torch.zeros(lead + (cfg.enc_ctx, H, Dh), dtype=dtype, device=device),
            "xv": torch.zeros(lead + (cfg.enc_ctx, H, Dh), dtype=dtype, device=device)}


def fill_cross_cache(p: Params, cfg, enc_out: torch.Tensor, cache: Params) -> Params:
    """Each layer's cross K/V from the encoder states, once per request."""
    kvs = [cross_kv(_layer(p["dec_layers"], i)["xattn"], cfg, enc_out)
           for i in range(cfg.n_layers)]
    return {**cache, "xk": torch.stack([k for k, _ in kvs]).to(cache["xk"].dtype),
            "xv": torch.stack([v for _, v in kvs]).to(cache["xv"].dtype)}


def _dec_layer_decode(p: Params, cfg, x, cache, pos: int):
    """One token through one decoder layer; the self-attention cache is
    written at ``pos`` in place."""
    attn, _ = L.gqa_decode(p["attn"], cfg, L.rmsnorm(p["norm1"], x), cache, pos, window=None)
    x = x + attn
    x = x + cross_attn(p["xattn"], cfg, L.rmsnorm(p["norm_x"], x), cache["xk"], cache["xv"])
    return x + L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x))


def run_decoder_prefill(p: Params, cfg, x: torch.Tensor, enc_out: torch.Tensor):
    """Decoder forward that also returns the stacked decode cache."""
    caches = []
    for i in range(cfg.n_layers):
        lp = _layer(p["dec_layers"], i)
        attn, kv = L.gqa_attn(lp["attn"], cfg, L.rmsnorm(lp["norm1"], x), window=None,
                              return_kv=True)
        x = x + attn
        xk, xv = cross_kv(lp["xattn"], cfg, enc_out)
        x = x + cross_attn(lp["xattn"], cfg, L.rmsnorm(lp["norm_x"], x), xk, xv)
        x = x + L.mlp(lp["mlp"], L.rmsnorm(lp["norm2"], x))
        caches.append({"k": kv["k"], "v": kv["v"], "xk": xk, "xv": xv})
    return x, {key: torch.stack([c[key] for c in caches]) for key in caches[0]}


def run_decoder_decode(p: Params, cfg, x: torch.Tensor, caches: Params, pos: int):
    """One token through the decoder; each layer's cache is written at
    ``pos`` in place. Returns (hidden, caches)."""
    pos = int(pos)
    for i in range(cfg.n_layers):
        x = _dec_layer_decode(_layer(p["dec_layers"], i), cfg, x, _layer(caches, i), pos)
    return x, caches
