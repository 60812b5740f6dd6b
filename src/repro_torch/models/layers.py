"""Shared transformer layers: norms, RoPE/M-RoPE, GQA/MLA attention, SwiGLU.

The JAX package's ``repro.models.layers`` in plain PyTorch. Layers are
functions over parameter trees (nested dicts of tensors) in the JAX
package's layout, so a tree carried across by
``repro_torch.models.model.params_from_jax`` runs here unchanged.

Attention is the JAX package's double-chunked online softmax (flash-style)
written out in torch, not a library call: an outer loop over ``q_chunk``
query blocks, an inner loop over ``kv_chunk`` key blocks with a running
(max, denominator, output) merge, the same masks in the same order. Live
memory is one (q_chunk x kv_chunk) tile per head, so long prompts stay
O(chunk^2). Under a causal mask a key block past the query block's last row
is skipped: its scores are all masked, so merging it changes nothing (its
weight ``exp(-1e30 - m)`` is 0 and the running sums are scaled by 1).
Products are ``torch.matmul`` / ``torch.einsum``, which the JAX package
computes outside any Pallas kernel too.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]
F32 = torch.float32

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _randn(gen, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 normals drawn by ``gen`` on its device (on the meta device,
    where ``gen`` only names the device, shapes alone)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=F32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device, dtype=F32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               lead: tuple[int, ...] = ()) -> torch.Tensor:
    """(lead..., d_in, d_out) normal weights scaled by 1/sqrt(d_in)."""
    return (_randn(gen, lead + (d_in, d_out)) * (1.0 / np.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (_randn(gen, (vocab, d)) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, lead: tuple[int, ...] = (), device=None) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(F32)).to(x.dtype)


def qk_headnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the head dim of (B, S, H, Dh) q/k tensors (Qwen3 style)."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) with rotary positions pos (B, S) -> same shape."""
    freqs = torch.from_numpy(rope_freqs(x.shape[-1], theta)).to(x.device)   # (Dh/2,)
    return _rotate(x, pos[..., None].to(F32) * freqs)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the Dh/2 frequency slots are partitioned
    into (t, h, w) sections, each rotated by its own position id.

    x (B, S, H, Dh); pos3 (3, B, S) int positions. sections sum to Dh/2.
    """
    dh = x.shape[-1]
    assert sum(sections) == dh // 2, (sections, dh)
    freqs = torch.from_numpy(rope_freqs(dh, theta)).to(x.device)
    sec_id = torch.from_numpy(np.repeat(np.arange(3), sections)).to(x.device)
    pos_per_slot = pos3.index_select(0, sec_id)                 # (Dh/2, B, S)
    return _rotate(x, pos_per_slot.permute(1, 2, 0).to(F32) * freqs)


# ---------------------------------------------------------------------------
# chunked online-softmax attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _block_attn(q, k, v, mask):
    """One (q_chunk x kv_chunk) tile: returns (row_max, denom, out_part).

    q (B, qc, H, Dh); k/v (B, kc, Kh, Dh); mask (qc, kc) additive.
    GQA: H = Kh * rep; q is grouped to (B, qc, Kh, rep, Dh).
    """
    B, qc, H, Dh = q.shape
    Kh = k.shape[2]
    qg = q.reshape(B, qc, Kh, H // Kh, Dh)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.to(F32), k.to(F32)) / np.sqrt(Dh)
    s = s + mask[None, None, None]
    m = torch.amax(s, dim=-1)                       # (B, Kh, rep, qc)
    p = torch.exp(s - m[..., None])
    denom = torch.sum(p, dim=-1)
    o = torch.einsum("bkrqs,bskd->bkrqd", p, v.to(F32))
    return m, denom, o


def _pad_seq(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, 0, before, after)) if before or after else x


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window=None,
                      q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention. q (B,S,H,Dh), k/v (B,S,Kh,Dh) -> (B,S,H,Dv).

    Outer loop over q chunks, inner loop over kv chunks with running
    (max, denom, out) merge. ``window``: sliding-window attention (attend to
    keys in (i-window, i]), a static int.
    """
    B, S, H, _ = q.shape
    Kh = k.shape[2]
    Dv = v.shape[-1]       # value head dim may differ from qk dim (MLA)
    rep = H // Kh
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    if causal and isinstance(window, int) and window + qc < S:
        # banded fast path: each q chunk only needs keys in
        # [qi*qc - window, qi*qc + qc) — O(S * (window + qc)) work
        return _banded_attention(q, k, v, window=window, q_chunk=qc)
    Sq = -(-S // qc) * qc
    Sk = -(-S // kc) * kc
    q = _pad_seq(q, 0, Sq - S)
    k, v = _pad_seq(k, 0, Sk - S), _pad_seq(v, 0, Sk - S)
    dev = q.device
    q_pos = torch.arange(qc, device=dev)
    k_pos = torch.arange(kc, device=dev)
    outs = []
    for qi in range(Sq // qc):
        qblk = q[:, qi * qc:(qi + 1) * qc]
        m_run = torch.full((B, Kh, rep, qc), NEG_INF, dtype=F32, device=dev)
        d_run = torch.zeros((B, Kh, rep, qc), dtype=F32, device=dev)
        o_run = torch.zeros((B, Kh, rep, qc, Dv), dtype=F32, device=dev)
        for ki in range(Sk // kc):
            if causal and ki * kc > qi * qc + qc - 1:
                break                      # every score of this block is masked
            rows = qi * qc + q_pos[:, None]
            cols = ki * kc + k_pos[None, :]
            ok = cols < S                  # mask chunk padding
            if causal:
                ok = ok & (cols <= rows)
            if window is not None:
                ok = ok & (cols > rows - window)
            mask = torch.where(ok, 0.0, NEG_INF).to(F32)
            m_new, d_new, o_new = _block_attn(qblk, k[:, ki * kc:(ki + 1) * kc],
                                              v[:, ki * kc:(ki + 1) * kc], mask)
            m = torch.maximum(m_run, m_new)
            a = torch.exp(m_run - m)
            b = torch.exp(m_new - m)
            d_run = d_run * a + d_new * b
            o_run = o_run * a[..., None] + o_new * b[..., None]
            m_run = m
        out = o_run / torch.clamp(d_run[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, Dv).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :S]


def _banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int, q_chunk: int) -> torch.Tensor:
    """Sliding-window attention computing only the diagonal band."""
    B, S, H, _ = q.shape
    Dv = v.shape[-1]
    qc = q_chunk
    Sq = -(-S // qc) * qc
    q = _pad_seq(q, 0, Sq - S)
    # left-pad keys by `window` (band start never negative) and right-pad to
    # the q-chunk multiple
    kp, vp = _pad_seq(k, window, Sq - S), _pad_seq(v, window, Sq - S)
    W = window + qc
    dev = q.device
    q_pos = torch.arange(qc, device=dev)
    band = torch.arange(W, device=dev)
    outs = []
    for qi in range(Sq // qc):
        rows = qi * qc + q_pos[:, None]
        cols = qi * qc - window + band[None, :]
        ok = (cols >= 0) & (cols < S) & (cols <= rows) & (cols > rows - window)
        mask = torch.where(ok, 0.0, NEG_INF).to(F32)
        m, d, o = _block_attn(q[:, qi * qc:(qi + 1) * qc], kp[:, qi * qc:qi * qc + W],
                              vp[:, qi * qc:qi * qc + W], mask)
        out = o / torch.clamp(d[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, Dv).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :S]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: int, *, window=None) -> torch.Tensor:
    """Single-step decode. q (B,1,H,Dh); caches (B,S,Kh,Dh); cur_len =
    #valid cache entries including the current token."""
    B, _, H, Dh = q.shape
    S, Kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Kh, H // Kh, Dh)
    s = torch.einsum("bkrd,bskd->bkrs", qg.to(F32), k_cache.to(F32)) / np.sqrt(Dh)
    idx = torch.arange(S, device=q.device)
    ok = idx < cur_len
    if window is not None:
        ok &= idx > cur_len - 1 - window
    s = torch.where(ok[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(F32))
    return o.reshape(B, 1, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (Qwen/Mistral/Phi/Grok/Qwen2-VL style)
# ---------------------------------------------------------------------------


def gqa_init(gen, cfg, dtype, lead: tuple[int, ...] = ()) -> Params:
    d, H, Kh, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, H * Dh, dtype, lead),
        "wk": dense_init(gen, d, Kh * Dh, dtype, lead),
        "wv": dense_init(gen, d, Kh * Dh, dtype, lead),
        "wo": dense_init(gen, H * Dh, d, dtype, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (Dh,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones(lead + (Dh,), dtype=dtype, device=gen.device)
    return p


def gqa_qkv(p: Params, cfg, x: torch.Tensor, pos, mrope_pos=None):
    """Project + norm + rope. Returns q (B,S,H,Dh), k/v (B,S,Kh,Dh)."""
    B, S, _ = x.shape
    H, Kh, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, Kh, Dh)
    v = (x @ p["wv"]).reshape(B, S, Kh, Dh)
    if cfg.qk_norm:
        q = qk_headnorm(p["q_norm"], q)
        k = qk_headnorm(p["k_norm"], k)
    if cfg.mrope_sections is not None and mrope_pos is not None:
        q = apply_mrope(q, mrope_pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, mrope_pos, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def gqa_attn(p: Params, cfg, x: torch.Tensor, *, window,
             mrope_pos=None, return_kv: bool = False):
    B, S, _ = x.shape
    q, k, v = gqa_qkv(p, cfg, x, _positions(B, S, x.device), mrope_pos)
    o = chunked_attention(q, k, v, causal=True, window=window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if return_kv:
        return out, {"k": k, "v": v}
    return out


def gqa_decode(p: Params, cfg, x: torch.Tensor, cache: Params, pos: int,
               *, window, mrope_pos=None):
    """x (B,1,D); cache {"k","v"} (B,S,Kh,Dh), written at ``pos`` in place."""
    B = x.shape[0]
    pos_b = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = gqa_qkv(p, cfg, x, pos_b, mrope_pos)
    cache["k"][:, pos:pos + 1] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v.to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], pos + 1, window=window)
    out = o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out, {"k": cache["k"], "v": cache["v"]}


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg, dtype, lead: tuple[int, ...] = ()) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    qh = cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim
    return {
        "wdq": dense_init(gen, d, cfg.mla_q_lora, dtype, lead),
        "q_norm": rmsnorm_init(cfg.mla_q_lora, dtype, lead, gen.device),
        "wuq": dense_init(gen, cfg.mla_q_lora, H * qh, dtype, lead),
        "wdkv": dense_init(gen, d, cfg.mla_kv_lora, dtype, lead),
        "kv_norm": rmsnorm_init(cfg.mla_kv_lora, dtype, lead, gen.device),
        "wuk": dense_init(gen, cfg.mla_kv_lora, H * cfg.mla_qk_nope_dim, dtype, lead),
        "wuv": dense_init(gen, cfg.mla_kv_lora, H * cfg.mla_v_dim, dtype, lead),
        "wkr": dense_init(gen, d, cfg.mla_qk_rope_dim, dtype, lead),
        "wo": dense_init(gen, H * cfg.mla_v_dim, d, dtype, lead),
    }


def _mla_q(p, cfg, x, pos):
    B, S, _ = x.shape
    nd, rd = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim
    q = rmsnorm(p["q_norm"], x @ p["wdq"]) @ p["wuq"]
    q = q.reshape(B, S, cfg.n_heads, nd + rd)
    return q[..., :nd], apply_rope(q[..., nd:], pos, cfg.rope_theta)


def _mla_latents(p, cfg, x, pos):
    c = rmsnorm(p["kv_norm"], x @ p["wdkv"])                   # (B,S,kv_lora)
    k_rope = apply_rope((x @ p["wkr"])[:, :, None, :], pos, cfg.rope_theta)
    return c, k_rope[:, :, 0, :]                               # (B,S,rd)


def mla_attn(p: Params, cfg, x: torch.Tensor, return_kv: bool = False):
    """Prefill MLA: latents expanded to per-head K/V, chunked attention."""
    B, S, _ = x.shape
    H, nd, rd, vd = cfg.n_heads, cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_dim
    pos = _positions(B, S, x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, pos)
    c, k_rope = _mla_latents(p, cfg, x, pos)
    k_nope = (c @ p["wuk"]).reshape(B, S, H, nd)
    v = (c @ p["wuv"]).reshape(B, S, H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)], dim=-1)
    o = chunked_attention(q, k, v, causal=True, window=None,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = o.reshape(B, S, H * vd) @ p["wo"]
    if return_kv:
        return out, {"c": c, "k_rope": k_rope}
    return out


def mla_decode(p: Params, cfg, x: torch.Tensor, cache: Params, pos: int):
    """Absorbed-matmul MLA decode: caches ONLY (latent c, shared k_rope),
    written at ``pos`` in place.

    score_h(s) = (W_uk_h^T q_nope_h)^T c_s + q_rope_h^T k_rope_s, so W_uk is
    absorbed into the query and the cache stays (B, S, kv_lora + rd).
    """
    B = x.shape[0]
    H, nd, rd, vd = cfg.n_heads, cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_dim
    kvl = cfg.mla_kv_lora
    pos_b = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, pos_b)                  # (B,1,H,nd/rd)
    c, k_rope = _mla_latents(p, cfg, x, pos_b)                 # (B,1,kvl)/(B,1,rd)
    cache["c"][:, pos:pos + 1] = c.to(cache["c"].dtype)
    cache["k_rope"][:, pos:pos + 1] = k_rope.to(cache["k_rope"].dtype)
    c_cache, r_cache = cache["c"], cache["k_rope"]
    wuk = p["wuk"].reshape(kvl, H, nd)
    q_abs = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].to(F32), wuk.to(F32))
    s = torch.einsum("bhl,bsl->bhs", q_abs, c_cache.to(F32))
    s = s + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(F32), r_cache.to(F32))
    s = s / np.sqrt(nd + rd)
    ok = torch.arange(c_cache.shape[1], device=x.device) < pos + 1
    s = torch.where(ok[None, None], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", pr, c_cache.to(F32))   # (B,H,kvl)
    o = torch.einsum("bhl,lhd->bhd", o_lat, p["wuv"].reshape(kvl, H, vd).to(F32))
    out = o.reshape(B, 1, H * vd).to(x.dtype) @ p["wo"]
    return out, {"c": c_cache, "k_rope": r_cache}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, d: int, f: int, dtype, lead: tuple[int, ...] = ()) -> Params:
    return {
        "wi": dense_init(gen, d, f, dtype, lead),
        "wg": dense_init(gen, d, f, dtype, lead),
        "wo": dense_init(gen, f, d, dtype, lead),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
