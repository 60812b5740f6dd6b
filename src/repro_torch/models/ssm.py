"""State-space sequence mixers: Mamba2-style SSD heads (Hymba) and RWKV6.

The JAX package's ``repro.models.ssm`` in plain PyTorch. Both recurrences
are linear in the state, so they run in the chunked form: a Python loop over
chunks of ``chunk`` tokens carries only the float32 inter-chunk state, and
the part inside a chunk is dense (chunk x chunk) products. Decays live in log
space and every exponent inside a chunk is <= 0 (masked entries are set to
-inf before ``exp``), so the float32 tiles never overflow.

Parameter trees have the reference's paths, shapes and dtypes; ``lead``
prefixes every leaf with the stack's layer axis. The draws are the port's
own (parity runs from ``model.params_from_jax``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_randn, dense_init, rmsnorm, rmsnorm_init, sigmoid, silu,
                                       softplus)

Params = dict[str, Any]
F32 = torch.float32


def _rand(gen, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 uniforms in [0, 1) drawn by ``gen`` (shapes alone on meta)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=F32, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device, dtype=F32)


def _full(shape, value: float, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=F32, device=device)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) shifted one token right along S, zero first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _pad_to_chunks(t: torch.Tensor, Sp: int) -> torch.Tensor:
    """Zero-pad axis 1 of ``t`` to ``Sp``."""
    pad = [0, 0] * (t.ndim - 2) + [0, Sp - t.shape[1]]
    return F.pad(t, pad) if Sp != t.shape[1] else t


# ---------------------------------------------------------------------------
# Mamba2-style SSD heads (Hymba's parallel SSM branch)
# ---------------------------------------------------------------------------


def mamba_init(gen, cfg, dtype, lead: tuple[int, ...] = ()) -> Params:
    d, di, H, ns = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
    dev = gen.device
    return {
        "win": dense_init(gen, d, 2 * di, dtype, lead),      # x and gate z
        "wbc": dense_init(gen, d, 2 * ns, dtype, lead),      # B_t, C_t (shared)
        "wdt": dense_init(gen, d, H, dtype, lead),
        "dt_bias": _full(lead + (H,), 0.0, dev),
        "A_log": _full(lead + (H,), 0.0, dev),               # A = -exp(A_log)
        "D": _full(lead + (H,), 1.0, dev),
        "conv": (_randn(gen, lead + (4, di)) * 0.1).to(dtype),
        "norm": rmsnorm_init(di, dtype, lead, dev),
        "wout": dense_init(gen, di, d, dtype, lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width w.shape[0]; x (B,S,di)."""
    width, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + S] * w[i]
    return out


def _ssd_chunk_scan(xdt, a_log, Bm, Cm, chunk: int):
    """Chunked SSD. xdt (B,S,H,dh) = dt*x; a_log (B,S,H) per-step log decay;
    Bm/Cm (B,S,ns). Returns (y (B,S,H,dh), final state (B,H,dh,ns) f32)."""
    B, S, H, dh = xdt.shape
    ns = Bm.shape[-1]
    C = min(chunk, S)
    Sp = -(-S // C) * C        # zero inputs + zero log-decay leave the state alone
    xdt, a_log, Bm, Cm = (_pad_to_chunks(t, Sp) for t in (xdt, a_log, Bm, Cm))
    mask = torch.ones((C, C), dtype=torch.bool, device=xdt.device).tril()
    state = torch.zeros((B, H, dh, ns), dtype=F32, device=xdt.device)
    ys = []
    for c0 in range(0, Sp, C):
        x_c, al_c = xdt[:, c0:c0 + C], a_log[:, c0:c0 + C]
        b_c, c_c = Bm[:, c0:c0 + C], Cm[:, c0:c0 + C]
        Lc = torch.cumsum(al_c, dim=1)                         # (B,C,H)
        # inter-chunk: y_t += (C_t . state) exp(L_t)
        y_inter = torch.einsum("bcn,bhdn->bchd", c_c, state) * torch.exp(Lc)[..., None]
        # intra-chunk: G[t,s] = (C_t . B_s) exp(L_t - L_s) for s <= t
        diff = (Lc[:, :, None, :] - Lc[:, None, :, :]).masked_fill(
            ~mask[None, :, :, None], float("-inf"))           # (B,C,C,H)
        G = torch.einsum("btn,bsn->bts", c_c, b_c)[..., None] * torch.exp(diff)
        y_intra = torch.einsum("btsh,bshd->bthd", G, x_c)
        # state update: S' = exp(L_C) S + sum_s exp(L_C - L_s) x_s B_s^T
        decay_tail = torch.exp(Lc[:, -1:, :] - Lc)            # (B,C,H)
        state = state * torch.exp(Lc[:, -1])[:, :, None, None] + \
            torch.einsum("bch,bchd,bcn->bhdn", decay_tail, x_c, b_c)
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1)[:, :S], state


def _mamba_proj(p: Params, cfg, x: torch.Tensor):
    """Projections shared by the prefill and decode paths."""
    xin, z = (x @ p["win"]).chunk(2, dim=-1)
    Bm, Cm = (x @ p["wbc"]).to(F32).chunk(2, dim=-1)
    dt = softplus(x @ p["wdt"] + p["dt_bias"]).to(F32)
    a_log = (-torch.exp(p["A_log"]))[None, None] * dt      # (B,S,H) log decay
    return xin, z, Bm, Cm, dt, a_log


def mamba_forward(p: Params, cfg, x: torch.Tensor, return_state: bool = False):
    """x (B,S,D) -> (B,S,D). SSD heads with depthwise conv + gated output.
    ``return_state`` also returns the decode cache: the final state and the
    last 3 raw (pre-conv) inputs."""
    B, S, _ = x.shape
    di, H = cfg.ssm_d_inner, cfg.ssm_heads
    dh = di // H
    xin_raw, z, Bm, Cm, dt, a_log = _mamba_proj(p, cfg, x)
    xin = silu(_causal_conv(xin_raw, p["conv"]))
    xh = xin.reshape(B, S, H, dh).to(F32)
    y, final = _ssd_chunk_scan(xh * dt[..., None], a_log, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    out = (rmsnorm(p["norm"], y) * silu(z)) @ p["wout"]
    if return_state:
        conv_buf = F.pad(xin_raw, (0, 0, 3, 0))[:, S:S + 3]
        return out, {"state": final, "conv": conv_buf}
    return out


def mamba_decode(p: Params, cfg, x: torch.Tensor, cache: Params):
    """One token. cache {"state": (B,H,dh,ns) f32, "conv": (B,3,di)}; returns
    (out, new cache) — new tensors, the caller writes them back."""
    B = x.shape[0]
    di, H = cfg.ssm_d_inner, cfg.ssm_heads
    dh = di // H
    xin_raw, z, Bm, Cm, dt, a_log = _mamba_proj(p, cfg, x)
    win = torch.cat([cache["conv"], xin_raw], dim=1)           # (B,4,di)
    xin = silu(torch.einsum("bwd,wd->bd", win, p["conv"])[:, None])
    xh = xin.reshape(B, 1, H, dh).to(F32)                      # un-scaled input
    xdt = xh * dt[..., None]
    a = torch.exp(a_log[:, 0])                                 # (B,H)
    state = cache["state"] * a[:, :, None, None] + \
        torch.einsum("bhd,bn->bhdn", xdt[:, 0], Bm[:, 0])
    y = torch.einsum("bn,bhdn->bhd", Cm[:, 0], state)
    y = y + xh[:, 0] * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y) * silu(z)
    return y @ p["wout"], {"state": state, "conv": win[:, 1:]}


def mamba_cache_init(cfg, batch: int, dtype, lead: tuple[int, ...] = (),
                     device=None) -> Params:
    di, H = cfg.ssm_d_inner, cfg.ssm_heads
    return {
        "state": torch.zeros(lead + (batch, H, di // H, cfg.ssm_state), dtype=F32,
                             device=device),
        "conv": torch.zeros(lead + (batch, 3, di), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# RWKV6 ("Finch"): data-dependent token-shift lerp + per-channel decay wkv
# ---------------------------------------------------------------------------

MIX_LORA = 32
DECAY_LORA = 64
N_MIX = 5  # (r, k, v, w, g)


def rwkv_time_init(gen, cfg, dtype, lead: tuple[int, ...] = ()) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    dev = gen.device
    return {
        "mu": _rand(gen, lead + (N_MIX, d)).to(dtype),
        "maa_w1": dense_init(gen, d, N_MIX * MIX_LORA, dtype, lead),
        "maa_w2": (_randn(gen, lead + (N_MIX, MIX_LORA, d)) * 0.01).to(dtype),
        "wr": dense_init(gen, d, d, dtype, lead),
        "wk": dense_init(gen, d, d, dtype, lead),
        "wv": dense_init(gen, d, d, dtype, lead),
        "wg": dense_init(gen, d, d, dtype, lead),
        "w0": _full(lead + (d,), -1.0, dev),                  # resting log-log decay
        "decay_w1": dense_init(gen, d, DECAY_LORA, dtype, lead),
        "decay_w2": (_randn(gen, lead + (DECAY_LORA, d)) * 0.01).to(dtype),
        "u": _full(lead + (H, d // H), 0.0, dev),             # per-head bonus
        "ln_out": rmsnorm_init(d, dtype, lead, dev),
        "wo": dense_init(gen, d, d, dtype, lead),
    }


def _rwkv_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent lerp between x and the shifted x (5 targets)."""
    dxprev = x_prev - x
    base = x + dxprev * p["mu"][0]   # the first mix feeds the lora that mixes the rest
    mixed = torch.tanh(base @ p["maa_w1"])
    mixed = mixed.reshape(x.shape[:-1] + (N_MIX, MIX_LORA))
    delta = torch.einsum("...nl,nld->...nd", mixed, p["maa_w2"])
    mus = p["mu"][None, None] + delta                          # (B,S,5,D)
    xs = x[..., None, :] + dxprev[..., None, :] * mus
    return [xs[..., i, :] for i in range(N_MIX)]


def _rwkv_rkvwg(p: Params, cfg, x: torch.Tensor, x_prev: torch.Tensor):
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    xr, xk, xv, xw, xg = _rwkv_mix(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(B, S, H, dh)
    k = (xk @ p["wk"]).reshape(B, S, H, dh)
    v = (xv @ p["wv"]).reshape(B, S, H, dh)
    g = silu(xg @ p["wg"])
    dec = torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    logw = -torch.exp(torch.clamp(p["w0"] + dec.to(F32), -8.0, 2.0))
    return r, k, v, g, logw.reshape(B, S, H, dh)               # per-channel log decay < 0


def _wkv_chunk_scan(r, k, v, logw, u, chunk: int):
    """Chunked WKV6: state (dk, dv) per head with per-channel decay.

    r/k/v (B,S,H,dh); logw (B,S,H,dh), applied after the bonus read:
    y_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T.
    Returns (y (B,S,H,dh) f32, final state (B,H,dh,dh) f32).

    The intra-chunk weights are one (B,C,C,H,dh) float32 tile, the masked
    log decays' ``exp`` times r_t k_s, summed over the key channel: an
    explicit product and sum, so no contraction order builds a second tile.
    """
    B, S, H, dh = r.shape
    C = min(chunk, S)
    Sp = -(-S // C) * C        # zero r/k/v + zero log-decay: padding leaves the state
    r, k, v = (_pad_to_chunks(t.to(F32), Sp) for t in (r, k, v))
    logw = _pad_to_chunks(logw, Sp)
    strict = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    masked = ~strict[None, :, :, None, None]
    u = u.to(F32)
    state = torch.zeros((B, H, dh, dh), dtype=F32, device=r.device)
    ys = []
    for c0 in range(0, Sp, C):
        r_c, k_c, v_c, w_c = (t[:, c0:c0 + C] for t in (r, k, v, logw))
        # decay BEFORE position t (exclusive cumsum: the state token t sees)
        Lx = torch.cumsum(w_c, dim=1) - w_c                    # (B,C,H,dh), <= 0
        y_inter = torch.einsum("bchd,bhde->bche", r_c * torch.exp(Lx), state)
        # intra: token t reads s < t scaled by exp(Lx_t - Li_s), Li the
        # inclusive cumsum (s's decay applies after its write)
        Li = Lx + w_c
        decay = torch.exp((Lx[:, :, None] - Li[:, None]).masked_fill(masked, float("-inf")))
        A = (decay * r_c[:, :, None] * k_c[:, None]).sum(dim=-1)   # (B,C,C,H)
        del decay
        y_intra = torch.einsum("btsh,bshe->bthe", A, v_c)
        # bonus: the current token with u in place of the decay
        bonus = (r_c * (u[None, None] * k_c)).sum(dim=-1)      # (B,C,H)
        y_bonus = bonus[..., None] * v_c
        decay_tail = torch.exp(Li[:, -1:] - Li)                # (B,C,H,dh)
        state = state * torch.exp(Li[:, -1])[..., None] + \
            torch.einsum("bchd,bche->bhde", k_c * decay_tail, v_c)
        ys.append(y_inter + y_intra + y_bonus)
    return torch.cat(ys, dim=1)[:, :S], state


def rwkv_time_forward(p: Params, cfg, x: torch.Tensor, return_state: bool = False):
    B, S, d = x.shape
    r, k, v, g, logw = _rwkv_rkvwg(p, cfg, x, _shift(x))
    y, final = _wkv_chunk_scan(r, k, v, logw, p["u"], cfg.ssm_chunk)
    y = y.reshape(B, S, d).to(x.dtype)
    out = (rmsnorm(p["ln_out"], y) * g) @ p["wo"]
    if return_state:
        return out, {"state": final, "x_prev": x[:, -1:]}
    return out


def rwkv_time_decode(p: Params, cfg, x: torch.Tensor, cache: Params):
    """cache {"state": (B,H,dh,dh) f32, "x_prev": (B,1,D)}; returns
    (out, new cache) — new tensors, the caller writes them back."""
    B, _, d = x.shape
    r, k, v, g, logw = _rwkv_rkvwg(p, cfg, x, cache["x_prev"])
    r1, k1, v1 = (t[:, 0].to(F32) for t in (r, k, v))
    state = cache["state"]
    uk = p["u"].to(F32)[None] * k1
    y = torch.einsum("bhd,bhde->bhe", r1, state) + (r1 * uk).sum(-1)[..., None] * v1
    state = state * torch.exp(logw[:, 0])[..., None] + torch.einsum("bhd,bhe->bhde", k1, v1)
    y = y.reshape(B, 1, d).to(x.dtype)
    y = rmsnorm(p["ln_out"], y) * g
    return y @ p["wo"], {"state": state, "x_prev": x}


def rwkv_channel_init(gen, cfg, dtype, lead: tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": _rand(gen, lead + (d,)).to(dtype),
        "mu_r": _rand(gen, lead + (d,)).to(dtype),
        "wk": dense_init(gen, d, f, dtype, lead),
        "wv": dense_init(gen, f, d, dtype, lead),
        "wr": dense_init(gen, d, d, dtype, lead),
    }


def rwkv_channel_forward(p: Params, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    dx = x_prev - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    k = torch.square(F.relu(xk @ p["wk"]))
    return sigmoid(xr @ p["wr"]) * (k @ p["wv"])


def rwkv_cache_init(cfg, batch: int, dtype, lead: tuple[int, ...] = (),
                    device=None) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {
        "time": {"state": torch.zeros(lead + (batch, H, dh, dh), dtype=F32, device=device),
                 "x_prev": torch.zeros(lead + (batch, 1, d), dtype=dtype, device=device)},
        "chan_x_prev": torch.zeros(lead + (batch, 1, d), dtype=dtype, device=device),
    }
