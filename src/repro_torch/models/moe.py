"""Mixture-of-Experts layer: top-k router + GShard-style dispatch/combine.

The JAX package's ``repro.models.moe`` in plain PyTorch: the dense one-hot
formulation (token -> (expert, capacity slot)), grouped per batch row so the
dispatch tensor stays (B, S, E, C) with C = ceil(S * topk / E *
capacity_factor) padded to a multiple of 8. Tokens past an expert's
capacity are dropped (their combine weight is 0), primary routes (k = 0)
claim capacity first, and the Switch-style load-balancing loss is returned
beside the output. Windows of ``moe_seq_chunk`` tokens dispatch apart, with
capacity enforced per window.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.layers import dense_init, silu

Params = dict[str, Any]
F32 = torch.float32


def moe_init(gen, cfg, dtype, lead: tuple[int, ...] = ()) -> Params:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, d, E, dtype, lead),
        "wi": dense_init(gen, d, f, dtype, lead + (E,)),
        "wg": dense_init(gen, d, f, dtype, lead + (E,)),
        "wo": dense_init(gen, f, d, dtype, lead + (E,)),
    }


def expert_capacity(seq: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    c = int(np.ceil(seq * top_k / n_experts * capacity_factor))
    return max(8, int(np.ceil(c / 8)) * 8)


def moe_rows(cfg, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) as the rows that dispatch apart: windows of
    ``moe_seq_chunk`` tokens when the sequence splits into them."""
    B, S, D = x.shape
    chunk = getattr(cfg, "moe_seq_chunk", 0)
    if chunk and S > chunk and S % chunk == 0:
        return x.reshape(B * (S // chunk), chunk, D)
    return x


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over ``n`` classes, by the same ops on every
    device (``F.one_hot`` reads the indices back to the host on the CPU, and
    runs other ops on the card and on the meta device)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(F32)


def route(p: Params, cfg, x: torch.Tensor):
    """Top-k routing of rows x (B,S,D): returns (dispatch (B,S,E,C),
    combine (B,S,E,C), probs (B,S,E), onehot (B,S,K,E)), float32."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    C = expert_capacity(S, E, K, cfg.capacity_factor)

    # router logits in float32: XLA keeps the bf16 product's float32 value
    # when it is cast straight to float32, and a bf16-rounded router ties
    # and flips experts where the reference does not
    logits = x.to(F32) @ p["router"].to(F32)                    # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    # top-k as lax.top_k breaks ties (bf16 router logits tie often): the
    # lower expert index first, through a stable descending sort
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]   # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, k) within its expert's buffer, k = 0 first
    onehot = _one_hot(gate_idx, E)                              # (B,S,K,E)
    flat = onehot.permute(0, 2, 1, 3).reshape(B, K * S, E)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    pos = pos_flat.reshape(B, K, S, E).permute(0, 2, 1, 3)
    in_cap = (pos < C) & (onehot > 0)                           # (B,S,K,E)
    slot = torch.where(in_cap, pos, 0).to(torch.int64)

    slot_onehot = _one_hot(slot, C) * in_cap[..., None].to(F32)   # (B,S,K,E,C)
    dispatch = slot_onehot.sum(dim=2)                                       # (B,S,E,C)
    combine = (slot_onehot * gate_vals[..., None, None] * onehot[..., None]).sum(dim=2)
    return dispatch, combine, probs, onehot


def experts(p: Params, x: torch.Tensor, dispatch: torch.Tensor,
            combine: torch.Tensor) -> torch.Tensor:
    """The experts of ``p`` (a leading E axis, matching dispatch's) over
    their routed tokens; the combined output (B,S,D) in float32."""
    xin = torch.einsum("bsd,bsec->becd", x.to(F32), dispatch).to(x.dtype)  # (B,E,C,D)
    h = silu(torch.einsum("becd,edf->becf", xin, p["wg"])) * \
        torch.einsum("becd,edf->becf", xin, p["wi"])
    eo = torch.einsum("becf,efd->becd", h, p["wo"])
    return torch.einsum("becd,bsec->bsd", eo.to(F32), combine)


def load_stats(probs: torch.Tensor, onehot: torch.Tensor):
    """(f_e, P_e): each expert's share of primary routes and its mean router
    probability, averaged over the rows."""
    S = probs.shape[1]
    f_e = torch.mean(onehot[:, :, 0].sum(dim=1) / S, dim=0)
    P_e = torch.mean(probs, dim=(0, 1))
    return f_e, P_e


def moe_forward(p: Params, cfg, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (out (B,S,D), aux_loss scalar)."""
    rows = moe_rows(cfg, x)
    dispatch, combine, probs, onehot = route(p, cfg, rows)
    out = experts(p, rows, dispatch, combine)

    # load-balancing aux loss (Switch style): E * sum_e f_e * P_e
    f_e, P_e = load_stats(probs, onehot)
    aux = cfg.n_experts * torch.sum(f_e * P_e)
    return out.reshape(x.shape).to(x.dtype), aux
