"""AdamW with global-norm clipping, a warmup + cosine schedule, and optional
int8 error-feedback gradient compression.

The JAX package's ``repro.optim.adamw`` over trees of torch tensors (nested
dicts). The state tree is the reference's — ``{"m", "v", "count"}``, plus
``"err"`` with ``compress_grads`` — so a checkpoint of it is byte-identical
to the JAX package's. The state dtype is configurable; the update math runs
in float32.

``apply_update`` writes the new parameters, moments and error residuals into
the given tensors (as a torch optimizer does, so a step never holds a second
copy of the model and its moments) and returns the trees with a new
``count``; scalars stay on the parameters' device as 0-d float32 tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.model import _map

Params = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    compress_grads: bool = False   # int8 + error feedback before the update


def _zip(tree, *others):
    """Tuples of corresponding leaves in sorted key order (the JAX package's
    leaf order, whatever order each tree's dicts hold their keys in — a
    restored state's differs from a fresh one's — so sums over leaves add in
    one order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _zip(tree[k], *(o[k] for o in others))]
    return [(tree,) + others]


def lr_at(ocfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as a 0-d float32 tensor."""
    step = step.to(F32)
    warm = step / max(ocfg.warmup_steps, 1)
    frac = (step - ocfg.warmup_steps) / max(ocfg.total_steps - ocfg.warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = ocfg.min_lr_frac + (1 - ocfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return ocfg.peak_lr * torch.where(step < ocfg.warmup_steps, warm, cos)


def init_opt(params: Params, ocfg: OptConfig) -> dict:
    dt = getattr(torch, ocfg.state_dtype)
    template = next(iter(_zip(params)))[0]

    def zeros(tree):
        return _map(lambda a: torch.zeros(a.shape, dtype=dt, device=a.device), tree)
    state = {"m": zeros(params), "v": zeros(params),
             "count": torch.zeros((), dtype=torch.int32, device=template.device)}
    if ocfg.compress_grads:
        state["err"] = zeros(params)   # error-feedback residual
    return state


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    xf = x.to(F32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8: quantize (g + carried error), carry the residual.

    Across data-parallel replicas the int8 tensor and its float32 scale are
    what crosses the slow links; the residual keeps the optimizer unbiased
    over time (EF-SGD). Returns (g_hat float32, new_err in err's dtype).
    """
    target = g.to(F32) + err.to(F32)
    g_hat = dequantize_int8(*quantize_int8(target))
    return g_hat, (target - g_hat).to(err.dtype)


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def _norm(tensors) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(a.to(F32)))
                                             for a in tensors])))


def global_norm(tree: Params) -> torch.Tensor:
    return _norm(a for (a,) in _zip(tree))


@torch.no_grad()
def apply_update(params: Params, grads: Params, state: dict,
                 ocfg: OptConfig) -> tuple[Params, dict, dict]:
    """One AdamW step. Writes the new values into ``params`` and the state's
    ``m`` / ``v`` (and ``err``) in place; returns (params, new state,
    {"lr", "grad_norm"})."""
    count = state["count"] + 1
    lr = lr_at(ocfg, count)
    errs = [state["err"]] if ocfg.compress_grads else []
    leaves = _zip(params, grads, state["m"], state["v"], *errs)
    if ocfg.compress_grads:
        used = []
        for _, g, _, _, e in leaves:
            g_hat, new_e = compress_with_feedback(g, e)
            e.copy_(new_e)
            used.append(g_hat)
    else:
        used = [g for _, g, *_ in leaves]
    gnorm = _norm(used)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = ocfg.b1, ocfg.b2
    bc1 = 1 - b1 ** count.to(F32)
    bc2 = 1 - b2 ** count.to(F32)
    for (p, _, m, v, *_), g in zip(leaves, used):
        g = g.to(F32) * scale
        m32 = b1 * m.to(F32) + (1 - b1) * g
        v32 = b2 * v.to(F32) + (1 - b2) * torch.square(g)
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + ocfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            step = step + ocfg.weight_decay * p.to(F32)
        p.copy_(p.to(F32) - lr * step)
        m.copy_(m32)
        v.copy_(v32)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    if ocfg.compress_grads:
        new_state["err"] = state["err"]
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
