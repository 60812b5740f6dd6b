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


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale). ``amax``:
    the whole tensor's max |x| when ``x`` is one block of it."""
    xf = x.to(F32)
    if amax is None:
        amax = xf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
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
    scale = _clip_scale(ocfg, gnorm)
    bc1, bc2 = _corrections(ocfg, count)
    for (p, _, m, v, *_), g in zip(leaves, used):
        _adam_leaf(ocfg, p, g, m, v, lr, scale, bc1, bc2, decay=p.ndim >= 2)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    if ocfg.compress_grads:
        new_state["err"] = state["err"]
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


def _clip_scale(ocfg: OptConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def _corrections(ocfg: OptConfig, count: torch.Tensor):
    return 1 - ocfg.b1 ** count.to(F32), 1 - ocfg.b2 ** count.to(F32)


def _adam_leaf(ocfg: OptConfig, p, g, m, v, lr, scale, bc1, bc2, decay: bool) -> None:
    """One leaf's (or block's) AdamW update, written in place; ``decay``:
    the decoupled weight decay of matrices (the global leaf's ndim >= 2)."""
    b1, b2 = ocfg.b1, ocfg.b2
    g = g.to(F32) * scale
    m32 = b1 * m.to(F32) + (1 - b1) * g
    v32 = b2 * v.to(F32) + (1 - b2) * torch.square(g)
    step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + ocfg.eps)
    if decay:
        step = step + ocfg.weight_decay * p.to(F32)
    p.copy_(p.to(F32) - lr * step)
    m.copy_(m32)
    v.copy_(v32)


@torch.no_grad()
def apply_update_sharded(params: Params, grads: Params, state: dict, ocfg: OptConfig,
                         grid) -> tuple[Params, dict, dict]:
    """``apply_update`` over a mesh, block by block and in place.

    ``params`` and the state are trees of ``sharding.ShardedTensor``s
    (``count`` replicated), ``grads`` the same tree with each leaf a list of
    per-position gradient blocks, each copy of a replicated block holding
    the whole gradient; ``grid`` is the mesh's ``spmd.Grid``. The global
    norm sums each element once (the blocks' owners, ``ShardedTensor.owners``)
    and all-reduces the sum over the mesh; ``compress_grads``' per-tensor
    scale is the whole leaf's max (an all-max over the blocks); the weight
    decay keys on the global leaf's ndim. Returns the position-0 lr and norm."""
    n = grid.n
    counts = [c + 1 for c in state["count"].shards]
    lrs = [lr_at(ocfg, c) for c in counts]
    errs = [state["err"]] if ocfg.compress_grads else []
    leaves = _zip(params, grads, state["m"], state["v"], *errs)
    if ocfg.compress_grads:
        used = []
        for p, g, _, _, e in leaves:
            targets = [gc.to(F32) + ec.to(F32) for gc, ec in zip(g, e.shards)]
            axes = tuple(a for entry in p.placement.spec
                         for a in ((entry,) if isinstance(entry, str) else entry or ()))
            amax = grid.all_max([t.abs().max() for t in targets], axes)
            hats = []
            for t, a, ec in zip(targets, amax, e.shards):
                g_hat = dequantize_int8(*quantize_int8(t, a))
                ec.copy_((t - g_hat).to(ec.dtype))
                hats.append(g_hat)
            used.append(hats)
    else:
        used = [g for _, g, *_ in leaves]
    sq = []
    for c in range(n):
        mine = [torch.sum(torch.square(g[c].to(F32)))
                for (p, *_), g in zip(leaves, used) if p.owners()[c]]
        sq.append(torch.sum(torch.stack(mine)) if mine else
                  torch.zeros((), dtype=F32, device=grid.devices[c]))
    gnorms = [torch.sqrt(t) for t in grid.all_reduce(sq, grid.names)]
    for c in range(n):
        scale = _clip_scale(ocfg, gnorms[c])
        bc1, bc2 = _corrections(ocfg, counts[c])
        for (p, _, m, v, *_), g in zip(leaves, used):
            _adam_leaf(ocfg, p.shards[c], g[c], m.shards[c], v.shards[c], lrs[c], scale,
                       bc1, bc2, decay=p.ndim >= 2)
    cnt = state["count"]
    new_state = {"m": state["m"], "v": state["v"],
                 "count": type(cnt)(cnt.placement, cnt.shape, cnt.dtype, counts)}
    if ocfg.compress_grads:
        new_state["err"] = state["err"]
    return params, new_state, {"lr": lrs[0], "grad_norm": gnorms[0]}
