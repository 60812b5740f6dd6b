"""Sharding rules: parameter / optimizer / batch / KV-cache partition specs.

The JAX package's rules (``repro.train.sharding``), rule for rule, over a
``DeviceMesh`` (``repro_torch.launch.mesh``) or any object with ``.shape``
(a dict of axis sizes), ``.axis_names`` and ``.size``. A spec is a
``Spec``: one entry per dim, None, an axis name or a tuple of names, as a
``PartitionSpec`` is. The trees are the port's own (``model.init`` /
``init_cache`` on the ``meta`` device give them without data).

Mesh axes: ``("data", "model")`` single-pod or ``("pod", "data", "model")``
multi-pod. Conventions (Megatron + FSDP hybrid):

* batch (and therefore activations) shard over the data axes
  (``pod`` acts as an outer data axis);
* column-parallel weights (wq/wk/wv, MLP in/gate, MoE experts) put their
  output dim on ``model``; row-parallel outputs (wo) their input dim;
* every weight additionally FSDP-shards its non-model dim over the data
  axes when divisible;
* MoE experts go on ``model`` when n_experts divides it, otherwise d_ff is
  tensor-sharded within each expert;
* decode KV caches shard batch over data and the sequence axis over
  ``model``; for batch 1 the cache seq axis shards over the whole mesh.

Divisibility is always checked; non-divisible dims stay unsharded.

``chain_order`` draws the erasure-coded checkpoint's chain from the mesh
(``repro_torch.checkpoint.devio``), and ``state_shardings`` /
``param_shardings`` give each leaf a ``Placement`` (mesh, spec), which
``shard`` (and ``devio.place``) turns into a ``ShardedTensor``: the leaf's
blocks on the mesh's devices, as ``jax.device_put`` with a ``NamedSharding``
lays out a global array in one process.

``set_activation_hints`` installs an ``ActivationHint`` per hint site of the
model code (``repro_torch.hints``): the placement of the activations
between layers. The sharded train step (``repro_torch.train.spmd``) carries
its activations as per-position blocks, and a hint reshards them onto its
spec, as ``with_sharding_constraint`` does under GSPMD; a plain tensor (a
one-device run) passes through unchanged.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import hints as hints_lib
from repro_torch.launch.mesh import DeviceMesh

STACKED_TOPS = ("layers", "enc_layers", "dec_layers")


class Spec(tuple):
    """A partition spec: one entry per dim, each None (whole), an axis
    name, or a tuple of axis names (split over their product, the first
    the most significant). Immutable; ``Spec()`` is fully replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def data_axes(mesh, layout: str = "2d") -> tuple[str, ...]:
    """Axes that carry the batch (and FSDP shards).

    layout="2d"  : batch/FSDP over (pod, data), tensor parallelism over model.
    layout="fsdp": pure ZeRO-3, batch/FSDP over every axis, no TP.
    layout="serve": TP over model only, NO FSDP; batch/caches over the data
                   axes as usual.
    """
    if layout == "fsdp":
        return tuple(mesh.axis_names)
    return tuple(n for n in mesh.axis_names if n != "model")


def model_size(mesh, layout: str = "2d") -> int:
    return 1 if layout == "fsdp" else int(mesh.shape["model"])


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _map_with_path(fn, tree, path: tuple[str, ...] = ()):
    """``fn("a/b/c", leaf)`` over a tree of dicts (and lists), keeping its
    structure; the path is the JAX package's ``_path_str`` of the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


class ActivationHint(NamedTuple):
    """An installed hint: where a site's activation lives on the mesh.

    Called on a plain tensor (a one-device run) it returns the tensor; on a
    sharded activation (``repro_torch.train.spmd.Dist``) it reshards the
    blocks onto its spec (``Dist.constrain``), the counterpart of
    ``jax.lax.with_sharding_constraint``."""
    placement: "Placement"

    def __call__(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return x.constrain(self.placement.spec)


def set_activation_hints(mesh, *, batch: int | None = None, seq_shard: bool = False,
                         layout: str = "2d") -> None:
    """Install an ``ActivationHint`` per site for this mesh (see
    ``repro_torch.hints``): ``act`` (B, S, D), ``logits`` (B, S, V) and
    ``logits2d`` (B, V). ``batch``: the global batch of the step; a batch
    the data axes do not divide stays whole. ``seq_shard`` splits the
    activations' S over ``model`` between layers (sequence parallelism);
    ``layout="fsdp"`` keeps V whole."""
    dp = data_axes(mesh, layout)
    dps = _size(mesh, dp)
    bdim = dp if (batch is None or batch % dps == 0) else None
    sdim = "model" if (seq_shard and layout != "fsdp") else None
    vdim = "model" if layout != "fsdp" else None
    specs = {"act": Spec(bdim, sdim, None), "logits": Spec(bdim, None, vdim),
             "logits2d": Spec(bdim, vdim)}
    hints_lib.set_hints({site: ActivationHint(Placement(mesh, spec))
                         for site, spec in specs.items()})


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

_COL_PARALLEL = {"wq", "wk", "wv", "wi", "wg", "win", "wuq", "wuk", "wuv",
                 "wr"}
_ROW_PARALLEL = {"wo", "wout"}
_FSDP_ONLY = {"wdq", "wdkv", "wkr", "wdt", "wbc", "maa_w1", "decay_w1",
              "router"}


def _param_rule(path: str, shape: tuple[int, ...], mesh, layout: str = "2d") -> Spec:
    fsdp = data_axes(mesh, layout)
    fs = _size(mesh, fsdp)
    ms = model_size(mesh, layout)

    def m_ok(d):
        return "model" if ms > 1 and d % ms == 0 else None

    def f_ok(d):
        if layout == "serve":
            return None  # stationary weights: no gather-on-use
        if d % fs == 0:
            return fsdp
        # graded fallback: shard over the largest axis prefix that divides
        for cut in range(len(fsdp) - 1, 0, -1):
            sub = fsdp[:cut]
            if d % _size(mesh, sub) == 0:
                return sub if len(sub) > 1 else sub[0]
        return None

    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""

    if name == "embed":
        return Spec(m_ok(shape[0]), f_ok(shape[1]))
    if name == "lm_head":
        return Spec(f_ok(shape[0]), m_ok(shape[1]))
    if parent == "moe":
        if name == "router":
            return Spec(f_ok(shape[0]), None)
        E = shape[0]
        if name in ("wi", "wg"):
            if ms > 1 and E % ms == 0:
                return Spec("model", f_ok(shape[1]), None)
            return Spec(None, f_ok(shape[1]), m_ok(shape[2]))
        if name == "wo":
            if ms > 1 and E % ms == 0:
                return Spec("model", None, f_ok(shape[2]))
            return Spec(None, m_ok(shape[1]), f_ok(shape[2]))
    if parent == "chan":  # rwkv channel mix: wv is (F, D) row-parallel
        if name == "wv":
            return Spec(m_ok(shape[0]), f_ok(shape[1]))
        if name in ("wk", "wr"):
            return Spec(f_ok(shape[0]), m_ok(shape[1]))
    if len(shape) == 2 and name in _ROW_PARALLEL:
        return Spec(m_ok(shape[0]), f_ok(shape[1]))
    if len(shape) == 2 and name in _COL_PARALLEL:
        return Spec(f_ok(shape[0]), m_ok(shape[1]))
    if len(shape) == 2 and name in _FSDP_ONLY:
        return Spec(f_ok(shape[0]), None)
    if name == "maa_w2":
        return Spec(None, None, f_ok(shape[-1]))
    if name == "decay_w2":
        return Spec(None, f_ok(shape[-1]))
    if name == "conv":
        return Spec(None, m_ok(shape[-1]))
    if len(shape) >= 2:
        return Spec(f_ok(shape[0]), *([None] * (len(shape) - 1)))
    return Spec(*([None] * len(shape)))


def param_specs(cfg, mesh, params_shape, layout: str = "2d") -> dict:
    """Spec tree matching the params tree (shapes only)."""
    def leaf_spec(ps, leaf):
        top = ps.split("/")[0]
        shape = tuple(leaf.shape)
        if top in STACKED_TOPS:
            inner = _param_rule(ps, shape[1:], mesh, layout)
            return Spec(None, *inner)
        return _param_rule(ps, shape, mesh, layout)

    return _map_with_path(leaf_spec, params_shape)


def layer_param_specs(cfg, mesh, layer_shape, layout: str = "2d") -> dict:
    """Specs for ONE layer's params (no leading stacked-L dim)."""
    return _map_with_path(lambda ps, leaf: _param_rule(ps, tuple(leaf.shape), mesh, layout),
                          layer_shape)


def param_shardings(cfg, mesh: DeviceMesh, params_shape, layout: str = "2d") -> dict:
    """A ``Placement`` per parameter leaf (the JAX package's tree of
    ``NamedSharding``s)."""
    return _map_with_path(lambda _, spec: Placement(mesh, spec),
                          param_specs(cfg, mesh, params_shape, layout))


def opt_specs(cfg, mesh, pspecs, ocfg=None) -> dict:
    """Optimizer state mirrors parameter sharding; count is replicated.
    The int8-compression error-feedback buffer (when enabled) mirrors the
    parameter sharding too."""
    out = {"m": pspecs, "v": pspecs, "count": Spec()}
    if ocfg is not None and getattr(ocfg, "compress_grads", False):
        out["err"] = pspecs
    return out


# ---------------------------------------------------------------------------
# train state (params + opt + step): checkpoint-facing layout
# ---------------------------------------------------------------------------


def state_specs(cfg, mesh, state_shape, ocfg=None, layout: str = "2d") -> dict:
    """Specs for a full train state {"params", "opt", "step"}: the layout
    device-direct checkpointing archives from and elastic restarts
    ``place()`` back onto."""
    pspecs = param_specs(cfg, mesh, state_shape["params"], layout)
    return {"params": pspecs,
            "opt": opt_specs(cfg, mesh, pspecs, ocfg),
            "step": Spec()}


class Placement(NamedTuple):
    """Where a leaf lives: a mesh and its spec (a ``NamedSharding``)."""
    mesh: DeviceMesh
    spec: Spec


def state_shardings(cfg, mesh: DeviceMesh, state_shape, ocfg=None,
                    layout: str = "2d") -> dict:
    """A ``Placement`` per leaf of ``state_specs``: what ``devio``'s
    ``shardings=`` and ``manager.place`` put a restored state onto."""
    return _map_with_path(lambda _, spec: Placement(mesh, spec),
                          state_specs(cfg, mesh, state_shape, ocfg, layout))


def chain_order(mesh, n: int) -> list[int] | None:
    """Shard -> chain-node layout: the device order for an n-node archival
    chain drawn from ``mesh``.

    Chain position p is played by the p-th device of the mesh in row-major
    axis order (its id, ``DeviceMesh.ids``), so the coding chain follows
    the same device walk the parameter shards live on. Returns None when
    the mesh holds fewer than n devices; callers fall back to the fused
    single-launch path.
    """
    ids = list(mesh.ids)
    if len(ids) < n:
        return None
    return [int(i) for i in ids[:n]]


# ---------------------------------------------------------------------------
# placing a tensor on a mesh
# ---------------------------------------------------------------------------


def _blocks(shape: tuple[int, ...], placement: Placement) -> list[tuple[slice, ...]]:
    """The block of ``shape`` each mesh device holds (row-major), per the
    placement's spec: a dim split over axes is cut into their product of
    equal parts, the first axis the most significant."""
    mesh, spec = placement
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    dims = tuple(mesh.shape.values())
    out = []
    for c in range(mesh.size):
        coord = dict(zip(mesh.axis_names, np.unravel_index(c, dims)))
        idx = []
        for d, e in zip(shape, entries):
            axes = spec_axes(e)
            parts = math.prod(mesh.shape[a] for a in axes)
            if d % parts:
                raise ValueError(f"dim {d} of {shape} does not split {parts} ways ({spec})")
            i = 0
            for a in axes:
                i = i * mesh.shape[a] + int(coord[a])
            size = d // parts
            idx.append(slice(i * size, (i + 1) * size))
        out.append(tuple(idx))
    return out


class ShardedTensor:
    """A tensor laid out over a mesh: ``shards[c]`` is the block that mesh
    device c (row-major) holds, on that device, in storage of its own."""

    def __init__(self, placement: Placement, shape, dtype, shards):
        self.placement = placement
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = list(shards)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def blocks(self) -> list[tuple[slice, ...]]:
        """The global index of each position's block (row-major)."""
        return _blocks(self.shape, self.placement)

    def owners(self) -> list[bool]:
        """True at the one position of each distinct block: its coordinate
        is 0 on every mesh axis the spec does not split over. A sum over
        the owners' blocks counts each element once."""
        return owners(self.placement)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, assembled on ``device`` (default: the mesh's
        first device)."""
        dev = torch.device(device) if device is not None else self.placement.mesh.flat[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for block, shard in zip(_blocks(self.shape, self.placement), self.shards):
            out[block] = shard.to(dev)
        return out

    def __repr__(self) -> str:
        return f"ShardedTensor({self.shape}, {self.dtype}, {self.placement.spec})"


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple of names)."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def owners(placement: Placement) -> list[bool]:
    """Per mesh position (row-major): whether it holds the first copy of its
    block, i.e. sits at coordinate 0 on every axis the spec leaves out."""
    mesh, spec = placement
    used = {a for e in spec for a in spec_axes(e)}
    dims = tuple(mesh.shape.values())
    free = [i for i, a in enumerate(mesh.axis_names) if a not in used]
    return [all(np.unravel_index(c, dims)[i] == 0 for i in free) for c in range(mesh.size)]


def shard(x: torch.Tensor, placement: Placement) -> ShardedTensor:
    """``x`` laid out over ``placement``'s mesh (``jax.device_put`` with a
    ``NamedSharding``): each position gets a copy of its block, so it holds
    that block and nothing more of ``x``."""
    mesh = placement.mesh
    shards = []
    for block, dev in zip(_blocks(tuple(x.shape), placement), mesh.flat):
        part = x[block]
        shards.append(torch.empty(part.shape, dtype=x.dtype, device=dev).copy_(part))
    return ShardedTensor(placement, x.shape, x.dtype, shards)


# ---------------------------------------------------------------------------
# batches & caches
# ---------------------------------------------------------------------------


def batch_specs(cfg, mesh, layout: str = "2d") -> dict:
    dp = data_axes(mesh, layout)
    specs = {"tokens": Spec(dp, None), "labels": Spec(dp, None)}
    if cfg.mrope_sections is not None:
        specs["mrope_pos"] = Spec(None, dp, None)
    if cfg.family == "encdec":
        specs["enc_frames"] = Spec(dp, None, None)
    return specs


def cache_specs(cfg, mesh, cache_shape, layout: str = "2d") -> dict:
    dp = data_axes(mesh, layout)
    dps = _size(mesh, dp)
    ms = model_size(mesh, layout)
    all_axes = tuple(mesh.axis_names)
    alls = _size(mesh, all_axes)

    def leaf_spec(path, leaf):
        name = path.split("/")[-1]
        shape = tuple(leaf.shape)  # leading L
        B = shape[1]
        bdim = dp if B % dps == 0 else None
        if name in ("k", "v", "c", "k_rope"):
            S = shape[2]
            if B == 1 and S % alls == 0:
                sdim = all_axes          # long-context: whole-mesh seq shard
            elif bdim is not None and ms > 1 and S % ms == 0:
                sdim = "model"
            else:
                sdim = None
            rest = [None] * (len(shape) - 3)
            return Spec(None, bdim, sdim, *rest)
        if name in ("xk", "xv"):         # whisper cross K/V (B,T,H,Dh)
            H = shape[3]
            return Spec(None, bdim, None,
                        "model" if ms > 1 and H % ms == 0 else None, None)
        if name == "state":              # (L,B,H,dk,dv|ns)
            H = shape[2]
            return Spec(None, bdim,
                        "model" if ms > 1 and H % ms == 0 else None, None, None)
        if name == "conv":               # (L,B,3,di)
            di = shape[3]
            return Spec(None, bdim, None,
                        "model" if ms > 1 and di % ms == 0 else None)
        return Spec(None, bdim, *([None] * (len(shape) - 2)))

    return _map_with_path(leaf_spec, cache_shape)


def decode_input_specs(cfg, mesh, batch: int | None = None, layout: str = "2d") -> dict:
    dp = data_axes(mesh, layout)
    if batch is not None and batch % _size(mesh, dp) != 0:
        dp = None  # long-context decode: batch 1 stays replicated
    return {"token": Spec(dp, None), "pos": Spec()}


def prefill_input_specs(cfg, mesh, batch: int | None = None, layout: str = "2d") -> dict:
    dp = data_axes(mesh, layout)
    if batch is not None and batch % _size(mesh, dp) != 0:
        dp = None
    specs = {"tokens": Spec(dp, None)}
    if cfg.mrope_sections is not None:
        specs["mrope_pos"] = Spec(None, dp, None)
    if cfg.family == "encdec":
        specs["enc_frames"] = Spec(dp, None, None)
    return specs
