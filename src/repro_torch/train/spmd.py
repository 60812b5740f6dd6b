"""Single-controller SPMD training over a ``DeviceMesh``: the work GSPMD does
for the JAX package, written out.

The JAX package lowers its train step once over a mesh, with
``NamedSharding``s on the state and the activations, and GSPMD partitions
the program: it inserts the all-gathers of FSDP-sharded weights, the
all-reduces of tensor-parallel partial sums and the reduce-scatters of the
gradients. The port has no such compiler, so this module runs the
partitioned program by hand, in one process, like the port's placed chains
(``repro_torch.launch.mesh``):

* A value on the mesh is a list of per-position blocks; position c's block
  lives on ``mesh.flat[c]``. ``Dist`` pairs the blocks with their spec (a
  ``sharding.Spec`` of the global tensor). A block crosses devices by
  ``.to()`` / ``copy_``: a peer copy between two cards, a copy in place
  between two positions of one card. No ``torch.distributed`` group is used.
* ``Grid`` holds the collectives over the axis groups of the mesh:
  ``all_gather``, ``reduce_scatter``, ``all_reduce`` and ``all_max``. Each is
  an autograd function whose backward is its transpose (an all-gather's is a
  reduce-scatter and the reverse, an all-reduce's an all-reduce), so autograd
  differentiates the partitioned program exactly. Each call records
  ``(op, dtype, per-device output shape, group size)`` in the grid's
  ``Ledger``; ``repro_torch.launch.hlo`` turns the records into link bytes.
  A group computes its result once, in member order, so every member holds
  the same bits.
* ``build_sharded_train_step`` is ``steps.build_train_step`` over a train
  state of ``sharding.ShardedTensor``s laid out by
  ``sharding.state_shardings``; its loss, gradient norm and updated
  parameters are the one-device step's up to the order of reductions.

How the step partitions the model:

* FSDP: a weight's data-axes dims are gathered where the layer uses it
  (``_Leaf``; in ``layout="fsdp"`` every axis is a data axis). With
  ``cfg.remat`` each layer keeps only its inputs and is recomputed in the
  backward (``_Remat``), so the gathered copy is freed after the forward
  and gathered again for the backward (ZeRO-3). The gather's backward sums the gradient over every
  position that used the block: a reduce-scatter over the gathered axes and
  an all-reduce over the axes the weight is replicated on, so each copy of a
  replicated leaf gets the same whole gradient.
* Tensor parallelism (Megatron) on ``model`` wherever the rules put whole
  heads or whole FFN slices on a position: GQA and MLA attention (column-
  parallel q/k/v, row-parallel wo), whisper's cross attention, the SwiGLU
  MLP, and the MoE experts (expert parallelism when ``model`` divides
  n_experts, TP within each expert otherwise). The layer runs the model's
  own functions on the local weights with a config of the local head count,
  and the row-parallel partial sums are all-reduced BEFORE the residual add.
* Where a ``model`` split does not line up with the math — a head count
  ``model`` does not divide (hymba's 25 heads), a ``kv*Dh`` split that cuts
  a head, RWKV's time and channel mixes, the mamba branch — the weight is
  gathered over ``model`` too and every model position computes the whole
  sublayer, as GSPMD does when it cannot keep a sharding. The ledger shows
  those gathers.
* Vocabulary: the embedding is looked up vocab-parallel (each model
  position its rows, others zero, then an all-reduce) and the cross entropy
  runs on vocab-sharded logits: the row max (an all-max, no gradient), the
  sum of exponentials and the picked logit are all-reduced over ``model``.
* The batch is split over the data axes (``sharding.batch_specs``); the
  token-mean loss divides by the all-reduced count of unmasked labels, and
  the MoE load-balancing statistics are averaged over the data axes before
  the aux loss is formed, so both are the global batch's.
* Activations follow the installed hints (``sharding.set_activation_hints``):
  ``hint(x, "act")`` reshards a ``Dist`` (``seq_shard`` splits S over
  ``model`` between layers; each sublayer gathers S back before it mixes the
  sequence).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.hints import hint
from repro_torch.models import encdec, transformer
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.optim import adamw
from repro_torch.train import sharding
from repro_torch.train.sharding import Placement, Spec, spec_axes

MODEL = ("model",)
F32 = torch.float32


# ---------------------------------------------------------------------------
# the ledger of collectives
# ---------------------------------------------------------------------------


class Collective(NamedTuple):
    """One collective as every device of its groups runs it: the op, the
    dtype, the shape of each device's output, and the group size."""
    op: str                 # all-gather | all-reduce | reduce-scatter
    dtype: torch.dtype
    shape: tuple
    group: int


class Ledger:
    """The collectives a program ran, in order (``records``)."""

    def __init__(self):
        self.records: list[Collective] = []

    def add(self, op: str, out: torch.Tensor, group: int) -> None:
        if group > 1:
            self.records.append(Collective(op, out.dtype, tuple(out.shape), group))

    def clear(self) -> None:
        self.records.clear()


def _own(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of ``t`` on ``device`` in storage of its own."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


# ---------------------------------------------------------------------------
# the grid: positions, axis groups, collectives
# ---------------------------------------------------------------------------


class Grid:
    """The positions of a mesh and the collectives over its axis groups.

    A group over ``axes`` is the positions that agree on every other axis,
    ordered by their coordinates on ``axes`` (the first most significant),
    the order ``sharding.shard`` splits a dim in."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.axis_names)
        self.dims = tuple(mesh.shape.values())
        self.n = mesh.size
        self.devices = tuple(mesh.flat)
        self.coords = [tuple(int(i) for i in np.unravel_index(c, self.dims))
                       for c in range(self.n)]
        self.ledger = Ledger()
        self._groups: dict[tuple, list[list[int]]] = {}

    def size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def rank(self, c: int, axes) -> int:
        """Position c's index within its group over ``axes``."""
        r = 0
        for a in axes:
            i = self.names.index(a)
            r = r * self.dims[i] + self.coords[c][i]
        return r

    def groups(self, axes) -> list[list[int]]:
        axes = tuple(axes)
        if axes not in self._groups:
            rest = [i for i, a in enumerate(self.names) if a not in axes]
            by: dict[tuple, list[int]] = {}
            for c in range(self.n):
                by.setdefault(tuple(self.coords[c][i] for i in rest), []).append(c)
            self._groups[axes] = [sorted(g, key=lambda c: self.rank(c, axes))
                                  for g in by.values()]
        return self._groups[axes]

    # -- collectives (autograd functions; a group of one is the identity) --

    def all_reduce(self, xs, axes) -> list[torch.Tensor]:
        if self.size(axes) == 1:
            return list(xs)
        return list(_AllReduce.apply(self, tuple(axes), *xs))

    def all_gather(self, xs, axes, dim: int) -> list[torch.Tensor]:
        if self.size(axes) == 1:
            return list(xs)
        return list(_AllGather.apply(self, tuple(axes), dim, *xs))

    def reduce_scatter(self, xs, axes, dim: int) -> list[torch.Tensor]:
        if self.size(axes) == 1:
            return list(xs)
        return list(_ReduceScatter.apply(self, tuple(axes), dim, *xs))

    @torch.no_grad()
    def all_max(self, xs, axes) -> list[torch.Tensor]:
        """The elementwise max over each group (no gradient)."""
        if self.size(axes) == 1:
            return list(xs)
        out = [None] * self.n
        for g in self.groups(axes):
            t = xs[g[0]]
            for q in g[1:]:
                t = torch.maximum(t, xs[q].to(t.device))
            for q in g:
                out[q] = _own(t, self.devices[q])
        self.ledger.add("all-reduce", out[0], self.size(axes))
        return out

    # -- the groups' arithmetic, outside autograd --

    def _sum(self, xs, axes) -> list[torch.Tensor]:
        out = [None] * self.n
        for g in self.groups(axes):
            t = xs[g[0]]
            for q in g[1:]:
                t = t + xs[q].to(t.device)
            for q in g:
                out[q] = t if q == g[0] else _own(t, self.devices[q])
        return out

    def _cat(self, xs, axes, dim: int) -> list[torch.Tensor]:
        out = [None] * self.n
        for g in self.groups(axes):
            dev = self.devices[g[0]]
            t = torch.cat([xs[q].to(dev) for q in g], dim)
            for q in g:
                out[q] = t if q == g[0] else _own(t, self.devices[q])
        return out

    def _scatter(self, xs, axes, dim: int) -> list[torch.Tensor]:
        out = [None] * self.n
        for g in self.groups(axes):
            t = xs[g[0]]
            for q in g[1:]:
                t = t + xs[q].to(t.device)
            size = t.shape[dim] // len(g)
            for i, q in enumerate(g):
                out[q] = _own(t.narrow(dim, i * size, size), self.devices[q])
        return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, *xs):
        ctx.grid, ctx.axes = grid, axes
        out = grid._sum(xs, axes)
        grid.ledger.add("all-reduce", out[0], grid.size(axes))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        grid = ctx.grid
        out = grid._sum(gs, ctx.axes)
        grid.ledger.add("all-reduce", out[0], grid.size(ctx.axes))
        return (None, None, *out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, dim, *xs):
        ctx.grid, ctx.axes, ctx.dim = grid, axes, dim
        out = grid._cat(xs, axes, dim)
        grid.ledger.add("all-gather", out[0], grid.size(axes))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        grid = ctx.grid
        out = grid._scatter(gs, ctx.axes, ctx.dim)
        grid.ledger.add("reduce-scatter", out[0], grid.size(ctx.axes))
        return (None, None, None, *out)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, dim, *xs):
        ctx.grid, ctx.axes, ctx.dim = grid, axes, dim
        out = grid._scatter(xs, axes, dim)
        grid.ledger.add("reduce-scatter", out[0], grid.size(axes))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        grid = ctx.grid
        out = grid._cat(gs, ctx.axes, ctx.dim)
        grid.ledger.add("all-gather", out[0], grid.size(ctx.axes))
        return (None, None, None, *out)


# ---------------------------------------------------------------------------
# sharded activations
# ---------------------------------------------------------------------------


def _entries(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


class Dist:
    """A global tensor as per-position blocks (``blocks[c]`` on the grid's
    c-th device) laid out by ``spec``; a position off an axis's split holds
    a copy."""

    def __init__(self, grid: Grid, blocks, spec):
        self.grid = grid
        self.blocks = list(blocks)
        self.spec = Spec(*_entries(spec, self.blocks[0].ndim))

    def axes(self, dim: int) -> tuple[str, ...]:
        return spec_axes(self.spec[dim])

    def constrain(self, spec) -> "Dist":
        """These values laid out by ``spec``: a dim split over axes it is
        not split over now is sliced (each position keeps its part, no
        communication); a dim split now and not in ``spec`` is all-gathered.
        A dim the target axes do not divide stays whole."""
        target = _entries(spec, len(self.spec))
        if tuple(target) == tuple(self.spec):
            return self
        g = self.grid
        blocks, entries = list(self.blocks), list(self.spec)
        for d, (cur, want) in enumerate(zip(self.spec, target)):
            if spec_axes(cur) and spec_axes(cur) != spec_axes(want):
                blocks = g.all_gather(blocks, spec_axes(cur), d)
                entries[d] = None
        for d, want in enumerate(target):
            axes = spec_axes(want)
            if not axes or spec_axes(entries[d]) == axes:
                continue
            whole = blocks[0].shape[d]
            parts = g.size(axes)
            if whole % parts:
                continue
            size = whole // parts
            blocks = [b.narrow(d, g.rank(c, axes) * size, size) for c, b in enumerate(blocks)]
            entries[d] = want
        return Dist(g, blocks, Spec(*entries))


def distribute(grid: Grid, x, spec) -> Dist:
    """A global tensor (or a ``ShardedTensor``) as a ``Dist`` laid out by
    ``spec``."""
    if not isinstance(x, sharding.ShardedTensor):
        x = sharding.shard(x, Placement(grid.mesh, spec))
    return Dist(grid, x.shards, x.placement.spec)


# ---------------------------------------------------------------------------
# parameters: gather on use
# ---------------------------------------------------------------------------


class _Plan:
    """How one parameter leaf's blocks become each position's compute copy.

    ``keep`` names the axes the leaf stays split on (``model`` for a tensor-
    parallel sublayer); every other axis its spec splits over is gathered.
    Positions that agree on the kept axes hold the same region of the leaf
    (a class); the backward sums their gradients and hands each block its
    part."""

    def __init__(self, grid: Grid, shape: tuple, spec: Spec, keep: frozenset):
        self.grid = grid
        entries = _entries(spec, len(shape))
        for e in entries:
            axes = spec_axes(e)
            if any(a in keep for a in axes) and not all(a in keep for a in axes):
                raise ValueError(f"a dim of {spec} mixes kept and gathered axes")
        self.gathered = tuple(a for e in entries for a in spec_axes(e) if a not in keep)
        kept = tuple(a for e in entries for a in spec_axes(e) if a in keep)
        blocks = sharding._blocks(shape, Placement(grid.mesh, Spec(*entries)))
        self.region = [tuple(b if spec_axes(e) and spec_axes(e)[0] in keep else slice(0, d)
                             for b, e, d in zip(blk, entries, shape)) for blk in blocks]
        # each position's block within its region
        self.inner = [tuple(slice(b.start - r.start, b.stop - r.start) for b, r in zip(blk, reg))
                      for blk, reg in zip(blocks, self.region)]
        self.classes = grid.groups(tuple(a for a in grid.names if a not in kept))
        self.n_gather = grid.size(self.gathered)
        self.n_repl = len(self.classes[0]) // self.n_gather
        self.shapes = [tuple(s.stop - s.start for s in reg) for reg in self.region]
        groups = grid.groups(self.gathered)
        self.members = [next(grp for grp in groups if c in grp) for c in range(grid.n)]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _Plan, *blocks):
        ctx.plan = plan
        g = plan.grid
        out = []
        for c in range(g.n):
            if plan.n_gather == 1:
                out.append(blocks[c].view_as(blocks[c]))
                continue
            t = torch.empty(plan.shapes[c], dtype=blocks[c].dtype, device=g.devices[c])
            for q in plan.members[c]:
                t[plan.inner[q]] = blocks[q].to(t.device)
            out.append(t)
        g.ledger.add("all-gather", out[0], plan.n_gather)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        plan = ctx.plan
        g = plan.grid
        out = [None] * g.n
        for cls in plan.classes:
            t = gs[cls[0]]
            for q in cls[1:]:
                t = t + gs[q].to(t.device)
            for q in cls:
                out[q] = _own(t[plan.inner[q]], g.devices[q])
        g.ledger.add("reduce-scatter", out[0], plan.n_gather)
        g.ledger.add("all-reduce", out[0], plan.n_repl)
        return (None, *out)


class _Remat(torch.autograd.Function):
    """A layer that keeps only its inputs and is recomputed in the backward:
    ``torch.utils.checkpoint``'s job, done as one recomputation and one
    inner ``autograd.grad`` inside this node's backward. (The non-reentrant
    checkpoint recomputes from whichever autograd device thread first
    unpacks a saved tensor; a layer spread over several cards is unpacked
    by several device threads at once, and their recomputations collide.)
    ``run(*inputs)`` returns the layer's output tensors."""

    @staticmethod
    def forward(ctx, run, *inputs):
        ctx.run = run
        ctx.save_for_backward(*inputs)
        return tuple(run(*inputs))

    @staticmethod
    def backward(ctx, *gouts):
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.run(*inputs)
        pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        wrt = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True))
        return (None, *(next(got) if t.requires_grad else None for t in inputs))


def _leaves_of(tree) -> list:
    return [x for v in tree.values() for x in _leaves_of(v)] if isinstance(tree, dict) \
        else [tree]


def _with_blocks(tree, it):
    """``tree`` (of ``_Leaf``s) with each leaf's blocks taken from ``it``."""
    if isinstance(tree, dict):
        return {k: _with_blocks(v, it) for k, v in tree.items()}
    return tree._replace(blocks=[next(it) for _ in tree.blocks])


class _Leaf(NamedTuple):
    """One parameter leaf as a layer uses it: each position's block (a leaf
    tensor of the step's autograd graph), its spec and global shape, and
    whether the model casts it to the compute dtype."""
    blocks: list
    spec: Spec
    shape: tuple
    cast: bool


# ---------------------------------------------------------------------------
# the partitioned model
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _per_position(tree, n: int) -> list:
    """A tree whose leaves are per-position lists -> a list of trees."""
    if isinstance(tree, dict):
        parts = {k: _per_position(v, n) for k, v in tree.items()}
        return [{k: parts[k][c] for k in tree} for c in range(n)]
    return tree


class ShardedModel:
    """``model.loss_fn`` partitioned over a mesh (see the module docstring).

    The sublayers' tensor-parallel plan comes from the config and the
    mesh's ``model`` size: a sublayer is tensor parallel when its head
    count (or d_ff, or n_experts) splits evenly, which is exactly when the
    sharding rules put whole heads (slices, experts) on each position."""

    def __init__(self, cfg, mesh, layout: str = "2d"):
        self.cfg = cfg
        self.grid = Grid(mesh)
        ms = sharding.model_size(mesh, layout)
        self.ms = ms
        H, KV = cfg.n_heads, cfg.n_kv_heads
        on = ms > 1
        self.attn_tp = on and H % ms == 0 and (cfg.mla or KV % ms == 0)
        self.xattn_tp = on and H % ms == 0
        self.mlp_tp = on and cfg.d_ff % ms == 0
        self.moe_ep = on and cfg.family == "moe" and cfg.n_experts % ms == 0
        self.moe_tp = on and cfg.family == "moe" and not self.moe_ep and cfg.d_ff % ms == 0
        self.cfg_attn = dataclasses.replace(
            cfg, n_heads=H // ms, n_kv_heads=KV if cfg.mla else KV // ms) \
            if self.attn_tp else cfg
        self.cfg_xattn = dataclasses.replace(cfg, n_heads=H // ms) if self.xattn_tp else cfg
        self._plans: dict[tuple, _Plan] = {}

    # -- parameters --

    def _plan(self, leaf: _Leaf, keep: bool) -> _Plan:
        key = (leaf.shape, leaf.spec, keep)
        if key not in self._plans:
            self._plans[key] = _Plan(self.grid, leaf.shape, leaf.spec,
                                     frozenset(MODEL) if keep else frozenset())
        return self._plans[key]

    def gather(self, tree, keep: bool = False) -> list:
        """Each position's compute copy of every leaf of ``tree`` (``_Leaf``s):
        gathered over the data axes, and over ``model`` unless ``keep``;
        cast to the compute dtype where ``model.cast_params`` casts."""
        def one(leaf: _Leaf):
            plan = self._plan(leaf, keep)
            if plan.n_gather == 1 and plan.n_repl == 1:
                out = list(leaf.blocks)
            else:
                out = list(_Gather.apply(plan, *leaf.blocks))
            return [t.to(self.cfg.cdtype) if leaf.cast else t for t in out]
        return _per_position(_tree_map(one, tree), self.grid.n)

    def _model_split(self, leaf: _Leaf, dim: int) -> bool:
        return "model" in spec_axes(_entries(leaf.spec, len(leaf.shape))[dim])

    # -- activations --

    def _map(self, fn, *xs) -> list:
        return [fn(c, *args) for c, args in enumerate(zip(*xs))]

    def _whole_seq(self, x: Dist) -> Dist:
        return x.constrain(Spec(x.spec[0], None, *x.spec[2:]))

    def _residual(self, x: Dist, out: list, spec) -> Dist:
        """x + a sublayer's output (whole over ``model``, laid out by
        ``spec``), on x's layout."""
        o = Dist(self.grid, out, spec).constrain(x.spec)
        return Dist(self.grid, self._map(lambda c, a, b: a + b, x.blocks, o.blocks), x.spec)

    def _normed(self, norm: dict, x: Dist) -> Dist:
        """An RMSNorm (``{"scale": _Leaf}``) of x, with S gathered whole."""
        w = self.gather({"n": norm})
        h = Dist(self.grid, self._map(lambda c, t: L.rmsnorm(w[c]["n"], t), x.blocks), x.spec)
        return self._whole_seq(h)

    def _tp_out(self, out: list, tp: bool) -> list:
        return self.grid.all_reduce(out, MODEL) if tp else out

    # -- embedding and head --

    def embed(self, table: _Leaf, tokens: Dist) -> Dist:
        g, cfg = self.grid, self.cfg
        split = self._model_split(table, 0)
        w = self.gather({"e": table}, keep=split)
        if split:
            vl = table.shape[0] // self.ms

            def look(c, tok):
                loc = tok.to(torch.int64) - g.rank(c, MODEL) * vl
                ok = (loc >= 0) & (loc < vl)
                rows = w[c]["e"][torch.clamp(loc, 0, vl - 1)]
                return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                    device=rows.device))
            x = g.all_reduce(self._map(look, tokens.blocks), MODEL)
        else:
            x = self._map(lambda c, tok: w[c]["e"][tok], tokens.blocks)
        x = [t.to(cfg.cdtype) for t in x]
        return hint(Dist(g, x, Spec(tokens.spec[0], None, None)), "act")

    def logits(self, p: dict, x: Dist) -> Dist:
        x = self._whole_seq(x)
        split = self._model_split(p["lm_head"], 1)
        fn = self.gather({"n": p["final_norm"]})
        head = self.gather({"h": p["lm_head"]}, keep=split)
        out = self._map(lambda c, t: (L.rmsnorm(fn[c]["n"], t) @ head[c]["h"].to(self.cfg.cdtype))
                        .to(F32), x.blocks)
        return hint(Dist(self.grid, out, Spec(x.spec[0], None, "model" if split else None)),
                    "logits")

    # -- the decoder-only stack --

    def _moe(self, lw: dict, h: Dist) -> tuple[list, list]:
        g, cfg = self.grid, self.cfg
        router = self.gather({"router": lw["router"]})
        tp = self.moe_ep or self.moe_tp
        w = self.gather({k: lw[k] for k in ("wi", "wg", "wo")}, keep=tp)
        outs, fs, ps = [], [], []
        for c, x in enumerate(h.blocks):
            rows = moe_lib.moe_rows(cfg, x)
            dispatch, combine, probs, onehot = moe_lib.route(router[c], cfg, rows)
            if self.moe_ep:
                el = cfg.n_experts // self.ms
                e0 = g.rank(c, MODEL) * el
                dispatch, combine = dispatch[:, :, e0:e0 + el], combine[:, :, e0:e0 + el]
            outs.append(moe_lib.experts(w[c], rows, dispatch, combine).reshape(x.shape))
            f, pe = moe_lib.load_stats(probs, onehot)
            fs.append(f)
            ps.append(pe)
        outs = [o.to(h.blocks[0].dtype) for o in self._tp_out(outs, tp)]
        bax = h.axes(0)
        nb = g.size(bax)
        fs, ps = g.all_reduce(fs, bax), g.all_reduce(ps, bax)
        aux = [cfg.n_experts * torch.sum((f / nb) * (pe / nb)) for f, pe in zip(fs, ps)]
        return outs, aux

    def decoder_layer(self, lw: dict, xb: list, xspec, flag: bool, mrope):
        """``transformer.decoder_layer`` over the mesh: returns the output
        blocks and each position's aux loss."""
        g, cfg = self.grid, self.cfg
        x = Dist(g, xb, xspec)
        h = self._normed(lw["norm1"], x)
        if cfg.family == "ssm":
            w = self.gather(lw["time"])
            out = self._map(lambda c, t: ssm_lib.rwkv_time_forward(w[c], cfg, t), h.blocks)
        else:
            w = self.gather(lw["attn"], keep=self.attn_tp)
            out = self._map(lambda c, t: transformer._attn(
                {"attn": w[c]}, self.cfg_attn, t, flag,
                None if mrope is None else mrope[c], False), h.blocks)
            out = self._tp_out(out, self.attn_tp)
            if cfg.family == "hybrid":
                wm = self.gather(lw["mamba"])
                nm = self.gather({k: lw[k] for k in ("attn_out_norm", "mamba_out_norm")})
                out = self._map(lambda c, a, t: transformer._hybrid_mix(
                    nm[c], a, ssm_lib.mamba_forward(wm[c], cfg, t)), out, h.blocks)
        x = hint(self._residual(x, out, h.spec), "act")
        h = self._normed(lw["norm2"], x)
        aux = [torch.zeros((), dtype=F32, device=d) for d in g.devices]
        if cfg.family == "ssm":
            w = self.gather(lw["chan"])
            out = self._map(lambda c, t: ssm_lib.rwkv_channel_forward(
                w[c], t, ssm_lib._shift(t)), h.blocks)
        elif cfg.family == "moe":
            out, aux = self._moe(lw["moe"], h)
        else:
            w = self.gather(lw["mlp"], keep=self.mlp_tp)
            out = self._tp_out(self._map(lambda c, t: L.mlp(w[c], t), h.blocks), self.mlp_tp)
        x = hint(self._residual(x, out, h.spec), "act")
        return x.blocks, x.spec, aux

    def _remat(self, layer, lw: dict, *lists):
        """``layer(lw, *lists)`` -> (blocks, spec, *per-position lists),
        recomputed in the backward (``_Remat``). ``lists`` are per-position
        tensor lists, or None."""
        n = self.grid.n
        flat = [t for leaf in _leaves_of(lw) for t in leaf.blocks]
        flat += [t for xs in lists if xs is not None for t in xs]
        spec = []

        def run(*tensors):
            it = iter(tensors)
            w = _with_blocks(lw, it)
            args = [None if xs is None else [next(it) for _ in xs] for xs in lists]
            blocks, out_spec, *rest = layer(w, *args)
            spec[:] = [out_spec]
            return [*blocks, *(t for r in rest for t in r)]
        outs = _Remat.apply(run, *flat)
        rest = [list(outs[i:i + n]) for i in range(n, len(outs), n)]
        return (list(outs[:n]), spec[0], *rest)

    def run_stack(self, layers: list, x: Dist, mrope: Dist | None):
        """``transformer.run_stack``: returns (hidden, each position's mean
        aux loss)."""
        g, cfg = self.grid, self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        aux = [torch.zeros((), dtype=F32, device=d) for d in g.devices]
        for lw, flag in zip(layers, transformer.window_flags(cfg)):
            mb = None if mrope is None else \
                mrope.constrain(Spec(None, x.spec[0], None)).blocks
            if remat:
                xb, spec, a = self._remat(
                    lambda w, xs, ms, xspec=x.spec, flag=flag:
                    self.decoder_layer(w, xs, xspec, flag, ms), lw, x.blocks, mb)
            else:
                xb, spec, a = self.decoder_layer(lw, x.blocks, x.spec, flag, mb)
            x = Dist(g, xb, spec)
            aux = [s + t for s, t in zip(aux, a)]
        return x, [a / cfg.n_layers for a in aux]

    # -- the encoder-decoder family --

    def _enc_layer(self, lw: dict, x: Dist) -> Dist:
        h = self._normed(lw["norm1"], x)
        w = self.gather(lw["attn"], keep=self.attn_tp)
        out = self._tp_out(self._map(lambda c, t: encdec.enc_attn(w[c], self.cfg_attn, t),
                                     h.blocks), self.attn_tp)
        x = self._residual(x, out, h.spec)
        return self._mlp_residual(lw, x)

    def _mlp_residual(self, lw: dict, x: Dist) -> Dist:
        h = self._normed(lw["norm2"], x)
        w = self.gather(lw["mlp"], keep=self.mlp_tp)
        out = self._tp_out(self._map(lambda c, t: L.mlp(w[c], t), h.blocks), self.mlp_tp)
        return self._residual(x, out, h.spec)

    def dec_layer(self, lw: dict, xb: list, xspec, enc: list):
        g = self.grid
        x = Dist(g, xb, xspec)
        h = self._normed(lw["norm1"], x)
        w = self.gather(lw["attn"], keep=self.attn_tp)
        out = self._tp_out(self._map(lambda c, t: L.gqa_attn(w[c], self.cfg_attn, t, window=None),
                                     h.blocks), self.attn_tp)
        x = self._residual(x, out, h.spec)
        h = self._normed(lw["norm_x"], x)
        w = self.gather(lw["xattn"], keep=self.xattn_tp)

        def cross(c, t):
            k, v = encdec.cross_kv(w[c], self.cfg_xattn, enc[c])
            return encdec.cross_attn(w[c], self.cfg_xattn, t, k, v)
        out = self._tp_out(self._map(cross, h.blocks), self.xattn_tp)
        x = self._residual(x, out, h.spec)
        x = self._mlp_residual(lw, x)
        return x.blocks, x.spec

    def encode_audio(self, p: dict, frames: Dist) -> list:
        cfg = self.cfg
        pos = torch.from_numpy(encdec.sinusoid_pos(cfg.enc_ctx, cfg.d_model))
        x = Dist(self.grid, self._map(
            lambda c, f: f.to(cfg.cdtype) + pos.to(device=f.device, dtype=cfg.cdtype)[None],
            frames.blocks), frames.spec)
        for lw in p["enc_layers"]:
            x = hint(self._enc_layer(lw, x), "act")
        x = x.constrain(Spec(x.spec[0], None, None))
        n = self.gather({"n": p["enc_norm"]})
        return self._map(lambda c, t: L.rmsnorm(n[c]["n"], t), x.blocks), x.spec

    def run_decoder(self, p: dict, x: Dist, enc: list, enc_spec) -> Dist:
        remat = self.cfg.remat and torch.is_grad_enabled()
        enc = Dist(self.grid, enc, enc_spec).constrain(Spec(x.spec[0], None, None)).blocks
        for lw in p["dec_layers"]:
            if remat:
                xb, spec = self._remat(lambda w, xs, es, xspec=x.spec:
                                       self.dec_layer(w, xs, xspec, es), lw, x.blocks, enc)
            else:
                xb, spec = self.dec_layer(lw, x.blocks, x.spec, enc)
            x = hint(Dist(self.grid, xb, spec), "act")
        return x

    # -- forward and loss --

    def forward(self, p: dict, batch: dict):
        """``model.forward``: (logits ``Dist``, each position's aux loss)."""
        g, cfg = self.grid, self.cfg
        x = self.embed(p["embed"], batch["tokens"])
        if cfg.family == "encdec":
            enc, enc_spec = self.encode_audio(p, batch["enc_frames"])
            x = self.run_decoder(p, x, enc, enc_spec)
            aux = [torch.zeros((), dtype=F32, device=d) for d in g.devices]
        else:
            x, aux = self.run_stack(p["layers"], x, batch.get("mrope_pos"))
        return self.logits(p, x), aux

    def loss(self, p: dict, batch: dict) -> list[dict]:
        """``model.loss_fn``'s metrics at every position (the same values
        everywhere): cross entropy over vocab-sharded logits, the z-loss and
        the aux loss, each over the global batch."""
        g, cfg = self.grid, self.cfg
        logits, aux = self.forward(p, batch)
        bax, vax = logits.axes(0), logits.axes(2)
        labels = batch["labels"].constrain(Spec(logits.spec[0], None)).blocks
        labels = [t.to(torch.int64) for t in labels]
        masks = [(t >= 0).to(F32) for t in labels]
        vl = logits.blocks[0].shape[-1]
        if g.size(vax) > 1:
            mx = g.all_max([torch.amax(t, dim=-1).detach() for t in logits.blocks], vax)
            se = g.all_reduce([torch.sum(torch.exp(t - m[..., None]), dim=-1)
                               for t, m in zip(logits.blocks, mx)], vax)
            lse = [torch.log(s) + m for s, m in zip(se, mx)]

            def pick(c, t, lab):
                loc = lab - g.rank(c, vax) * vl
                ok = (loc >= 0) & (loc < vl)
                got = torch.gather(t, -1, torch.clamp(loc, 0, vl - 1)[..., None])[..., 0]
                return torch.where(ok, got, torch.zeros((), dtype=F32, device=t.device))
            picked = g.all_reduce(self._map(pick, logits.blocks, labels), vax)
        else:
            lse = [torch.logsumexp(t, dim=-1) for t in logits.blocks]
            picked = [torch.gather(t, -1, torch.clamp(lab, min=0)[..., None])[..., 0]
                      for t, lab in zip(logits.blocks, labels)]
        with torch.no_grad():
            tokens = g.all_reduce([m.sum() for m in masks], bax)
        nll = g.all_reduce([((s - q) * m).sum() for s, q, m in zip(lse, picked, masks)], bax)
        zsq = g.all_reduce([(torch.square(s) * m).sum() for s, m in zip(lse, masks)], bax)
        out = []
        for c in range(g.n):
            denom = torch.clamp(tokens[c], min=1.0)
            ce = nll[c] / denom
            zl = cfg.z_loss * zsq[c] / denom
            total = ce + zl + cfg.aux_loss_weight * aux[c]
            out.append({"loss": total, "ce": ce, "z_loss": zl, "aux": aux[c],
                        "tokens": tokens[c]})
        return out


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _inputs(params: dict, cast_ndim: int = 2):
    """The step's view of a params tree of ``ShardedTensor``s: the same tree
    with a stacked top (``layers``, ...) as a list of per-layer trees, each
    leaf a ``_Leaf`` whose blocks are fresh autograd leaves (views of the
    stored blocks); and the list of (ShardedTensor, layer, blocks) that the
    gradients come back to."""
    slots = []

    def leaf(st: sharding.ShardedTensor, layer=None):
        views = [b.detach() if layer is None else b.detach()[layer] for b in st.shards]
        views = [v.requires_grad_(True) for v in views]
        slots.append((st, layer, views))
        spec = st.placement.spec if layer is None else Spec(*st.placement.spec[1:])
        shape = st.shape if layer is None else st.shape[1:]
        cast = st.dtype.is_floating_point and st.ndim >= cast_ndim
        return _Leaf(views, spec, shape, cast)

    tree = {}
    for top, sub in params.items():
        if top in sharding.STACKED_TOPS:
            n_layers = _first(sub).shape[0]
            tree[top] = [_tree_map(lambda st, i=i: leaf(st, i), sub) for i in range(n_layers)]
        else:
            tree[top] = _tree_map(leaf, sub)
    return tree, slots


def _first(tree):
    return _first(next(iter(tree.values()))) if isinstance(tree, dict) else tree


def build_sharded_train_step(cfg, ocfg: adamw.OptConfig, mesh, layout: str = "2d"):
    """``steps.build_train_step`` over a mesh: ``train_step(params,
    opt_state, batch)`` with params and optimizer state as trees of
    ``ShardedTensor``s laid out by ``sharding.state_shardings(..., layout)``
    and a batch of global tensors (or ``ShardedTensor``s) split by
    ``sharding.batch_specs``. Updates the blocks in place and returns
    (params, opt_state, metrics), the metrics those of the one-device step.
    ``train_step.ledger`` holds the collectives of the last call."""
    model = ShardedModel(cfg, mesh, layout)
    grid = model.grid
    bspecs = sharding.batch_specs(cfg, mesh, layout)

    def train_step(params, opt_state, batch):
        grid.ledger.clear()
        dist = {k: distribute(grid, v, bspecs[k]) for k, v in batch.items()}
        tree, slots = _inputs(params)
        metrics = model.loss(tree, dist)
        flat = torch.autograd.grad(metrics[0]["loss"], [v for _, _, vs in slots for v in vs])
        grads: dict[int, list] = {}
        it = iter(flat)
        for st, layer, views in slots:
            got = [next(it) for _ in views]
            if layer is None:
                grads[id(st)] = got
            else:
                grads.setdefault(id(st), []).append(got)
        del flat, tree, slots
        for key, got in grads.items():
            if got and isinstance(got[0], list):     # per layer -> stacked blocks
                grads[key] = [torch.stack([layer[c] for layer in got]) for c in range(grid.n)]
        gtree = _tree_map(lambda st: grads.pop(id(st)), params)
        params, opt_state, om = adamw.apply_update_sharded(params, gtree, opt_state, ocfg, grid)
        out = {k: v.detach() for k, v in metrics[0].items()}
        out.update(om)
        return params, opt_state, out

    train_step.ledger = grid.ledger
    return train_step
