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
* ``build_sharded_prefill_step`` / ``build_sharded_serve_step`` are
  ``steps.build_prefill_step`` / ``build_serve_step`` over the mesh, the
  caches ``ShardedTensor``s laid out by ``sharding.cache_specs`` (K/V split
  on the sequence over ``model``; see ``ShardedModel._attn_decode``).
  ``layer_program`` runs one layer on its own, as the cost model
  (``repro_torch.launch.cost_model``) counts one.

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
from repro_torch.models import model as model_lib
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

    @torch.no_grad()
    def all_to_all(self, xs, axes, split_dim: int, cat_dim: int) -> list[torch.Tensor]:
        """Each group exchanges parts: member i gets the i-th part along
        ``split_dim`` of every member's block, joined along ``cat_dim`` in
        member order. A dim split over ``axes`` at ``cat_dim`` becomes split
        at ``split_dim`` (no gradient)."""
        if self.size(axes) == 1:
            return list(xs)
        out = [None] * self.n
        for g in self.groups(axes):
            size = xs[g[0]].shape[split_dim] // len(g)
            for i, q in enumerate(g):
                dev = self.devices[q]
                out[q] = torch.cat([xs[p].narrow(split_dim, i * size, size).to(dev) for p in g],
                                   cat_dim)
        self.ledger.add("all-to-all", out[0], self.size(axes))
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

    def sharded(self) -> sharding.ShardedTensor:
        """The blocks as a ``ShardedTensor`` of the global tensor they make
        up (each position keeps its block)."""
        g, b = self.grid, self.blocks[0]
        shape = tuple(d * g.size(spec_axes(e)) for d, e in zip(b.shape, self.spec))
        blocks = [t if t.untyped_storage().nbytes() == t.numel() * t.element_size() else
                  _own(t, dev) for t, dev in zip(self.blocks, g.devices)]
        return sharding.ShardedTensor(Placement(g.mesh, self.spec), shape, b.dtype, blocks)


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
        if plan.n_gather == 1:
            return tuple(b.view_as(b) for b in blocks)
        out = [None] * g.n
        for c in range(g.n):
            if out[c] is not None:
                continue
            # the group's members hold the same region: assemble it once,
            # then each other member gets its copy
            t = torch.empty(plan.shapes[c], dtype=blocks[c].dtype, device=g.devices[c])
            for q in plan.members[c]:
                t[plan.inner[q]] = blocks[q].to(t.device)
            for q in plan.members[c]:
                out[q] = t if q == c else _own(t, g.devices[q])
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


def _f32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of compute-dtype operands in float32: the products are
    exact and the sum is float32, as inside a bfloat16 GEMM, but left
    unrounded."""
    return a.to(F32) @ w.to(F32)


def _tree_map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


_SEQ_KEYS = frozenset(model_lib._PAD_SEQ_KEYS)   # cache leaves with a sequence axis


def _pad_seq(t: torch.Tensor, length: int) -> torch.Tensor:
    """t (B, S, ...) zero-padded along S to ``length``."""
    return torch.cat([t, t.new_zeros((t.shape[0], length - t.shape[1]) + tuple(t.shape[2:]))], 1)


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

    def __init__(self, cfg, mesh, layout: str = "2d", f32_sums: bool = False):
        self.cfg = cfg
        self.grid = Grid(mesh)
        self.layout = layout
        self.f32_sums = f32_sums
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

    def _proj(self, tp: bool):
        """The output projection of a sublayer (``L.out_proj``): with
        ``f32_sums`` a tensor-parallel position's row-parallel partial
        product is taken in float32, so the partial sums are added before
        the one rounding to the compute dtype, as one device's GEMM rounds
        its whole sum once."""
        return _f32_product if tp and self.f32_sums else None

    def _tp_out(self, out: list, tp: bool) -> list:
        if not tp:
            return out
        out = self.grid.all_reduce(out, MODEL)
        return [t.to(self.cfg.cdtype) for t in out] if self.f32_sums else out

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

    def _moe(self, lw: dict, h: Dist, with_aux: bool = True) -> tuple[list, list]:
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
        if not with_aux:        # serving: the balancing loss is never read
            return outs, None
        bax = h.axes(0)
        nb = g.size(bax)
        fs, ps = g.all_reduce(fs, bax), g.all_reduce(ps, bax)
        aux = [cfg.n_experts * torch.sum((f / nb) * (pe / nb)) for f, pe in zip(fs, ps)]
        return outs, aux

    def _mixer(self, lw: dict, h: Dist, flag: bool, mrope, cache: dict | None) -> list:
        """The sequence-mixing sublayer of normed h: its output blocks (whole
        over ``model``). With ``cache`` (a dict) the layer's prefill cache is
        recorded there, each leaf a ``Dist`` in the layout it was computed
        in (GQA K/V split on heads where the attention is tensor parallel)."""
        g, cfg = self.grid, self.cfg
        bspec = Spec(h.spec[0])
        if cfg.family == "ssm":
            w = self.gather(lw["time"])
            res = self._map(lambda c, t: ssm_lib.rwkv_time_forward(
                w[c], cfg, t, return_state=cache is not None), h.blocks)
            if cache is None:
                return res
            cache["time"] = {k: Dist(g, [st[k] for _, st in res], bspec)
                             for k in ("state", "x_prev")}
            return [o for o, _ in res]
        w = self.gather(lw["attn"], keep=self.attn_tp)
        res = self._map(lambda c, t: transformer._attn(
            {"attn": w[c]}, self.cfg_attn, t, flag, None if mrope is None else mrope[c],
            cache is not None, self._proj(self.attn_tp)), h.blocks)
        if cache is not None:
            heads = "model" if self.attn_tp and not cfg.mla else None
            for k in res[0][1]:
                cache[k] = Dist(g, [kv[k] for _, kv in res], Spec(h.spec[0], None, heads))
            res = [o for o, _ in res]
        out = self._tp_out(res, self.attn_tp)
        if cfg.family == "hybrid":
            wm = self.gather(lw["mamba"])
            nm = self.gather({k: lw[k] for k in ("attn_out_norm", "mamba_out_norm")})
            mam = self._map(lambda c, t: ssm_lib.mamba_forward(
                wm[c], cfg, t, return_state=cache is not None), h.blocks)
            if cache is not None:
                cache["mamba"] = {k: Dist(g, [st[k] for _, st in mam], bspec)
                                  for k in ("state", "conv")}
                mam = [m for m, _ in mam]
            out = self._map(lambda c, a, m: transformer._hybrid_mix(nm[c], a, m), out, mam)
        return out

    def _ffn(self, lw: dict, h: Dist, with_aux: bool = True) -> tuple[list, list]:
        """The feed-forward sublayer of normed h: output blocks (whole over
        ``model``) and each position's aux loss (None without ``with_aux``)."""
        g, cfg = self.grid, self.cfg
        if cfg.family == "moe":
            return self._moe(lw["moe"], h, with_aux)
        if cfg.family == "ssm":
            w = self.gather(lw["chan"])
            out = self._map(lambda c, t: ssm_lib.rwkv_channel_forward(
                w[c], t, ssm_lib._shift(t)), h.blocks)
        else:
            w = self.gather(lw["mlp"], keep=self.mlp_tp)
            proj = self._proj(self.mlp_tp)
            out = self._tp_out(self._map(lambda c, t: L.mlp(w[c], t, proj), h.blocks),
                               self.mlp_tp)
        aux = [torch.zeros((), dtype=F32, device=d) for d in g.devices] if with_aux else None
        return out, aux

    def decoder_layer(self, lw: dict, xb: list, xspec, flag: bool, mrope, cache=None):
        """``transformer.decoder_layer`` over the mesh: returns the output
        blocks, their spec and each position's aux loss. With ``cache`` (a
        dict) it is ``decoder_layer_prefill``: the layer's cache is recorded
        there (``_mixer``)."""
        g, cfg = self.grid, self.cfg
        x = Dist(g, xb, xspec)
        h = self._normed(lw["norm1"], x)
        out = self._mixer(lw, h, flag, mrope, cache)
        x = hint(self._residual(x, out, h.spec), "act")
        h = self._normed(lw["norm2"], x)
        out, aux = self._ffn(lw, h, with_aux=cache is None)
        if cache is not None and cfg.family == "ssm":
            cache["chan_x_prev"] = Dist(g, [t[:, -1:] for t in h.blocks], Spec(h.spec[0]))
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
        proj = self._proj(self.attn_tp)
        out = self._tp_out(self._map(lambda c, t: encdec.enc_attn(w[c], self.cfg_attn, t, proj),
                                     h.blocks), self.attn_tp)
        x = self._residual(x, out, h.spec)
        return self._mlp_residual(lw, x)

    def _mlp_residual(self, lw: dict, x: Dist) -> Dist:
        h = self._normed(lw["norm2"], x)
        w = self.gather(lw["mlp"], keep=self.mlp_tp)
        proj = self._proj(self.mlp_tp)
        out = self._tp_out(self._map(lambda c, t: L.mlp(w[c], t, proj), h.blocks), self.mlp_tp)
        return self._residual(x, out, h.spec)

    def dec_layer(self, lw: dict, xb: list, xspec, enc: list, cache: dict | None = None):
        """``encdec._dec_layer`` (cross K/V from ``enc``) over the mesh; with
        ``cache`` (a dict) the layer's decode cache (self-attention K/V,
        cross K/V) is recorded there as ``Dist``s."""
        g = self.grid
        x = Dist(g, xb, xspec)
        h = self._normed(lw["norm1"], x)
        w = self.gather(lw["attn"], keep=self.attn_tp)
        proj = self._proj(self.attn_tp)
        res = self._map(lambda c, t: L.gqa_attn(w[c], self.cfg_attn, t, window=None,
                                                return_kv=cache is not None, proj=proj), h.blocks)
        if cache is not None:
            heads = Spec(h.spec[0], None, "model" if self.attn_tp else None)
            for k in ("k", "v"):
                cache[k] = Dist(g, [kv[k] for _, kv in res], heads)
            res = [o for o, _ in res]
        out = self._tp_out(res, self.attn_tp)
        x = self._residual(x, out, h.spec)
        h = self._normed(lw["norm_x"], x)
        w = self.gather(lw["xattn"], keep=self.xattn_tp)
        kvs = self._map(lambda c, e: encdec.cross_kv(w[c], self.cfg_xattn, e), enc)
        if cache is not None:
            heads = Spec(h.spec[0], None, "model" if self.xattn_tp else None)
            cache["xk"] = Dist(g, [k for k, _ in kvs], heads)
            cache["xv"] = Dist(g, [v for _, v in kvs], heads)
        proj = self._proj(self.xattn_tp)
        out = self._tp_out(self._map(lambda c, t: encdec.cross_attn(w[c], self.cfg_xattn, t,
                                                                     *kvs[c], proj), h.blocks),
                           self.xattn_tp)
        x = self._residual(x, out, h.spec)
        x = self._mlp_residual(lw, x)
        return x.blocks, x.spec

    def encode_audio(self, p: dict, frames: Dist) -> list:
        cfg = self.cfg
        pos = torch.from_numpy(encdec.sinusoid_pos(cfg.enc_ctx, cfg.d_model))
        x = Dist(self.grid, self._map(
            lambda c, f: f.to(cfg.cdtype) + pos.to(f.device).to(cfg.cdtype)[None],
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


    # -- serving: prefill and decode --

    def _logits2d(self, p: dict, x: Dist) -> Dist:
        """The logits (B, V) of a (B, 1, D) hidden state."""
        lg = self.logits(p, x)
        return hint(Dist(self.grid, [t[:, 0] for t in lg.blocks], Spec(lg.spec[0], lg.spec[2])),
                    "logits2d")

    def argmax(self, logits: Dist) -> Dist:
        """The greedy next token (B, 1) int32 of vocab-split logits (B, V):
        the first index of the row maximum, as ``torch.argmax`` picks it (an
        all-max of the row maxima, then of each split's negated first index
        at that maximum)."""
        g = self.grid
        vax = logits.axes(1)
        spec = Spec(logits.spec[0], None)
        if g.size(vax) == 1:
            return Dist(g, [torch.argmax(t, -1).to(torch.int32)[:, None] for t in logits.blocks],
                        spec)
        vl = logits.blocks[0].shape[-1]
        rows = [t.amax(-1) for t in logits.blocks]
        top = g.all_max(rows, vax)
        first = [torch.where(r == m, torch.argmax(t, -1) + g.rank(c, vax) * vl, vl * g.size(vax))
                 for c, (t, r, m) in enumerate(zip(logits.blocks, rows, top))]
        best = g.all_max([-f for f in first], vax)
        return Dist(g, [(-b).to(torch.int32)[:, None] for b in best], spec)

    def cache_like(self, batch: int, seq: int) -> dict:
        """A zero decode cache of ``batch`` x ``seq`` positions: the tree of
        ``model.init_cache`` as ``ShardedTensor``s laid out by
        ``sharding.cache_specs``."""
        g = self.grid
        like = model_lib.init_cache(self.cfg, batch, seq, device="meta")
        specs = sharding.cache_specs(self.cfg, g.mesh, like, self.layout)

        def zeros(t, spec):
            place = Placement(g.mesh, spec)
            shards = [torch.zeros(tuple(b.stop - b.start for b in blk), dtype=t.dtype, device=dev)
                      for blk, dev in zip(sharding._blocks(tuple(t.shape), place), g.devices)]
            return sharding.ShardedTensor(place, t.shape, t.dtype, shards)
        return _tree_map2(zeros, like, specs)

    def _cache_blocks(self, d: Dist, want: Spec) -> list:
        """A cache leaf computed as ``d``, laid out by ``want`` (a
        ``cache_specs`` spec without its L entry). Where ``d`` is split on
        one dim over ``model`` (K/V on heads) and ``want`` splits another
        over it (the sequence), the split moves by an all-to-all, after the
        sequence is sliced over the axes before ``model`` (the whole mesh at
        batch 1); any other dim is sliced or gathered (``Dist.constrain``)."""
        g = self.grid
        src = [i for i, e in enumerate(d.spec) if "model" in spec_axes(e)]
        dst = [i for i, e in enumerate(want) if "model" in spec_axes(e)]
        if src and dst and src != dst:
            i, j = src[0], dst[0]
            pre = tuple(a for a in spec_axes(want[j]) if a != "model")
            entries = list(d.spec)
            entries[j] = pre or None
            d = d.constrain(Spec(*entries))
            entries[i], entries[j] = None, pre + ("model",)
            d = Dist(g, g.all_to_all(d.blocks, MODEL, j, i), Spec(*entries))
        return d.constrain(want).blocks

    def _write_cache(self, cache: dict, layer: dict, i: int) -> None:
        """Layer ``i``'s prefill cache (``Dist``s, ``_mixer``) into the
        stacked cache's blocks, K/V and latents zero-padded along the
        sequence to the cache's length."""
        for k, d in layer.items():
            if isinstance(d, dict):
                self._write_cache(cache[k], d, i)
                continue
            st = cache[k]
            if k in _SEQ_KEYS and d.blocks[0].shape[1] < st.shape[2]:
                d = Dist(self.grid, [_pad_seq(t, st.shape[2]) for t in d.blocks], d.spec)
            for shard, b in zip(st.shards, self._cache_blocks(d, Spec(*st.placement.spec[1:]))):
                shard[i].copy_(b)

    def prefill(self, p: dict, inputs: dict, horizon: int | None = None):
        """``model.prefill`` over the mesh: (the last position's logits, a
        ``Dist`` (B, V); the cache, ``cache_like`` of ``horizon`` positions
        (the prompt's by default) holding the prompt's)."""
        g, cfg = self.grid, self.cfg
        tokens = inputs["tokens"]
        x = self.embed(p["embed"], tokens)
        B = x.blocks[0].shape[0] * g.size(x.axes(0))
        cache = self.cache_like(B, horizon or x.blocks[0].shape[1])
        if cfg.family == "encdec":
            enc, enc_spec = self.encode_audio(p, inputs["enc_frames"])
            enc = Dist(g, enc, enc_spec).constrain(Spec(x.spec[0], None, None)).blocks
            for i, lw in enumerate(p["dec_layers"]):
                layer = {}
                xb, spec = self.dec_layer(lw, x.blocks, x.spec, enc, layer)
                x = hint(Dist(g, xb, spec), "act")
                self._write_cache(cache, layer, i)
        else:
            mrope = inputs.get("mrope_pos")
            for i, (lw, flag) in enumerate(zip(p["layers"], transformer.window_flags(cfg))):
                mb = None if mrope is None else \
                    mrope.constrain(Spec(None, x.spec[0], None)).blocks
                layer = {}
                xb, spec, _ = self.decoder_layer(lw, x.blocks, x.spec, flag, mb, layer)
                x = hint(Dist(g, xb, spec), "act")
                self._write_cache(cache, layer, i)
        x = self._whole_seq(x)
        return self._logits2d(p, Dist(g, [t[:, -1:] for t in x.blocks], x.spec)), cache

    def _whole_state(self, leaf: _Leaf) -> list:
        """A recurrent-state leaf's blocks, gathered whole but for the batch."""
        return Dist(self.grid, leaf.blocks, leaf.spec).constrain(Spec(leaf.spec[0])).blocks

    def _store(self, leaf: _Leaf, new: list) -> None:
        """Each position's block of ``new`` (whole but for the batch) copied
        into the leaf's blocks in place."""
        got = Dist(self.grid, new, Spec(leaf.spec[0])).constrain(leaf.spec).blocks
        for b, t in zip(leaf.blocks, got):
            b.copy_(t)

    def _attn_decode(self, lw_attn: dict, h: Dist, lc: dict, pos: int, flag: bool) -> list:
        """One token's attention against the cache's blocks: the output
        blocks, whole over ``model``. Each position attends over its block
        of the sequence, and where the sequence is split (over ``model``, or
        the whole mesh at batch 1) the softmax is combined over the split: an
        all-max of the row maxima, all-reduces of the denominators and of
        the weighted values. Where the heads are tensor parallel the
        queries (MLA: the absorbed queries) and the new K/V are all-gathered
        over ``model`` first, and each position keeps its heads' output for
        the row-parallel ``wo``. The new K/V (MLA: latents) are written by
        the position whose block holds ``pos``."""
        g, cfg = self.grid, self.cfg
        tp = self.attn_tp
        w = self.gather(lw_attn, keep=tp)
        keys = ("c", "k_rope") if cfg.mla else ("k", "v")
        sax = spec_axes(lc[keys[0]].spec[1])
        Sb = lc[keys[0]].blocks[0].shape[1]
        lo = [g.rank(c, sax) * Sb for c in range(g.n)]
        idx = [lo[c] + torch.arange(Sb, device=d) for c, d in enumerate(g.devices)]
        ok = [i <= pos for i in idx]
        if cfg.sliding_window is not None and flag:
            ok = [o & (i > pos - cfg.sliding_window) for o, i in zip(ok, idx)]
        hl = self.cfg_attn.n_heads
        B = h.blocks[0].shape[0]
        dt = h.blocks[0].dtype

        def at(c, t):
            return torch.full((t.shape[0], 1), pos, dtype=torch.int64, device=t.device)

        def write(c, new: dict):
            if lo[c] <= pos < lo[c] + Sb:
                for k in keys:
                    lc[k].blocks[c][:, pos - lo[c]] = new[k][:, 0].to(lc[k].blocks[c].dtype)

        def combine(s: list, values: list, eq: str) -> list:
            s = [torch.where(o, t, L.NEG_INF) for o, t in zip(ok, s)]
            top = g.all_max([t.amax(-1) for t in s], sax)
            e = [torch.exp(t - m[..., None]) for t, m in zip(s, top)]
            den = g.all_reduce([t.sum(-1) for t in e], sax)
            o = g.all_reduce([torch.einsum(eq, t, v) for t, v in zip(e, values)], sax)
            return [a / d[..., None] for a, d in zip(o, den)]

        if cfg.mla:
            kvl, nd, rd, vd = cfg.mla_kv_lora, cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, \
                cfg.mla_v_dim
            qs = self._map(lambda c, t: L._mla_q(w[c], self.cfg_attn, t, at(c, t)), h.blocks)
            for c, t in enumerate(h.blocks):
                cl, kr = L._mla_latents(w[c], self.cfg_attn, t, at(c, t))
                write(c, {"c": cl, "k_rope": kr})
            q_abs = [torch.einsum("bhd,lhd->bhl", qn[:, 0].to(F32),
                                  w[c]["wuk"].reshape(kvl, hl, nd).to(F32))
                     for c, (qn, _) in enumerate(qs)]
            q_rope = [qr[:, 0].to(F32) for _, qr in qs]
            if tp:
                q_abs, q_rope = g.all_gather(q_abs, MODEL, 1), g.all_gather(q_rope, MODEL, 1)
            cb = [b.to(F32) for b in lc["c"].blocks]
            s = [(torch.einsum("bhl,bsl->bhs", qa, cc) +
                  torch.einsum("bhd,bsd->bhs", qr, r.to(F32))) / np.sqrt(nd + rd)
                 for qa, qr, cc, r in zip(q_abs, q_rope, cb, lc["k_rope"].blocks)]
            o_lat = combine(s, cb, "bhs,bsl->bhl")
            if tp:
                o_lat = [t.narrow(1, g.rank(c, MODEL) * hl, hl) for c, t in enumerate(o_lat)]
            out = [torch.einsum("bhl,lhd->bhd", t, w[c]["wuv"].reshape(kvl, hl, vd).to(F32))
                   .reshape(B, 1, hl * vd).to(dt) for c, t in enumerate(o_lat)]
            return self._tp_out([L.out_proj(t, w[c]["wo"], self._proj(tp))
                                 for c, t in enumerate(out)], tp)

        H, Kh, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qkv = self._map(lambda c, t: L.gqa_qkv(w[c], self.cfg_attn, t, at(c, t)), h.blocks)
        q, k, v = ([t[i] for t in qkv] for i in range(3))
        if tp:
            q, k, v = (g.all_gather(z, MODEL, 2) for z in (q, k, v))
        for c in range(g.n):
            write(c, {"k": k[c], "v": v[c]})
        s = [torch.einsum("bkrd,bskd->bkrs", qq.reshape(B, Kh, H // Kh, Dh).to(F32), kb.to(F32))
             / np.sqrt(Dh) for qq, kb in zip(q, lc["k"].blocks)]
        o = combine(s, [vb.to(F32) for vb in lc["v"].blocks], "bkrs,bskd->bkrd")
        o = [t.reshape(B, 1, H, Dh).to(dt) for t in o]
        if tp:
            o = [t.narrow(2, g.rank(c, MODEL) * hl, hl) for c, t in enumerate(o)]
        return self._tp_out([L.out_proj(t.reshape(B, 1, hl * Dh), w[c]["wo"], self._proj(tp))
                             for c, t in enumerate(o)], tp)

    def layer_decode(self, lw: dict, x: Dist, lc: dict, pos: int, flag: bool) -> Dist:
        """``transformer.decoder_layer_decode`` (or whisper's
        ``_dec_layer_decode``) over the mesh: one token through one layer
        against its cache (``_Leaf``s over the blocks of layer ``lc``,
        written in place). Recurrent states are gathered whole but for the
        batch, advanced and written back block by block."""
        g, cfg = self.grid, self.cfg
        h = self._normed(lw["norm1"], x)
        if cfg.family == "ssm":
            w = self.gather(lw["time"])
            st = {k: self._whole_state(lc["time"][k]) for k in ("state", "x_prev")}
            res = self._map(lambda c, t: ssm_lib.rwkv_time_decode(
                w[c], cfg, t, {k: v[c] for k, v in st.items()}), h.blocks)
            for k in st:
                self._store(lc["time"][k], [new[k] for _, new in res])
            x = self._residual(x, [o for o, _ in res], h.spec)
            h = self._normed(lw["norm2"], x)
            w = self.gather(lw["chan"])
            prev = self._whole_state(lc["chan_x_prev"])
            out = self._map(lambda c, t: ssm_lib.rwkv_channel_forward(w[c], t, prev[c]), h.blocks)
            self._store(lc["chan_x_prev"], h.blocks)
            return self._residual(x, out, h.spec)
        mix = self._attn_decode(lw["attn"], h, lc, pos, flag)
        if cfg.family == "hybrid":
            wm = self.gather(lw["mamba"])
            nm = self.gather({k: lw[k] for k in ("attn_out_norm", "mamba_out_norm")})
            st = {k: self._whole_state(lc["mamba"][k]) for k in ("state", "conv")}
            res = self._map(lambda c, t: ssm_lib.mamba_decode(
                wm[c], cfg, t, {k: v[c] for k, v in st.items()}), h.blocks)
            for k in st:
                self._store(lc["mamba"][k], [new[k] for _, new in res])
            mix = self._map(lambda c, a, m: transformer._hybrid_mix(nm[c], a, m[0]), mix, res)
        x = self._residual(x, mix, h.spec)
        if cfg.family == "encdec":
            h = self._normed(lw["norm_x"], x)
            w = self.gather(lw["xattn"], keep=self.xattn_tp)
            proj = self._proj(self.xattn_tp)
            out = self._map(lambda c, t: encdec.cross_attn(
                w[c], self.cfg_xattn, t, lc["xk"].blocks[c], lc["xv"].blocks[c], proj), h.blocks)
            x = self._residual(x, self._tp_out(out, self.xattn_tp), h.spec)
            return self._mlp_residual(lw, x)
        h = self._normed(lw["norm2"], x)
        out, _ = self._ffn(lw, h, with_aux=False)
        return self._residual(x, out, h.spec)

    def decode_step(self, p: dict, cache: dict, token: Dist, pos: int):
        """``model.decode_step`` over the mesh: (logits, a ``Dist`` (B, V);
        the cache, its blocks written in place). ``pos`` is a Python int."""
        cfg = self.cfg
        x = self.embed(p["embed"], token)
        stack = p["dec_layers"] if cfg.family == "encdec" else p["layers"]
        for i, (lw, flag) in enumerate(zip(stack, transformer.window_flags(cfg))):
            lc = _tree_map(lambda st: _Leaf([b[i] for b in st.shards],
                                            Spec(*st.placement.spec[1:]), st.shape[1:], False),
                           cache)
            x = hint(self.layer_decode(lw, x, lc, pos, flag), "act")
        return self._logits2d(p, x), cache


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _inputs(params: dict, cast_ndim: int = 2, grad: bool = True):
    """The step's view of a params tree of ``ShardedTensor``s: the same tree
    with a stacked top (``layers``, ...) as a list of per-layer trees, each
    leaf a ``_Leaf`` whose blocks are views of the stored blocks (with
    ``grad``, fresh autograd leaves); and the list of (ShardedTensor, layer,
    blocks) that the gradients come back to."""
    slots = []

    def leaf(st: sharding.ShardedTensor, layer=None):
        views = [b.detach() if layer is None else b.detach()[layer] for b in st.shards]
        views = [v.requires_grad_(grad) for v in views]
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


def build_sharded_prefill_step(cfg, mesh, layout: str = "2d"):
    """``steps.build_prefill_step`` over a mesh: ``prefill_step(params,
    inputs, horizon=None)`` with params as a tree of ``ShardedTensor``s laid
    out by ``sharding.param_shardings(..., layout)`` (``"2d"``, ``"fsdp"``
    or ``"serve"``: weights stationary, tensor parallel only) and inputs
    global tensors (or ``ShardedTensor``s) split by
    ``sharding.prefill_input_specs``. Returns (the last position's logits, a
    ``ShardedTensor`` (B, V); the cache, ``ShardedTensor``s laid out by
    ``sharding.cache_specs`` over ``horizon`` positions, the prompt's by
    default). ``prefill_step.ledger`` holds the collectives of the last
    call."""
    model = ShardedModel(cfg, mesh, layout, f32_sums=True)
    grid = model.grid

    @torch.no_grad()
    def prefill_step(params, inputs, horizon: int | None = None):
        grid.ledger.clear()
        specs = sharding.prefill_input_specs(cfg, mesh, batch=inputs["tokens"].shape[0],
                                             layout=layout)
        dist = {k: distribute(grid, v, specs[k]) for k, v in inputs.items()}
        tree, _ = _inputs(params, grad=False)
        logits, cache = model.prefill(tree, dist, horizon)
        return logits.sharded(), cache

    prefill_step.ledger = grid.ledger
    prefill_step.model = model
    return prefill_step


def build_sharded_serve_step(cfg, mesh, layout: str = "2d"):
    """``steps.build_serve_step`` over a mesh: ``serve_step(params, cache,
    token, pos)`` -> (next token (B, 1) int32, logits (B, V), cache), the
    first two ``ShardedTensor``s, the cache's blocks written in place. Params
    as for ``build_sharded_prefill_step``, the token a global tensor (or a
    ``ShardedTensor``) split by ``sharding.decode_input_specs``, ``pos`` a
    Python int. ``serve_step.ledger`` holds the collectives of the last
    call."""
    model = ShardedModel(cfg, mesh, layout, f32_sums=True)
    grid = model.grid

    @torch.no_grad()
    def serve_step(params, cache, token, pos: int):
        grid.ledger.clear()
        spec = sharding.decode_input_specs(cfg, mesh, batch=token.shape[0], layout=layout)
        tree, _ = _inputs(params, grad=False)
        logits, cache = model.decode_step(tree, cache, distribute(grid, token, spec["token"]),
                                          int(pos))
        return model.argmax(logits).sharded(), logits.sharded(), cache

    serve_step.ledger = grid.ledger
    serve_step.model = model
    return serve_step


# ---------------------------------------------------------------------------
# one layer on its own: the cost model's standalone programs
# ---------------------------------------------------------------------------

LAYER_KINDS = {"layers": ("fwd", "train", "prefill", "decode"),
               "enc_layers": ("fwd", "train", "prefill"),
               "dec_layers": ("fwd", "train", "prefill", "decode")}


def _place_tree(tree, mesh, specs) -> dict:
    return _tree_map2(lambda t, spec: sharding.shard(t, Placement(mesh, spec)), tree, specs)


def layer_program(cfg, mesh, layout: str, stack: str, kind: str, batch: int, seq: int,
                  use_window: bool = True):
    """One layer of ``stack`` (``"layers"``, or whisper's ``"enc_layers"`` /
    ``"dec_layers"``) run on its own over the mesh, as the JAX package's
    cost model lowers one (``repro.launch.cost_model``): the layer's
    parameters laid out by ``sharding.layer_param_specs`` (a stack of one,
    made from seed 0 on the mesh's first device, shapes only on ``meta``),
    its (batch, seq, d_model) input split over the data axes (whole where
    they do not divide the batch; whisper's decoder layer also takes the
    (batch, enc_ctx, d_model) encoder states so). ``kind``:

    * ``fwd``: the layer's forward;
    * ``train``: forward and backward of the sum of its output blocks (and
      the aux loss), no remat: the gradients land on the parameter blocks
      through ``_Gather``'s backward and on the input blocks;
    * ``prefill``: the forward that also writes the layer's cache, laid out
      by ``sharding.cache_specs`` (the whisper encoder's is the forward);
    * ``decode``: one token at position ``seq - 1`` against a cache of
      ``seq`` positions.

    ``prefill`` and ``decode`` take the serving numerics
    (``ShardedModel(f32_sums=True)``, as the serving builders do).

    Returns ``run()``, which runs the layer once and returns the ledger's
    records; what ``run`` reads is made before it is called."""
    if kind not in LAYER_KINDS[stack]:
        raise ValueError(f"{stack} has no {kind!r} program")
    encdec_stack = stack != "layers"
    cfg = dataclasses.replace(cfg, n_layers=1, global_layers=(),
                              **({"enc_layers": 1} if encdec_stack else {}))
    dev = mesh.flat[0]
    gen = model_lib._MetaGenerator() if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(0)
    layer = (encdec.encdec_init(gen, cfg, cfg.pdtype) if encdec_stack else
             {"layers": transformer.stack_init(gen, cfg, cfg.pdtype)})[stack]
    params = _place_tree(layer, mesh, sharding.param_specs(cfg, mesh, {stack: layer},
                                                           layout)[stack])
    model = ShardedModel(cfg, mesh, layout, f32_sums=kind in ("prefill", "decode"))
    grid = model.grid
    dp = sharding.data_axes(mesh, layout)
    if batch % grid.size(dp):
        dp = None                        # batch-1 cells stay replicated
    train = kind == "train"
    writes = kind == "prefill" and stack != "enc_layers"

    def activations(n: int) -> Dist:
        shape = (batch, n, cfg.d_model)
        x = torch.zeros(shape, dtype=cfg.cdtype, device=dev) if dev.type == "meta" else \
            torch.randn(shape, generator=gen, device=dev).to(cfg.cdtype)
        d = distribute(grid, x, Spec(dp, None, None))
        for b in d.blocks:
            b.requires_grad_(train)
        return d

    x = activations(1 if kind == "decode" else cfg.enc_ctx if stack == "enc_layers" else seq)
    enc = activations(cfg.enc_ctx) if stack == "dec_layers" and kind != "decode" else None
    cache = model.cache_like(batch, seq) if kind == "decode" else None

    def forward(lw, layer_cache):
        if stack == "enc_layers":
            return model._enc_layer(lw, x).blocks, []
        if stack == "dec_layers":
            if kind == "decode":
                return model.layer_decode(lw, x, layer_cache, seq - 1, False).blocks, []
            return model.dec_layer(lw, x.blocks, x.spec, enc.blocks, layer_cache)[0], []
        if kind == "decode":
            return model.layer_decode(lw, x, layer_cache, seq - 1, use_window).blocks, []
        out, _, aux = model.decoder_layer(lw, x.blocks, x.spec, use_window, None, layer_cache)
        return out, aux[:1] if aux else []

    def run() -> list:
        grid.ledger.clear()
        with torch.set_grad_enabled(train):
            tree, slots = _inputs({stack: params}, grad=train)
            lw = tree[stack][0]
            if kind == "decode":
                layer_cache = _tree_map(lambda st: _Leaf([b[0] for b in st.shards], Spec(
                    *st.placement.spec[1:]), st.shape[1:], False), cache)
            else:
                layer_cache = {} if writes else None
            outs, aux = forward(lw, layer_cache)
            if writes:
                model._write_cache(model.cache_like(batch, seq), layer_cache, 0)
            if train:
                wrt = [v for _, _, vs in slots for v in vs] + x.blocks + \
                    (enc.blocks if enc is not None else [])
                ys = [y for y in outs + aux if y.requires_grad]
                torch.autograd.grad(ys, wrt, [torch.ones_like(y) for y in ys], allow_unused=True)
        return list(grid.ledger.records)

    return run
