"""Corrected per-step cost accounting (FLOPs / bytes accessed / collective
bytes), per device.

The JAX package's ``repro.launch.cost_model`` on the port. The JAX package
compiles each step with its production shardings and reads XLA's cost
analysis, which counts a ``while`` body once, so it composes the true cost
from loop-free compiles:

  corrected = cost(full program with n_layers=1)
            + (L-1) * cost(one standalone layer)
            [+ (enc_L-1) * cost(one encoder layer)  for enc-dec]
            [+ (L-1) * cost(one layer forward)      when remat recomputes]

The port has no compiler: a program is counted by running it once on a mesh
(``["meta"] * n`` for the production meshes: shapes, no data), per op, with

* **flops**: ``torch.utils.flop_counter``'s count (``FlopCounterMode``'s
  formulas, ``OpCounter``) over every position, divided by the positions.
  It counts matrix products (``mm``, ``bmm`` and the einsums they carry,
  hence attention), convolutions and fused attention only, not elementwise
  work, where XLA counts every op;
* **hbm_bytes**: "bytes accessed", ``OpCounter``: the input and output bytes
  of every dispatched op that is not a view, a bare allocation or an upload
  of a host constant, divided by the positions. This is the eager, unfused count; the analytic
  ``repro_torch.launch.traffic_model`` stays the fused lower bound;
* **coll_bytes**: ``hlo.collective_bytes`` over the ledger of collectives
  the sharded program ran (``repro_torch.train.spmd``), per device.

Eager torch has no loop that a counter counts once, so the correction is not
needed for the count to be right: the full-depth program gives the same
numbers (``tests/test_torch_cost_model.py`` holds the two within 1%). It is
kept for time: on a meta mesh the ops, not their sizes, set the wall (a
meta elementwise op runs through a Python decomposition, about 170 us), and
a one-layer train program of qwen3-1.7b on the 16 x 16 production mesh runs
for 35-40 s, so all L layers would take L times that. The composition keeps
a cell to a few programs. The standalone layer runs on the SAME mesh with
the same parameter, activation and cache layouts (``spmd.layer_program``),
so its collectives (FSDP all-gathers, tensor-parallel reduces) scale too.

The FLOP count at accounting tiles is an upper bound. The port's chunked
attention computes the masked part of each diagonal tile, so a larger tile
counts more masked work: a one-layer qwen3-1.7b train step on 4 x 4 counted
2.4679e15 FLOPs with the production 512-token tiles and 2.5206e15 (+2.1%)
with the 4096-token accounting tiles (the JAX docstring calls its count
tile-invariant; XLA's is not the port's).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import hints as hints_lib
from repro_torch.configs import shapes as shapes_lib
from repro_torch.launch import hlo as hlo_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import sharding, spmd


def _accounting_cfg(cfg, seq: int):
    """Accounting-only chunk override: larger attention tiles make fewer
    ops, and a meta run's wall is its op count. Use 4k tiles for the cost
    programs (an upper bound on the FLOPs, see the module docstring); HBM
    traffic (which IS tile-dependent via K/V re-reads) comes from the
    analytic traffic model with the REAL chunk sizes. ``ssm_chunk`` is NOT
    overridden: intra-chunk SSD/WKV work scales with the chunk length, so it
    must stay at the production value.

    Sliding-window configs cap the accounting tile at 1024 so the banded
    fast path still engages (window + tile < S); its flops ARE
    tile-dependent (band width = window + q_chunk), so the 1024-tile
    numbers are a slightly conservative upper bound on the production
    512-tile cost."""
    tile = max(cfg.q_chunk, min(4096, seq))
    if cfg.sliding_window is not None:
        tile = max(cfg.q_chunk, min(1024, seq))
    return dataclasses.replace(cfg, q_chunk=tile, kv_chunk=tile)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.hbm_bytes + o.hbm_bytes,
                    self.coll_bytes + o.coll_bytes)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.hbm_bytes * k, self.coll_bytes * k)

    __rmul__ = __mul__

    def to_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "coll_bytes": self.coll_bytes}


# ---------------------------------------------------------------------------
# counting a run
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
_ALLOCATE = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
             _aten.new_empty.default, _aten.new_empty_strided.default}
_COPIES = {_aten._to_copy.default, _aten.copy_.default}
# elementwise transcendentals, counted per output element as XLA counts them
_TRANSCENDENTAL = {_aten.exp, _aten.log, _aten.log1p, _aten.expm1, _aten.tanh, _aten.sigmoid,
                   _aten.rsqrt, _aten.sqrt, _aten.sin, _aten.cos, _aten.pow, _aten.erf}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors among an op's arguments or results (flat, or in lists)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _uploads(func, args, outs) -> bool:
    """A copy from the host to another device: a constant made on the host
    (RoPE frequencies, sinusoid positions) going to the positions' device.
    A mesh of CPU positions has none, so such copies are not counted."""
    src = args[1] if func is _aten.copy_.default else args[0]
    return src.device.type == "cpu" and outs[0].device.type != "cpu"


class OpCounter(TorchDispatchMode):
    """What a run dispatches, op by op: ``flops``, by
    ``torch.utils.flop_counter``'s formulas (``flop_registry``, what
    ``FlopCounterMode`` applies to each op it sees); ``transcendentals``,
    the output elements of exp, log, tanh, rsqrt and the like; ``bytes``, the input
    and output bytes of every op that is not a view, a bare allocation or
    an upload from the host (bytes accessed, unfused); ``live`` and ``peak``, the bytes of the
    storages the ops create while they are alive, above ``start`` (what was
    live before), and their largest value. One mode for all three: a second
    mode (``FlopCounterMode`` itself) would add 40% to a meta run's wall."""

    def __init__(self, start: int = 0):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.live = self.peak = start
        self._seen: set[int] = set()
        self._kind: dict = {}

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _kind_of(self, func) -> tuple[bool, bool, bool]:
        """(a view, a bare allocation, returns fresh storage)."""
        kind = self._kind.get(func)
        if kind is None:
            kind = self._kind[func] = (
                func.is_view, func in _ALLOCATE,
                all(r.alias_info is None for r in func._schema.returns))
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        view, alloc, fresh = self._kind_of(func)
        if view:
            return out
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        elif packet in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        outs = list(_tensors(out))
        if func in _COPIES and _uploads(func, args, outs):
            alloc = True                    # host constants are no device work
        if not alloc:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
                sum(_nbytes(t) for t in outs)
        if fresh:
            for t in outs:
                st = t.untyped_storage()
                key = id(st)
                if key not in self._seen:
                    n = st.nbytes()
                    self._seen.add(key)
                    self.live += n
                    weakref.finalize(st, self._free, key, n)
            self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass
class Measured:
    """One counted run: its per-device ``cost``, the ledger's collective
    stats, the counter (bytes, live peak) and the run's return value."""
    cost: Cost
    coll: hlo_lib.CollectiveStats
    counter: OpCounter
    out: object


def measure(run, mesh, start: int = 0) -> Measured:
    """Run ``run()`` (which returns ``(out, ledger records)``) once under
    the counters; per-device FLOPs and bytes are the totals over the mesh's
    positions divided by their number."""
    counter = OpCounter(start)
    with counter:
        out, records = run()
    coll = hlo_lib.collective_bytes(records)
    n = mesh.size
    return Measured(Cost(counter.flops / n, counter.bytes / n, coll.total_bytes),
                    coll, counter, out)


def _hinted(run, mesh, batch: int, layout: str):
    """``run`` with the activation hints of this mesh, batch and layout
    installed for its duration (the caller's after it)."""
    def hinted():
        with hints_lib.hints_installed({}):
            sharding.set_activation_hints(mesh, batch=batch, layout=layout)
            return run()
    return hinted


def _layer_cost(cfg, mesh, layout, stack, kind, batch, seq, use_window=True) -> Cost:
    run = spmd.layer_program(cfg, mesh, layout, stack, kind, batch, seq, use_window)
    return measure(_hinted(lambda: (None, run()), mesh, batch, layout), mesh).cost


# ---------------------------------------------------------------------------
# standalone layer costs
# ---------------------------------------------------------------------------


def layer_fwd_cost(cfg, mesh, batch: int, seq: int, use_window: bool = True,
                   layout: str = "2d") -> Cost:
    return _layer_cost(cfg, mesh, layout, "layers", "fwd", batch, seq, use_window)


def layer_train_cost(cfg, mesh, batch: int, seq: int, use_window: bool = True,
                     layout: str = "2d") -> Cost:
    """fwd + bwd of one layer (add layer_fwd_cost once more if remat)."""
    return _layer_cost(cfg, mesh, layout, "layers", "train", batch, seq, use_window)


def layer_decode_cost(cfg, mesh, batch: int, seq: int, use_window: bool = True,
                      layout: str = "2d") -> Cost:
    return _layer_cost(cfg, mesh, layout, "layers", "decode", batch, seq, use_window)


def layer_prefill_cost(cfg, mesh, batch: int, seq: int, use_window: bool = True,
                       layout: str = "2d") -> Cost:
    return _layer_cost(cfg, mesh, layout, "layers", "prefill", batch, seq, use_window)


def _enc_layer_cost(cfg, mesh, batch: int, train: bool, layout: str = "2d") -> Cost:
    """An encoder layer in training, or in a prefill (serving numerics)."""
    return _layer_cost(cfg, mesh, layout, "enc_layers", "train" if train else "prefill", batch,
                       cfg.enc_ctx)


def _dec_layer_cost(cfg, mesh, batch: int, seq: int, kind: str, layout: str = "2d") -> Cost:
    """``kind``: fwd, train, prefill (the forward with its cache writes, as
    the prefill program runs it) or decode."""
    return _layer_cost(cfg, mesh, layout, "dec_layers", kind, batch, seq)


# ---------------------------------------------------------------------------
# whole programs
# ---------------------------------------------------------------------------


def _one_layer_cfg(cfg):
    kw = {"n_layers": 1, "global_layers": ()}
    if cfg.family == "encdec":
        kw["enc_layers"] = 1
    return dataclasses.replace(cfg, **kw)


@dataclasses.dataclass
class Program:
    """One cell's step over a mesh, ready to run: ``args``, its arguments
    by name (trees of ``ShardedTensor``s laid out by the production
    specs); ``donated``, the names of those it updates in place; ``run()``
    runs it once and returns (outputs, ledger records)."""
    args: dict
    donated: tuple
    run: object


def _zeros_like(spec_tree, dev):
    return model_lib._map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev), spec_tree)


def program(cfg, mesh, shape_name: str, layout: str = "2d", seed: int = 0,
            ocfg: adamw.OptConfig | None = None) -> Program:
    """The train, prefill or serve step of ``shape_name`` over ``mesh``, its
    arguments made on the mesh's devices (parameters from ``seed``, inputs
    zero; on ``meta``, shapes only) and laid out as the JAX package's
    dry-run lays them out: parameters by ``param_specs``, the optimizer
    state by ``opt_specs``, batches by ``batch_specs`` /
    ``prefill_input_specs``, the decode cache by ``cache_specs``, the decode
    position ``seq - 1``. ``ocfg``: the optimizer of a train step (by
    default the dry-run's, ``OptConfig(state_dtype=cfg.param_dtype)``)."""
    sh = shapes_lib.SHAPES[shape_name]
    dev = mesh.flat[0]
    params = model_lib.init(seed, cfg, device="meta" if dev.type == "meta" else dev)
    pspecs = sharding.param_specs(cfg, mesh, params, layout)
    specs = shapes_lib.input_specs(cfg, shape_name)
    args = {"params": spmd._place_tree(params, mesh, pspecs)}
    del params
    if sh.kind == "train":
        ocfg = ocfg or adamw.OptConfig(state_dtype=cfg.param_dtype)
        opt = adamw.init_opt(model_lib._map(lambda st: torch.empty(
            st.shape, dtype=st.dtype, device="meta"), args["params"]), ocfg)
        args["opt"] = spmd._place_tree(_zeros_like(opt, dev), mesh, sharding.opt_specs(cfg, mesh, pspecs))
        args["batch"] = spmd._place_tree(_zeros_like(specs["batch"], dev), mesh,
                                sharding.batch_specs(cfg, mesh, layout))
        step = spmd.build_sharded_train_step(cfg, ocfg, mesh, layout)

        def run():
            out = step(args["params"], args["opt"], args["batch"])
            return out, list(step.ledger.records)
        return Program(args, ("params", "opt"), _hinted(run, mesh, sh.batch, layout))
    if sh.kind == "prefill":
        ispecs = sharding.prefill_input_specs(cfg, mesh, batch=sh.batch, layout=layout)
        args["inputs"] = spmd._place_tree(_zeros_like({k: specs[k] for k in ispecs}, dev), mesh, ispecs)
        step = spmd.build_sharded_prefill_step(cfg, mesh, layout)

        def run():
            out = step(args["params"], args["inputs"])
            return out, list(step.ledger.records)
        return Program(args, (), _hinted(run, mesh, sh.batch, layout))
    dspecs = sharding.decode_input_specs(cfg, mesh, batch=sh.batch, layout=layout)
    step = spmd.build_sharded_serve_step(cfg, mesh, layout)
    args["cache"] = step.model.cache_like(sh.batch, sh.seq)
    args["token"] = sharding.shard(torch.zeros(specs["token"].shape, dtype=torch.int32,
                                               device=dev), sharding.Placement(mesh,
                                                                               dspecs["token"]))

    def run():
        out = step(args["params"], args["cache"], args["token"], sh.seq - 1)
        return out, list(step.ledger.records)
    return Program(args, ("cache",), _hinted(run, mesh, sh.batch, layout))


def _program_cost(cfg, mesh, shape_name: str, layout: str = "2d") -> Cost:
    """Full-program cost with the given cfg (callers pass n_layers=1)."""
    return measure(program(cfg, mesh, shape_name, layout).run, mesh).cost


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


def corrected_costs(cfg, mesh, shape_name: str, layout: str = "2d") -> dict:
    """Per-device corrected (flops, hbm_bytes, coll_bytes) for one cell."""
    sh = shapes_lib.SHAPES[shape_name]
    cfg = _accounting_cfg(cfg, sh.seq)
    stem = _program_cost(_one_layer_cfg(cfg), mesh, shape_name, layout)
    extra = Cost()
    n_extra = cfg.n_layers - 1

    if cfg.family == "encdec":
        if sh.kind == "train":
            dec = _dec_layer_cost(cfg, mesh, sh.batch, sh.seq, "train", layout)
            dec = dec + _dec_layer_cost(cfg, mesh, sh.batch, sh.seq, "fwd", layout) \
                if cfg.remat else dec
            enc = _enc_layer_cost(cfg, mesh, sh.batch, True, layout)
        elif sh.kind == "prefill":
            dec = _dec_layer_cost(cfg, mesh, sh.batch, sh.seq, "prefill", layout)
            enc = _enc_layer_cost(cfg, mesh, sh.batch, False, layout)
        else:
            dec = _dec_layer_cost(cfg, mesh, sh.batch, sh.seq, "decode", layout)
            enc = Cost()
        extra = n_extra * dec + (cfg.enc_layers - 1) * enc
    else:
        def lc_of(flag: bool) -> Cost:
            if sh.kind == "train":
                c = layer_train_cost(cfg, mesh, sh.batch, sh.seq, flag, layout)
                if cfg.remat:
                    c = c + layer_fwd_cost(cfg, mesh, sh.batch, sh.seq, flag, layout)
                return c
            if sh.kind == "prefill":
                return layer_prefill_cost(cfg, mesh, sh.batch, sh.seq, flag, layout)
            return layer_decode_cost(cfg, mesh, sh.batch, sh.seq, flag, layout)

        if cfg.sliding_window is None:
            extra = n_extra * lc_of(True)
        else:
            # per-layer composition: SWA (banded) vs global layers differ
            flags = [i not in cfg.global_layers
                     for i in range(cfg.n_layers)]
            lc_swa, lc_glob = lc_of(True), lc_of(False)
            extra = Cost()
            for fl in flags[1:]:
                extra = extra + (lc_swa if fl else lc_glob)
            if not flags[0]:
                # the L=1 stem modeled its single layer as SWA
                extra = extra + lc_glob + (-1.0) * lc_swa

    total = stem + extra
    return {"total": total.to_dict(), "stem_l1": stem.to_dict(),
            "per_extra_layer": (extra * (1 / max(n_extra, 1))).to_dict(),
            "n_layers": cfg.n_layers}
