"""RapidRAID pipelined encoding and decoding along a node chain (paper Fig. 2).

On one card the n storage nodes of the chain are the leading node axis of
device tensors. Node i holds its replica block(s), receives the running
combination from its predecessor, keeps its codeword block (xi path) and
forwards the updated combination (psi path). Blocks stream through the
pipeline (``repro_torch.core.pipeline``) in ``num_chunks`` chunks, and each
tick is ONE launch of the hand-written CUDA tick kernel over the active
nodes (``repro_torch.kernels.gf_encode``) on packed int32 lanes. The encode
reads each node's replica blocks in place through a slot table, so the
placement is never copied; the decode reads the survivors' shards in place
through a row table. On the card an unplaced chain is one launch, not a
tick loop: the encode one ``encode_chain``, whose running combination never
leaves its registers, the decode one ``repair_chain``, whose partial sums
never do. Placed chains and card layouts keep the ticks and their wires.

Entry points run on the card unless the caller passes ``device="cpu"``,
where the ticks run the kernels' plain PyTorch versions. Asking for a CUDA
device on a machine without one raises.

Warm fast path: each entry point runs one cached program per (code,
survivor set, stripe width, schedule, device) key
(``repro_torch.core.jitcache``): the product tables cross to the device
once, when the program is built, not on every call. ``superchunk_words``
streams an object held on the host through the card in independent stripes
of that width (``repro_torch.core.streaming``): every stripe replays one
CUDA graph of the program's ticks, copies overlap the ticks on streams of
their own, and ``sink(s, words)`` takes each stripe's result instead of a
whole-object output. The single-stripe plan is the monolithic call, which
reads its input in place with no graph.

Every entry point resolves its call through one ``call_plan``: device,
placement, stripes and the schedule (``num_chunks``, and a batch's
``stagger``). Only ticks read the schedule, so only where ticks run (the
CPU, placed chains, card layouts) does ``num_chunks=None`` resolve through
the tuner (``repro_torch.core.autotune.num_chunks_for``: a cached value
for the entry point and geometry, else the calibrated model's choice where
a chain calibration is cached, else the hand-tuned ``DEFAULT_NUM_CHUNKS``)
and the schedule key the program. An unplaced call on the card reaches no
tuner, and its program holds no schedule.

Placement (the JAX package's chain mesh): ``mesh=`` (a ``DeviceMesh`` of n
devices, ``make_chain_mesh``) or ``order=`` (the scheduler's placement:
device ``order[p]`` plays chain position p) puts each chain position on a
device of its own. Each position then holds its own tensors there (its
replica blocks or shard, its codeword rows, its wires), a tick is one
launch per active position on its device (``pipeline.software_pipeline``'s
``placement``), and the wire crosses to the next position by a copy. The
input is read, and the result returned, on the first position's device;
a position on another device gets its blocks or shard copied in and its
output copied back. The same device may hold several positions: a mesh of
``[cuda:0] * n`` runs the placed path on one card, bit for bit the
unplaced result. A streamed run captures one CUDA graph a stripe buffer
where every position shares the program's device, and none otherwise (a
graph cannot span devices): its stripes then run the ticks eagerly.

A card layout (``CardLayout``: the paper's deployment, the nodes grouped
onto cards) keeps the data where the nodes hold it. The chain positions
split into equal runs of consecutive positions, one a card; card c holds,
going in, the replica blocks its positions hold (``layout.blocks[c]``,
ascending object-block ids, each once however many of its positions hold
it) and, coming out, its positions' codeword rows. Each card runs one
``chain_tick`` a tick over its active nodes, reading its replica blocks in
place through its own slot table (``layout.slots[c]``, renumbered on the
card), and the wire hops from card to card (``pipeline.staggered_pipeline``'s
``groups``): no block is gathered and no row is copied back to a first
card. ``storage.multi.pipelined_encode_many(..., layout=)`` is its entry
point.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import autotune, gf, jitcache, pipeline, streaming, trace
from repro_torch.core.codes import ErasureCode
from repro_torch.kernels.gf_encode import kernel, ops
from repro_torch.launch import mesh as mesh_lib

DEFAULT_NUM_CHUNKS = autotune.DEFAULT_NUM_CHUNKS
DEFAULT_STAGGER = 1
AXIS = "chain"


def _resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:   # the card a tensor .to(dev) lands on
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_chain_mesh(n: int, order=None, devices=None) -> mesh_lib.DeviceMesh:
    """Chain mesh of n devices; ``order[p]`` is the device (an index into
    ``devices``) playing chain position p (heterogeneity-aware placement,
    ``repro_torch.core.scheduler``). Default: device p plays position p.
    ``devices`` defaults to the visible CUDA devices; the same device may
    appear more than once (``[cuda:0] * n`` on one card)."""
    devs = mesh_lib.device_list(devices)
    if len(devs) < n:
        raise ValueError(f"need {n} devices for an n={n} chain, have {len(devs)}")
    if order is None:
        return mesh_lib.DeviceMesh((AXIS,), (n,), devs[:n])
    order = tuple(int(i) for i in order)
    if sorted(set(order)) != sorted(order) or len(order) != n:
        raise ValueError(f"order must be {n} distinct device ids, got {list(order)}")
    if max(order) >= len(devs):
        raise ValueError(f"order references device {max(order)}, "
                         f"have {len(devs)}")
    return mesh_lib.DeviceMesh((AXIS,), (n,), [devs[i] for i in order], ids=order)


def resolve_placement(n: int, mesh, order, device, what: str, reverse: bool = False):
    """(the device the call reads its input and returns its result on, the
    device of each chain position, the mesh; both None unplaced) for an
    entry point's ``mesh`` / ``order`` / ``device``. With neither, the
    unplaced call on ``device``. ``order`` indexes the visible devices of
    ``device``'s kind; a mesh must hold n devices, of one kind, and the
    call runs on the first position's. ``reverse``: the repair direction,
    where mesh device i plays position n - 1 - i
    (``pipeline.position_devices``)."""
    if mesh is not None and order is not None:
        raise ValueError("pass either mesh or order, not both")
    if mesh is None and order is None:
        return _resolve_device(device), None, None
    if mesh is None:
        mesh = make_chain_mesh(n, order, mesh_lib.visible_devices(_resolve_device(device).type))
    elif not isinstance(mesh, mesh_lib.DeviceMesh):
        raise TypeError(f"{what}: mesh must be a DeviceMesh, got {type(mesh).__name__}")
    elif device is not None:
        raise ValueError(f"{what}: pass either mesh or device, not both")
    if mesh.size != n:
        raise ValueError(f"{what}: a mesh of {mesh.size} devices for a chain of {n} positions")
    placement = pipeline.position_devices([_resolve_device(d) for d in mesh.flat], reverse)
    if len({d.type for d in placement}) > 1:
        raise ValueError(f"{what}: a mesh mixes device kinds {set(placement)}")
    return placement[0], placement, mesh


class Position(NamedTuple):
    """A chain position's own operands for a placed tick: its device, its
    row of the caller's slot or row table (frozen host int32, (1, ...)),
    its product tables on its device, and ``take``, the rows of the
    caller's input it holds on its device (None: it reads the input in
    place, on the call's device)."""
    device: torch.device
    rows: np.ndarray
    tables: torch.Tensor
    take: tuple | None


def positions(placement, home: torch.device, table: np.ndarray,
              tables: torch.Tensor) -> list[Position]:
    """Each position's operands: ``table`` (n, ...) host int32 (block or
    shard indices, -1 for none), ``tables`` (n, ...) on ``home``. A position
    on another device holds the input rows its row names, renumbered."""
    out = []
    for p, dev in enumerate(placement):
        row, take = np.asarray(table[p:p + 1]), None
        if dev != home:
            take = tuple(sorted({int(v) for v in row.ravel() if v >= 0})) or (0,)
            row = np.array([take.index(v) if v >= 0 else -1 for v in row.ravel()]
                           ).reshape(row.shape)
        frozen = np.array(row, dtype=np.int32)   # owns its data: checked once
        frozen.setflags(write=False)
        out.append(Position(dev, frozen, tables[p:p + 1].to(dev), take))
    return out


def held(x: torch.Tensor, pos: Position, dim: int) -> torch.Tensor:
    """The input a position reads: ``x`` in place, or its rows (along
    ``dim``) copied onto its device."""
    if pos.take is None:
        return x
    idx = torch.tensor(pos.take, dtype=torch.int64, device=x.device)
    return x.index_select(dim, idx).to(pos.device)


class CardLayout:
    """The chain's n positions on ``cards`` (one device a card; the same
    device may appear more than once), split into ``len(cards)`` equal runs
    of consecutive positions (``groups``, ``pipeline.Group``); raises where
    n does not divide. ``blocks[c]``: the ascending object-block ids that
    card c's positions hold, each once (a card's input rows, in that
    order); ``slots[c]``: its positions' rows of ``placement_slots``,
    renumbered into ``blocks[c]``, frozen host int32."""

    def __init__(self, code: ErasureCode, cards):
        if not code.supports_chain_encode:
            raise ValueError(f"CardLayout: {code.family} has no chain schedule")
        self.code_key = code.cache_key
        self.cards = tuple(_resolve_device(d) for d in cards)
        if len({d.type for d in self.cards}) > 1:
            raise ValueError(f"CardLayout: cards of several kinds {set(self.cards)}")
        self.groups = pipeline.even_groups(code.n, self.cards)
        table = placement_slots(code)
        blocks, slots = [], []
        for g in self.groups:
            rows = table[g.first:g.first + g.count]
            held = sorted({int(v) for v in rows.ravel() if v >= 0})
            local = np.array([[held.index(v) if v >= 0 else -1 for v in row] for row in rows],
                             dtype=np.int32)
            local.setflags(write=False)
            blocks.append(tuple(held))
            slots.append(local)
        self.blocks, self.slots = tuple(blocks), tuple(slots)

    @property
    def key(self) -> tuple:
        """What a program over this layout is keyed by, beside the code."""
        return ("cards",) + self.cards


def encode_ticks(code: ErasureCode, plan: CallPlan, drive, layout: CardLayout | None = None):
    """The tick loop of a call plan's encode, ``ticks(src, out_nodes, wires)``
    over ``src`` (B_obj, k, Bp) and ``out_nodes`` (n, B_obj, Bp). Unplaced:
    the whole chain in one ``ops.encode_chain``, which takes no wires (on
    the card one launch, which reads no schedule, the running combination
    kept in registers; on the CPU the ticks of its schedule), over the
    ``kernel.EncodePlan`` made here
    once, as the tables are. Placed: ``drive(step, wires)`` runs one
    ``chain_tick`` launch a position a tick through the pipeline driver,
    each reading its own replica blocks and writing its codeword rows. Over
    a card ``layout``, ``src`` and ``out_nodes`` are lists, one a card,
    (B_obj, len(layout.blocks[c]), Bp) and (positions, B_obj, Bp) on card c,
    and each card's launch at a tick runs over its active nodes at tick t
    minus its first position, on its own slots and tables: placed chains
    and layouts need a wire that crosses devices, the unplaced chain none."""
    l, num_chunks, stagger, device = code.l, plan.num_chunks, plan.stagger, plan.device
    if layout is not None:
        m = layout.groups[0].count
        cards = [(g.first, layout.slots[c],
                  device_tables(product_tables(code)[g.first:g.first + g.count], g.device))
                 for c, g in enumerate(layout.groups)]

        def card_ticks(srcs, outs, wires):
            def step(wire_in, wire_out, t, lo, count):
                c = lo // m
                first, slots_c, tables_c = cards[c]
                ops.chain_tick(wire_in, wire_out, srcs[c], slots_c, outs[c], tables_c, l,
                               t - first, num_chunks, lo - first, count, stagger)
            drive(step, wires)
        return card_ticks
    slots = placement_slots(code)
    tables = device_tables(product_tables(code), device)
    if plan.placement is None:
        walk = kernel.EncodePlan(slots, code.k, device)

        def ticks(src, out_nodes, wires):
            ops.encode_chain(src, walk, out_nodes, tables, l, num_chunks, stagger)
        return ticks
    pos = positions(plan.placement, device, slots, tables)

    def placed_ticks(src, out_nodes, wires):
        srcs = [held(src, q, 1) for q in pos]
        outs = [out_nodes[p:p + 1] if q.take is None else
                torch.empty((1,) + tuple(out_nodes.shape[1:]), dtype=torch.int32,
                            device=q.device) for p, q in enumerate(pos)]

        def step(wire_in, wire_out, t, p, _):
            ops.chain_tick(wire_in, wire_out, srcs[p], pos[p].rows, outs[p], pos[p].tables,
                           l, t - p, num_chunks, 0, 1, stagger)
        drive(step, wires)
        for p, q in enumerate(pos):
            if q.take is not None:
                out_nodes[p:p + 1].copy_(outs[p])
    return placed_ticks


def sums_ticks(l: int, rows_table: np.ndarray, tables: torch.Tensor, plan: CallPlan, drive):
    """The tick loop of a call plan's decode or repair, ``ticks(shards, out,
    wires)`` over ``shards`` (R, B_obj, Bp) and ``out`` (B_obj, rows, Bp):
    chain position p reads shard ``rows_table[p]`` and applies
    ``tables[p]``; the last position writes ``out``; position 0 starts from
    zero sums. Unplaced: the whole chain in one ``ops.repair_chain``, which
    takes no wires (on the card one launch, which reads no schedule, the
    sums kept in registers; on the CPU the ticks of its schedule). Placed:
    ``drive`` runs one
    ``repair_tick`` launch a position a tick, every position but the last
    forwarding its sums (``last_forwards``)."""
    num_chunks, stagger = plan.num_chunks, plan.stagger
    if plan.placement is None:
        def ticks(shards, out, wires):
            ops.repair_chain(shards, rows_table, out, tables, l, num_chunks, stagger)
        return ticks
    pos = positions(plan.placement, plan.device, rows_table, tables)
    h = len(pos)

    def placed_ticks(shards, out, wires):
        srcs = [held(shards, q, 0) for q in pos]
        last_out = out if pos[-1].take is None else torch.empty(
            tuple(out.shape), dtype=torch.int32, device=pos[-1].device)

        def step(wire_in, wire_out, t, p, _):
            last = p == h - 1
            ops.repair_tick(wire_in, wire_out, srcs[p], pos[p].rows,
                            last_out if last else None, pos[p].tables, l, t - p, num_chunks,
                            0, 1, head_zero=p == 0, stagger=stagger, last_forwards=not last)
        drive(step, wires)
        if pos[-1].take is not None:
            out.copy_(last_out)
    return placed_ticks


def column_bitplanes(M: np.ndarray, l: int) -> np.ndarray:
    """Per-chain-node bit-plane constants for a GF coefficient matrix.

    (rows, cols) M -> (cols, rows, l) uint32 with
    ``out[c, r, b] = M[r, c] * alpha^b``: chain node c applies column c of M
    to its local stream — the layout pipelined decode feeds the ticks.
    """
    return gf.bitplane_table(np.asarray(M).T, l)


@functools.lru_cache(maxsize=None)
def bitplane_coeff_planes(code: ErasureCode) -> tuple[np.ndarray, np.ndarray]:
    """(bp_psi, bp_xi), each (n, max_b, l) uint32 with bp[i,s,j] = coef*alpha^j.

    Cached per code: the planes are a pure function of the (hashable) code.
    """
    sched = code.chain
    bp_psi = gf.bitplane_table(sched.psi, code.l)
    bp_xi = gf.bitplane_table(sched.xi, code.l)
    bp_psi.setflags(write=False)   # shared cached copies — freeze them
    bp_xi.setflags(write=False)
    return bp_psi, bp_xi


@functools.lru_cache(maxsize=None)
def placement_indices(code: ErasureCode) -> tuple[np.ndarray, np.ndarray]:
    """Static gather spec for replica placement: (idx, valid), both (n, max_b).

    ``local[i, s] = data[idx[i, s]] if valid[i, s] else 0``.
    """
    sched = code.chain
    idx = sched.local_blocks.astype(np.int32)
    valid = sched.block_valid.copy()
    idx.setflags(write=False)      # shared cached copies — freeze them
    valid.setflags(write=False)
    return idx, valid


@functools.lru_cache(maxsize=None)
def placement_slots(code: ErasureCode) -> np.ndarray:
    """The encode tick's slot table, (n, max_b) int32: node i's slot s
    holds object block ``slots[i, s]``, or nothing where it is -1."""
    idx, valid = placement_indices(code)
    slots = np.where(valid, idx, -1).astype(np.int32)
    slots.setflags(write=False)    # shared cached copy — freeze it
    return slots


@functools.lru_cache(maxsize=None)
def product_tables(code: ErasureCode) -> np.ndarray:
    """The encode tick's product tables, (n, max_b, l // 8, 256) uint32
    (``kernel.product_tables`` of ``bitplane_coeff_planes``). Cached per
    code, so only a code's first encode builds them."""
    tables = kernel.product_tables(*bitplane_coeff_planes(code), code.l)
    tables.setflags(write=False)   # shared cached copy — freeze it
    return tables


def build_local_blocks(code: ErasureCode, data: np.ndarray) -> np.ndarray:
    """Replica placement on the host: (n, max_b, B) words; padded slots are zero.

    What the encode tick's slot table reads (``placement_slots``).
    """
    idx, valid = placement_indices(code)
    data = np.asarray(data)
    return np.where(valid[:, :, None], data[idx], 0).astype(data.dtype)


def _check_chunking(B: int, l: int, num_chunks: int, what: str) -> None:
    """Raises unless a block of B words cuts into ``num_chunks`` chunks of
    whole uint32 lanes."""
    lanes = gf.LANES[l]
    if num_chunks < 1:
        raise ValueError(f"{what}: num_chunks must be >= 1, got {num_chunks}")
    if B % (lanes * num_chunks):
        if num_chunks == 1:
            raise ValueError(
                f"{what}: block length {B} must be whole uint32 lanes "
                f"({lanes} GF(2^{l}) words each)")
        raise ValueError(
            f"{what}: block length {B} must divide into {num_chunks} chunks "
            f"of whole uint32 lanes ({lanes} GF(2^{l}) words each)")


class CallPlan(NamedTuple):
    """What a pipelined call resolves to (``call_plan``). ``placement``:
    each chain position's device, None unplaced; ``mesh``: the mesh or card
    layout key; ``B_obj`` None: one object. The schedule, ``num_chunks``
    and ``stagger`` (0: lockstep), is None and None on an unplaced card
    call, whose one launch reads none."""
    device: torch.device
    placement: tuple | None
    mesh: object
    stream: streaming.StreamPlan
    B_obj: int | None
    num_chunks: int | None
    stagger: int | None
    key: tuple


def call_plan(code: ErasureCode, what: str, entry: str, total_words: int, num_chunks,
              stagger=None, *, chain_len: int, sets: tuple = (), B_obj: int | None = None,
              device=None, superchunk_words: int | None = None, mesh=None, order=None,
              layout: CardLayout | None = None, reverse: bool = False) -> CallPlan:
    """The plan of a pipelined call (``what`` in errors; ``entry`` its tuner
    entry and program key) over blocks of ``total_words`` words, along a
    chain of ``chain_len`` positions (placed in ``reverse`` for a repair),
    for one object (``B_obj`` None, lockstep) or a batch (``stagger`` >=
    1). ``sets`` (survivors, missing rows) join the program's key.

    The one place that decides where ticks run: on the CPU, placed (``mesh``
    / ``order``) or over a card ``layout``. Only there does a None
    ``num_chunks`` or ``stagger`` resolve through the tuner
    (``autotune.num_chunks_for`` / ``stagger_for``) and the schedule join
    the key. An unplaced call on the card reaches no tuner and its key holds
    no schedule. An explicit ``num_chunks`` is checked and sets the stripe
    granule everywhere; None on the card takes ``DEFAULT_NUM_CHUNKS``'s."""
    if layout is not None:
        dev, placement, mesh = layout.cards[0], None, layout.key
    else:
        dev, placement, mesh = resolve_placement(chain_len, mesh, order, device, what, reverse)
    ticks = dev.type == "cpu" or placement is not None or layout is not None
    batch = () if B_obj is None else (B_obj,)
    if ticks and num_chunks is None:
        num_chunks = autotune.num_chunks_for(entry, code, total_words, chain_len=chain_len,
                                             extra_key=batch, device=dev)
    granule = DEFAULT_NUM_CHUNKS if num_chunks is None else num_chunks
    if granule < 1:
        raise ValueError(f"{what}: num_chunks must be >= 1, got {num_chunks}")
    stream = streaming.plan_stream(total_words, superchunk_words, l=code.l, num_chunks=granule)
    _check_chunking(stream.sc_words, code.l, num_chunks or 1, what)
    if B_obj is None:
        stagger = 0
    elif stagger is not None and stagger < 1:
        raise ValueError(f"{what}: stagger must be >= 1, got {stagger}")
    elif ticks and stagger is None:
        stagger = autotune.stagger_for(code, B_obj, num_chunks, default=DEFAULT_STAGGER,
                                       device=dev)
    schedule = (num_chunks, int(stagger))[:1 + len(batch)] if ticks else ()
    key = (entry, code.cache_key, *sets, mesh, *batch, stream.sc_words, *schedule, dev)
    if not ticks:
        return CallPlan(dev, placement, mesh, stream, B_obj, None, None, key)
    return CallPlan(dev, placement, mesh, stream, B_obj, num_chunks, int(stagger), key)


def run_program(plan: CallPlan, build, x: torch.Tensor, sink):
    """The cached program of ``plan.key`` (built by ``build`` on a miss)
    over ``x``: in place on the plan's device for the single-stripe plan,
    else stripe by stripe from the host (a CUDA ``x`` is brought to the
    host first, as the JAX package's streaming takes host arrays)."""
    with trace.span("repro_torch.lookup"):
        program = jitcache.get(plan.key, build)
    if not plan.stream.streaming:
        x = x.to(plan.device)
    return streaming.run_words(program, x, plan.stream, sink=sink)


def _drive(n: int, rows: tuple, l: int, plan: CallPlan, layout: CardLayout | None = None):
    """(``drive(step, wires)``, the program's wire shape) of a placed or
    grouped run over n positions (``pipeline.run_chain``), a wire slot
    carrying ``rows`` (a sums chain's; an encode's none) chunks of S lanes;
    (None, None) unplaced, where the ticks keep no wires."""
    if plan.placement is None and layout is None:
        return None, None
    nc, objs = plan.num_chunks, plan.B_obj or 1
    slot = rows + (plan.stream.sc_words // gf.LANES[l] // nc,)

    def drive(step, wires):
        pipeline.run_chain(step, n, nc, slot, num_objects=objs, stagger=plan.stagger,
                           device=plan.device, wires=wires, placement=plan.placement,
                           groups=None if layout is None else layout.groups)
    return drive, pipeline.chain_wire_shape(n, nc, slot, objs, plan.stagger)


def _program(plan: CallPlan, l: int, in_rows: int, out_rows: int, wire_shape,
             ticks) -> streaming.Program:
    """The ``streaming.Program`` of a plan: (in_rows, sc_words) ->
    (out_rows, sc_words) words, each with a leading B_obj for a batch."""
    lead = () if plan.B_obj is None else (plan.B_obj,)
    return streaming.Program(device=plan.device, l=l, sc_words=plan.stream.sc_words,
                             in_lead=lead + (in_rows,), out_lead=lead + (out_rows,),
                             wire_shape=wire_shape, ticks=ticks, placement=plan.placement)


def device_tables(tables: np.ndarray, device: torch.device) -> torch.Tensor:
    """Cached uint32 product tables as the int32 tensor a tick takes, copied
    to ``device``: a program does it once, when it is built."""
    return torch.from_numpy(tables.view(np.int32).copy()).to(device)


def _words(x, l: int, rows: int, what: str, device: torch.device | None = None,
           batch: tuple[str, str] | None = None) -> torch.Tensor:
    """(rows, B) GF(2^l) words, or with ``batch`` (its name, its rows' name)
    a (B_obj, rows, B) batch, as a tensor on ``device`` (None: where it
    lies, the host for a numpy array)."""
    x = torch.as_tensor(x, device=device)
    if x.dim() != 2 + (batch is not None) or x.shape[-2] != rows:
        raise ValueError(f"{what}: words {tuple(x.shape)} must be ({rows}, B)" if batch is None
                         else f"{what}: {batch[0]} {tuple(x.shape)} must be "
                         f"(B_obj, {batch[1]}={rows}, B)")
    if x.dtype != gf.TORCH_WORD_DTYPE[l]:
        raise ValueError(f"{what}: words must be {gf.TORCH_WORD_DTYPE[l]} for "
                         f"GF(2^{l}), got {x.dtype}")
    return x


def encode_operands(code: ErasureCode, data_packed: torch.Tensor):
    """Operands of the encode ticks for ``data_packed``, one object (k, Bp)
    or a batch (B_obj, k, Bp) of int32: ``src`` (B_obj, k, Bp), a view of
    the data (the ticks read the replica blocks in place), ``slots`` (n,
    max_b) int32 on the host, and the product tables (n, max_b, l // 8,
    256) int32 on the data's device."""
    src = data_packed[None] if data_packed.dim() == 2 else data_packed
    return (src, placement_slots(code),
            device_tables(product_tables(code), data_packed.device))


def build_encode(code: ErasureCode, plan: CallPlan, layout: CardLayout | None = None):
    """The encode program of a call plan: (k, sc_words) words -> (n,
    sc_words), each with a leading B_obj for a batch, every node reading
    its replica blocks in place and writing its codeword row straight into
    the output (``encode_ticks``). Unplaced it keeps no wires; placed, n
    rows (the last node's forward is never read). Over a card ``layout``, a
    ``streaming.CardProgram``: card c's (B_obj, len(layout.blocks[c]),
    sc_words) -> its (B_obj, positions, sc_words)."""
    drive, wire_shape = _drive(code.n, (), code.l, plan, layout)
    run = encode_ticks(code, plan, drive, layout)
    if layout is not None:
        def card_ticks(srcs, outs, wires):
            run(srcs, [out.transpose(0, 1) for out in outs], wires)   # (positions, B_obj, Bp)
        return streaming.CardProgram(
            cards=layout.cards, l=code.l, sc_words=plan.stream.sc_words, ticks=card_ticks,
            in_leads=[(plan.B_obj, len(b)) for b in layout.blocks],
            out_leads=[(plan.B_obj, g.count) for g in layout.groups])

    def ticks(src, out, wires):
        if plan.B_obj is None:
            run(src[None], out[:, None], wires)      # (1, k, Bp), (n, 1, Bp): views
        else:
            run(src, out.transpose(0, 1), wires)     # out as (n, B_obj, Bp), a view
    return _program(plan, code.l, code.k, code.n, wire_shape, ticks)


@trace.root("encode")
def pipelined_encode(code: ErasureCode, data, num_chunks: int | None = None,
                     device=None, superchunk_words: int | None = None,
                     sink=None, mesh=None, order=None) -> torch.Tensor | None:
    """Archive object ``data`` (k, B) words -> codeword blocks (n, B) words.

    ``data`` is a numpy array or a tensor of uint8 (GF(2^8)) or uint16
    (GF(2^16)) words; the result is a tensor of words on ``device``. On the
    card the whole chain is one ``encode_chain`` launch, reading the
    replica blocks in place and carrying the running combination in
    registers, whatever ``num_chunks``; on the CPU, and placed, one
    ``chain_tick`` a tick over the active nodes, ``num_chunks=None`` tuned
    (``call_plan``).

    ``superchunk_words`` streams a host-resident object through the card
    as independent stripes of that many words a block, each one replay of
    the same cached program; the result is then a CPU tensor, or, with
    ``sink``, ``sink(s, coded_stripe)`` receives each trimmed (n, W) words
    array and None is returned. Stripes encode bit-identically to the
    monolithic call; the default single-stripe plan IS the monolithic call.

    ``mesh`` (n devices, ``make_chain_mesh``) or ``order`` (device
    ``order[p]`` of the visible ones plays chain position p) places the
    chain positions on devices: row p of the result is position p's
    codeword block, computed on its device and returned on the first
    position's, bit for bit the unplaced result.
    """
    with trace.span("repro_torch.resolve"):
        if not code.supports_chain_encode:
            raise ValueError(
                f"pipelined_encode: {code.family} has no chain schedule — "
                f"use code.encode_np")
        data = _words(data, code.l, code.k, "pipelined_encode")
        plan = call_plan(code, "pipelined_encode", "encode", data.shape[1], num_chunks,
                         chain_len=code.n, device=device, superchunk_words=superchunk_words,
                         mesh=mesh, order=order)
    return run_program(plan, lambda: build_encode(code, plan), data, sink)


def encode_program(code: ErasureCode, sc_words: int, num_chunks: int = DEFAULT_NUM_CHUNKS,
                   device=None, mesh=None, order=None) -> streaming.Program:
    """The cached encode program of one stripe geometry, (k, sc_words) ->
    (n, sc_words) words: what a store-driven stream
    (``storage.archive.archive_step`` with ``superchunk_bytes``) hands to
    ``streaming.execute`` itself. Same key as ``pipelined_encode``, so a
    store-driven and an in-memory stream of one geometry share a program.
    ``mesh`` / ``order`` as in ``pipelined_encode``."""
    if not code.supports_chain_encode:
        raise ValueError(f"encode_program: {code.family} has no chain schedule")
    plan = call_plan(code, "encode_program", "encode", sc_words, num_chunks, chain_len=code.n,
                     device=device, mesh=mesh, order=order)
    return jitcache.get(plan.key, lambda: build_encode(code, plan))


@functools.lru_cache(maxsize=256)
def decode_planes(code: ErasureCode, ids: tuple[int, ...]) -> np.ndarray:
    """Bit-plane constants of the decode matrix's columns, (n_alive, k, l)
    uint32. Cached per (code, survivor set): the host Gaussian elimination
    runs once, not on every read. Raises ValueError if ``ids`` are not
    decodable."""
    planes = column_bitplanes(code.decode_matrix(list(ids)), code.l)
    planes.setflags(write=False)   # shared cached copy — freeze it
    return planes


@functools.lru_cache(maxsize=256)
def decode_tables(code: ErasureCode, ids: tuple[int, ...]) -> np.ndarray:
    """The decode ticks' product tables, (n_alive, packs, l // 8, 256)
    uint32 (``kernel.repair_tables`` of ``decode_planes``): node i's
    products for the k rows of column i of the decode matrix. Cached per
    (code, survivor set), so a warm decode builds nothing."""
    tables = kernel.repair_tables(decode_planes(code, ids), code.l)
    tables.setflags(write=False)   # shared cached copy — freeze it
    return tables


@functools.lru_cache(maxsize=None)
def identity_rows(n: int) -> np.ndarray:
    """The row table of a chain whose node i reads shard i, (n,) int32,
    frozen (the ticks check a frozen table once)."""
    rows = np.arange(n, dtype=np.int32)
    rows.setflags(write=False)
    return rows


def decode_operands(code: ErasureCode, ids, device: torch.device) -> torch.Tensor:
    """``decode_tables`` as int32 on ``device``."""
    return device_tables(decode_tables(code, tuple(int(i) for i in ids)), device)


def build_sums(l: int, rows_table: np.ndarray, tables: torch.Tensor, in_rows: int,
               out_rows: int, plan: CallPlan) -> streaming.Program:
    """The decode or repair program of a call plan: (in_rows, sc_words)
    shards -> (out_rows, sc_words) words, each with a leading B_obj for a
    batch, chain position p reading shard ``rows_table[p]`` in place and
    applying ``tables[p]`` (``sums_ticks``). Unplaced it keeps no wires;
    placed, one launch a position."""
    drive, wire_shape = _drive(len(rows_table), (out_rows,), l, plan)
    run = sums_ticks(l, rows_table, tables, plan, drive)

    def ticks(src, out, wires):
        if plan.B_obj is None:
            run(src[:, None], out[None], wires)  # (in_rows, 1, Bp), (1, out_rows, Bp): views
        else:
            run(src.transpose(0, 1), out, wires)     # (in_rows, B_obj, Bp), a view
    return _program(plan, l, in_rows, out_rows, wire_shape, ticks)


def build_decode(code: ErasureCode, ids: tuple[int, ...], plan: CallPlan) -> streaming.Program:
    """``build_sums`` of a decode: node i reads survivor i's shard and
    applies its column of the decode matrix; the k rows are the object."""
    return build_sums(code.l, identity_rows(len(ids)), decode_operands(code, ids, plan.device),
                      len(ids), code.k, plan)


@trace.root("decode")
def pipelined_decode(code: ErasureCode, ids, shards, num_chunks: int | None = None,
                     device=None, superchunk_words: int | None = None,
                     sink=None, mesh=None) -> torch.Tensor | None:
    """Pipelined RapidRAID decode (paper §III's pipelined decoding).

    The len(ids) shard-holding nodes form a chain; the wire carries the k
    running partial output blocks, and node i adds D[:, i] * c_i as the
    stream passes, reading its shard in place. Only the LAST node's (k, Bp)
    sums are kept: they are the decoded object (the JAX package
    materializes every node's (k, Bp) and keeps the last). On the card the
    whole chain is one ``repair_chain`` launch, the sums carried in
    registers; on the CPU, one repair tick a tick. ``shards`` (len(ids),
    B) words as a numpy array or tensor; returns the (k, B) object as a
    tensor of words on ``device``. ``num_chunks`` as in ``pipelined_encode``.
    ``superchunk_words`` / ``sink`` stream the decode as in
    ``pipelined_encode``: decode applies D per word, so the stripes
    concatenate to the monolithic result. ``mesh`` (len(ids) devices)
    places survivor i's chain position on its i-th device, as in
    ``pipelined_encode``; the result comes back on its first device.
    """
    with trace.span("repro_torch.resolve"):
        if not code.positionwise:
            raise ValueError(
                f"pipelined_decode: {code.family} shards are sub-packetized — "
                f"use code.decode_np")
        ids = tuple(int(i) for i in ids)
        shards = _words(shards, code.l, len(ids), "pipelined_decode")
        plan = call_plan(code, "pipelined_decode", "decode", shards.shape[1], num_chunks,
                         chain_len=len(ids), sets=(ids,), device=device,
                         superchunk_words=superchunk_words, mesh=mesh)
    return run_program(plan, lambda: build_decode(code, ids, plan), shards, sink)


def decode_program(code: ErasureCode, ids, sc_words: int,
                   num_chunks: int = DEFAULT_NUM_CHUNKS, device=None,
                   mesh=None) -> streaming.Program:
    """The cached decode program of one survivor set and stripe geometry,
    (len(ids), sc_words) shards -> (k, sc_words) words, under
    ``pipelined_decode``'s key: what a caller holding the shards on the
    device (``repro_torch.checkpoint.devio``'s restore) runs itself."""
    if not code.positionwise:
        raise ValueError(f"decode_program: {code.family} shards are sub-packetized")
    ids = tuple(int(i) for i in ids)
    plan = call_plan(code, "decode_program", "decode", sc_words, num_chunks,
                     chain_len=len(ids), sets=(ids,), device=device, mesh=mesh)
    return jitcache.get(plan.key, lambda: build_decode(code, ids, plan))


def order_chain(node_speeds: np.ndarray, n: int, k: int) -> np.ndarray:
    """Straggler mitigation: permutation assigning nodes to chain positions.

    Chain positions are not symmetric: position 0 never receives, position
    n-1 never forwards (no psi work), and for n < 2k the middle 2k-n
    positions process two blocks (double compute + double replica traffic).
    Put the slowest nodes at the chain ends and the fastest in the middle,
    so per-tick latency (the pipeline's critical path) is minimized.
    """
    node_speeds = np.asarray(node_speeds, dtype=float)
    if node_speeds.shape != (n,):
        raise ValueError(f"order_chain: {node_speeds.shape} speeds for n={n}")
    order = np.argsort(node_speeds)  # slowest first
    heavy = list(range(n - k, k))    # two-block positions (empty when n == 2k)
    light = [p for p in range(n) if p not in heavy]
    # light positions sorted so the very ends are filled with the slowest
    light.sort(key=lambda p: min(p, n - 1 - p))
    perm = np.zeros(n, dtype=int)
    for pos, node in zip(light, order[: len(light)]):
        perm[pos] = node
    for pos, node in zip(heavy, order[len(light):][::-1]):  # fastest in middle
        perm[pos] = node
    return perm
