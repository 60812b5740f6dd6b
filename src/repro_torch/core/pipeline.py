"""Chunked chain-pipeline scheduler on one device (paper §III, Fig. 2).

The paper's insight: a chain of n nodes streaming a block at network-buffer
granularity costs ``T = tau_block + (n-1) * tau_buf`` instead of the classical
``tau_block * max(k, m-1)``.

On one card the n chain positions are a leading **node axis** of device
tensors. Tick t in [0, num_chunks + n - 1): node i processes chunk
ch = t - i when that chunk exists. The wire between neighbours is a
ping-pong pair of buffers with one row per node: at tick t node i reads row
i of the buffer written at tick t - 1 — the row node i - 1 wrote there — and
writes row i + 1 of the other buffer. Row 0 is never written, so the head
of the chain reads zeros. One tick is one kernel launch over the active
nodes only, so nodes outside ``active_nodes`` cost nothing.

Many objects (paper §VI, Fig. 4) run as staggered chains on the same node
axis: object b's schedule starts ``b * stagger`` ticks after object 0's, so
node i works chunk t - i - b * stagger of object b. At most ``window_size``
objects are active on a node at once, and the wire carries that window:
W slots a node, object b in slot b % W. The active objects of a node are
consecutive, so no two of them share a slot, and a node's successor reads
the object in the slot it was written to (``staggered_pipeline``).

The schedule runs in one direction on the node axis. The reverse chain of
repair (node idx plays position n-1-idx and the wire flows toward node 0,
the replacement) is the same schedule over the node axis laid out in
position order, ``position_nodes(n, reverse=True)``: the caller stacks its
per-node operands in that order and runs the forward ticks.

Placed chains (the JAX package's ``shard_map`` over a chain mesh): with a
``placement``, the device of each chain position, every position holds its
own tensors on its device, and a tick is one launch per active position on
that position's device and current stream. Position p's incoming wire is a
(1, ...) buffer and its outgoing one a (2, ...) buffer whose row 1 is the
forward (the last position's is (1, ...): it forwards nothing), so a
position is a launch over node 0 of a one-node chain at tick t - p.
``lax.ppermute`` becomes a copy of position p's forward into position
p + 1's incoming wire after the tick's launches: on one device a copy on
its stream; across devices a peer copy, which PyTorch orders against both
devices' current streams with events (the producer's launch before the
copy, the consumer's earlier launch before it is overwritten). Ticks stay
``num_chunks + n - 1`` (``num_ticks_many`` staggered); without a placement
the run is the one-launch-a-tick path above.

Grouped placement (a card layout, ``staggered_pipeline``'s ``groups``):
the chain positions split into runs of consecutive positions, one ``Group``
a card, and each group's positions are the node axis of that card. A tick
is one launch a group over its active nodes (the caller passes the global
tick and node range, and launches at tick t - first on the group's own
operands), so a card runs its nodes as one card runs the whole chain. A
group's wires are (count + 1, W, ...) on its card: row 0 the incoming wire
of its first node, row i + 1 node i's forward, row count the forward of
its last node (the last group's wires have count rows: the chain's last
forward is never read). At each boundary a **hop** copies the last node's
forward of tick t into the next group's row 0 of the same parity, which
its first node reads at tick t + 1; only the window slots that carried a
chunk at tick t (the objects of ``active_objects``, a cyclic range of
slots, so at most two copies). Between two cards the hop is a peer copy
on the consumer's current stream (``kernel.copy_async``), ordered by
events: after the producer's launch for tick t, before the consumer's
launch for tick t + 1 (stream order), after the consumer's launch for
tick t - 1, which read that row (stream order), and before the producer's
launch for tick t + 2, which writes the forward row again. When the run
ends each producer's stream waits for its last hops, so a call leaves all
its work on each card's current stream. On one device (the CPU, or groups
sharing a card) the hop is a copy on its stream.

``stats()["wire_bytes_zeroed"]`` counts the bytes of wire that
``make_wires`` zero-fills, process-wide (``reset_stats`` sets it to 0). A
monolithic call makes fresh wires and pays it every call; a streamed
program's stripes make theirs once. ``stats()["wire_bytes_hopped"]``
counts the bytes the hops copy between groups: per archived batch,
(groups - 1) x B_obj x block bytes.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import trace

_stats = {"wire_bytes_zeroed": 0, "wire_bytes_hopped": 0}


def stats() -> dict[str, int]:
    """The wire counters (process-wide): bytes zero-filled by ``make_wires``
    and ``group_wires``, and bytes hopped between groups."""
    return dict(_stats)


def reset_stats() -> None:
    for key in _stats:
        _stats[key] = 0


def num_ticks(num_chunks: int, n_stages: int) -> int:
    return num_chunks + n_stages - 1


def chain_perm(n: int, reverse: bool = False) -> list[tuple[int, int]]:
    """Source→dest pairs for a non-wrapping chain.

    Forward: node i -> i+1 (encode; the last node finishes the stream).
    Reverse: node i+1 -> i (repair; node 0 finishes the stream).
    """
    if reverse:
        return [(i + 1, i) for i in range(n - 1)]
    return [(i, i + 1) for i in range(n - 1)]


def chain_pos(idx, n: int, reverse: bool = False):
    """Chain position played by node ``idx``."""
    return (n - 1 - idx) if reverse else idx


def position_nodes(n: int, reverse: bool = False) -> list[int]:
    """Node playing each chain position, position 0 first."""
    return [chain_pos(p, n, reverse) for p in range(n)]   # chain_pos is its own inverse


def active_nodes(t: int, n: int, num_chunks: int) -> tuple[int, int]:
    """(first node, node count) with a chunk to process at tick t."""
    lo = max(0, t - num_chunks + 1)
    hi = min(n - 1, t)
    return lo, hi - lo + 1


def position_devices(devices, reverse: bool = False) -> tuple[torch.device, ...]:
    """The device of each chain position, position 0 first, for a chain
    whose node i sits on ``devices[i]`` (a mesh's devices in row-major
    order): position p is played by node ``position_nodes(n, reverse)[p]``."""
    devices = [torch.device(d) for d in devices]
    return tuple(devices[i] for i in position_nodes(len(devices), reverse))


def placed_wires(shape: tuple[int, ...], placement) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each position's (incoming, outgoing) wire on its device, for wires of
    ``shape`` (n, ...) on one device: incoming (1, ...) zeroed (position 0's
    stays zero, the head of the chain), outgoing (2, ...) with the forward
    in row 1, or (1, ...) for the last position."""
    shapes = _wire_shapes(shape, placement)
    _stats["wire_bytes_zeroed"] += sum(4 * math.prod(i) for i, _ in shapes)
    return [(torch.zeros(i, dtype=torch.int32, device=d),
             torch.empty(o, dtype=torch.int32, device=d))
            for (i, o), d in zip(shapes, placement)]


def make_wires(shape: tuple[int, ...], device: torch.device, placement=None) -> list:
    """A run's wires: two zeroed (n, ...) buffers on ``device``, or with a
    placement each position's pair (``placed_wires``)."""
    if placement is not None:
        return placed_wires(shape, placement)
    _stats["wire_bytes_zeroed"] += 2 * 4 * math.prod(shape)
    return [torch.zeros(shape, dtype=torch.int32, device=device) for _ in range(2)]


def _wire_shapes(shape: tuple[int, ...], placement) -> list:
    """The shapes ``make_wires`` gives: two of ``shape``, or each
    position's (incoming, outgoing) pair."""
    if placement is None:
        return [tuple(shape)] * 2
    rest, n = tuple(shape[1:]), len(placement)
    return [((1,) + rest, (2 if p < n - 1 else 1,) + rest) for p in range(n)]


def _wires(shape: tuple[int, ...], device: torch.device, wires, placement=None) -> list:
    """The wires of a run: ``wires`` where the caller keeps them (a
    captured graph binds their addresses), else fresh ones (``make_wires``)."""
    if wires is None:
        return make_wires(shape, device, placement)
    got = [tuple(w.shape) if isinstance(w, torch.Tensor) else tuple(tuple(x.shape) for x in w)
           for w in wires]
    if got != _wire_shapes(shape, placement):
        raise ValueError(f"wire buffers {got} do not fit a run of wire shape {tuple(shape)}")
    return list(wires)


def _run(step_fn: Callable, n: int, ticks: int, active: Callable, wires: list,
         placement) -> int:
    """The tick loop: one ``step_fn`` call over the active nodes a tick, or,
    placed, one call a position and then the copies along the chain; each
    tick in a ``repro_torch.tick`` span."""
    tick = trace.spans("repro_torch.tick")
    if placement is None:
        for t in range(ticks):
            lo, count = active(t)
            with tick():
                step_fn(wires[(t + 1) % 2], wires[t % 2], t, lo, count)
        return ticks
    if len(placement) != n:
        raise ValueError(f"a placement of {len(placement)} positions for a chain of {n}")
    for t in range(ticks):
        lo, count = active(t)
        with tick():
            for p in range(lo, lo + count):
                step_fn(wires[p][0], wires[p][1], t, p, 1)
            for p in range(lo, min(lo + count, n - 1)):   # ppermute: p's forward -> p + 1
                wires[p + 1][0].copy_(wires[p][1][1:])
    return ticks


def software_pipeline(step_fn: Callable, n: int, num_chunks: int,
                      wire_shape: tuple[int, ...], *,
                      device: torch.device, wires=None, placement=None) -> int:
    """Run the chain pipeline over n nodes; returns the number of ticks.

    ``step_fn(wire_in, wire_out, t, node_lo, node_count)`` runs one tick:
    each active node i reads its incoming wire from ``wire_in[i]``, writes
    its own results in place, and forwards into ``wire_out[i + 1]``.
    ``wire_shape`` is the (rows, ...) shape of one int32 wire buffer; its
    row 0 stays zero for the whole run. ``wires``: the caller's two buffers
    of that shape, row 0 zero (every other row is written before it is
    read), or None for two fresh zeroed ones.

    ``placement``: the device of each chain position
    (``position_devices``). Each active position p is then one
    ``step_fn(wire_in, wire_out, t, p, 1)`` call on its own wires
    (``placed_wires``: the caller launches node 0 of a one-node chain at
    tick t - p, with its operands on its device), and its forward is copied
    into position p + 1's incoming wire after the tick's launches.
    ``wires`` is then the run's ``placed_wires`` or None.
    """
    if n < 1 or num_chunks < 1:
        raise ValueError(f"need n >= 1 and num_chunks >= 1, got {n}, {num_chunks}")
    with trace.span("repro_torch.wires"):
        wires = _wires(wire_shape, device, wires, placement)
    return _run(step_fn, n, num_ticks(num_chunks, n),
                lambda t: active_nodes(t, n, num_chunks), wires, placement)


# ---------------------------------------------------------------------------
# Staggered multi-object pipeline (multi-object archival, paper §VI / Fig. 4)
# ---------------------------------------------------------------------------


def window_size(num_chunks: int, num_objects: int, stagger: int) -> int:
    """Max objects simultaneously active on one node.

    Object b's chunk ch is processed by node i at tick t = i + b*stagger + ch,
    so the active objects at (i, t) satisfy 0 <= t - i - b*stagger < num_chunks
    — at most (num_chunks-1)//stagger + 1 values of b.
    """
    return min(num_objects, (num_chunks - 1) // stagger + 1)


def num_ticks_many(num_chunks: int, n_stages: int, num_objects: int,
                   stagger: int) -> int:
    return num_chunks + n_stages - 1 + (num_objects - 1) * stagger


def active_nodes_many(t: int, n: int, num_chunks: int, num_objects: int,
                      stagger: int) -> tuple[int, int]:
    """(first node, node count) of the nodes within the staggered run's span
    at tick t: node i with 0 <= t - i < (num_objects-1)*stagger + num_chunks.
    Every node with an active object is among them; with stagger >
    num_chunks a node may fall between two objects and have none."""
    span = (num_objects - 1) * stagger + num_chunks
    lo = max(0, t - span + 1)
    hi = min(n - 1, t)
    return lo, hi - lo + 1


def staggered_pipeline(step_fn: Callable, n: int, num_chunks: int,
                       slot_shape: tuple[int, ...], *, num_objects: int,
                       stagger: int, device: torch.device, wires=None, placement=None,
                       groups=None) -> int:
    """Interleave ``num_objects`` chain pipelines over the node axis; returns
    the number of ticks, ``num_ticks_many(...)``, against
    ``num_objects * num_ticks(...)`` for a loop of single-object runs.

    ``step_fn(wire_in, wire_out, t, node_lo, node_count)`` runs one tick
    over the nodes of ``active_nodes_many`` (one launch): each active
    (node i, object b) reads its incoming wire from ``wire_in[i, b % W]``,
    writes its own results in place and forwards into ``wire_out[i + 1,
    b % W]``. The wires are (n, W) + ``slot_shape`` int32 with W =
    ``window_size(...)``; row 0 stays zero for the whole run. ``wires`` and
    ``placement`` as in ``software_pipeline``: placed, each position's wires
    carry its W slots, and the copy moves all of them.

    ``groups`` (``even_groups``, in place of a placement): a card layout.
    Each tick is then one ``step_fn(wire_in, wire_out, t, lo, count)`` call
    a group with an active node, over the group's active nodes [lo, lo +
    count) (global positions and tick; the caller launches at tick t minus
    the group's first position, on the group's operands) with the group's
    wires (``group_wires``), and the hops after the tick's launches carry
    each boundary's forward to the next group. The wires are made a call
    (``wires`` must be None).
    """
    if n < 1 or num_chunks < 1 or num_objects < 1 or stagger < 1:
        raise ValueError(f"need n, num_chunks, num_objects and stagger >= 1, got "
                         f"{n}, {num_chunks}, {num_objects}, {stagger}")
    W = window_size(num_chunks, num_objects, stagger)
    ticks = num_ticks_many(num_chunks, n, num_objects, stagger)

    def active(t):
        return active_nodes_many(t, n, num_chunks, num_objects, stagger)
    if groups is not None:
        if wires is not None or placement is not None:
            raise ValueError("grouped ticks make their own wires and take no placement")
        if sum(g.count for g in groups) != n:
            raise ValueError(f"groups of {[g.count for g in groups]} positions for a chain of {n}")
        with trace.span("repro_torch.wires"):
            wires = group_wires((n, W) + tuple(slot_shape), groups)
        return _run_grouped(step_fn, ticks, active, wires, groups,
                            lambda t, i: active_objects(t, i, num_chunks, num_objects, stagger))
    with trace.span("repro_torch.wires"):
        wires = _wires((n, W) + tuple(slot_shape), device, wires, placement)
    return _run(step_fn, n, ticks, active, wires, placement)


def chain_wire_shape(n: int, num_chunks: int, slot_shape: tuple[int, ...],
                     num_objects: int = 1, stagger: int = 0) -> tuple[int, ...]:
    """The (n, W) + ``slot_shape`` wire of ``run_chain``: W the objects in
    lockstep (``stagger`` 0), else ``window_size``."""
    W = window_size(num_chunks, num_objects, stagger) if stagger else num_objects
    return (n, W) + tuple(slot_shape)


def run_chain(step_fn: Callable, n: int, num_chunks: int, slot_shape: tuple[int, ...], *,
              num_objects: int = 1, stagger: int = 0, device: torch.device, wires=None,
              placement=None, groups=None) -> int:
    """The one choice of driver for a chain of ``num_objects`` objects, wire
    slots of ``slot_shape``: ``software_pipeline`` with the objects in
    lockstep (``stagger`` 0), else ``staggered_pipeline`` (which alone
    takes ``groups``); returns the number of ticks."""
    if stagger:
        return staggered_pipeline(step_fn, n, num_chunks, slot_shape, num_objects=num_objects,
                                  stagger=stagger, device=device, wires=wires,
                                  placement=placement, groups=groups)
    return software_pipeline(step_fn, n, num_chunks,
                             chain_wire_shape(n, num_chunks, slot_shape, num_objects),
                             device=device, wires=wires, placement=placement)


# ---------------------------------------------------------------------------
# Grouped placement: a card layout, one launch a card a tick, hops between
# ---------------------------------------------------------------------------


class Group(NamedTuple):
    """Chain positions [first, first + count), the node axis of ``device``."""
    device: torch.device
    first: int
    count: int


def even_groups(n: int, devices) -> tuple[Group, ...]:
    """n chain positions split into ``len(devices)`` equal runs of
    consecutive positions, run c on ``devices[c]`` (a device may appear
    more than once); raises where n does not divide."""
    devices = [torch.device(d) for d in devices]
    if not devices or n % len(devices):
        raise ValueError(f"{n} chain positions do not split evenly over "
                         f"{len(devices)} cards")
    m = n // len(devices)
    return tuple(Group(d, c * m, m) for c, d in enumerate(devices))


def active_objects(t: int, i: int, num_chunks: int, num_objects: int,
                   stagger: int) -> tuple[int, int]:
    """(first object, object count) of the objects with a chunk at node i at
    tick t of a staggered run: 0 <= t - i - b * stagger < num_chunks."""
    d = t - i
    lo = max(0, -(-(d - num_chunks + 1) // stagger))
    hi = min(num_objects - 1, d // stagger) if d >= 0 else -1
    return lo, max(0, hi - lo + 1)


def slot_runs(first: int, count: int, W: int) -> list[tuple[int, int]]:
    """The wire slots of objects [first, first + count), object b in slot
    b % W (count <= W): at most two runs (start slot, slots)."""
    if count <= 0:
        return []
    a = first % W
    head = min(count, W - a)
    return [(a, head)] + ([(0, count - head)] if count > head else [])


def group_wires(shape: tuple[int, ...], groups) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each group's two zeroed wire buffers on its device, for wires of
    ``shape`` (n, ...) on one device: (count + 1, ...), row count carrying
    the last node's forward to the next group; the last group's (count,
    ...)."""
    rest, last = tuple(shape[1:]), len(groups) - 1
    shapes = [(g.count + (c < last),) + rest for c, g in enumerate(groups)]
    _stats["wire_bytes_zeroed"] += sum(2 * 4 * math.prod(s) for s in shapes)
    return [tuple(torch.zeros(s, dtype=torch.int32, device=g.device) for _ in range(2))
            for s, g in zip(shapes, groups)]


@functools.lru_cache(maxsize=None)
def _peer_access(card: torch.device, peer: torch.device) -> None:
    """Lets ``card`` reach ``peer``'s memory directly (NVLink), once a
    process: PyTorch enables it for a copy's source card at the first copy
    between the two, so one word is copied from ``card`` to ``peer``."""
    torch.empty(1, device=peer).copy_(torch.zeros(1, device=card))


class _Hop:
    """The boundary from group ``src`` to group ``dst``: copies of the
    producer's forward row into the consumer's row 0. Between two cards a
    copy runs on the consumer's current stream, after an event on the
    producer's (its launch for the tick), and the producer's next write of
    that parity's forward row waits for an event after the copy."""

    def __init__(self, src: Group, dst: Group):
        self.devices = (src.device, dst.device)
        self.across = src.device.type == "cuda" and src.device != dst.device
        if self.across:
            from repro_torch.kernels.gf_encode import kernel
            self.copy_async = kernel.copy_async
            _peer_access(dst.device, src.device)
            self.ready = torch.cuda.Event()
            self.done = [torch.cuda.Event(), torch.cuda.Event()]
            self.pending = [False, False]     # a copy still reads that parity's row

    def before_write(self, t: int) -> None:
        """Before the producer's launch at tick t, which writes its forward
        row of parity t % 2: wait for the copy that last read it."""
        if self.across and self.pending[t % 2]:
            torch.cuda.current_stream(self.devices[0]).wait_event(self.done[t % 2])
            self.pending[t % 2] = False

    def copy(self, src_row: torch.Tensor, dst_row: torch.Tensor, runs, t: int) -> None:
        """The slots of ``runs`` of the forward row ``src_row`` (W, ...)
        written at tick t into ``dst_row``, the consumer's row 0."""
        _stats["wire_bytes_hopped"] += sum(m for _, m in runs) * src_row[0].nbytes
        if not self.across:
            for a, m in runs:
                dst_row[a:a + m].copy_(src_row[a:a + m])
            return
        prod, cons = (torch.cuda.current_stream(d) for d in self.devices)
        self.ready.record(prod)
        cons.wait_event(self.ready)
        for a, m in runs:
            self.copy_async(dst_row[a:a + m], src_row[a:a + m], cons)
        self.done[t % 2].record(cons)
        self.pending[t % 2] = True

    def finish(self) -> None:
        """The producer's stream waits for the copies still reading its
        wires, so that the run's work is on each card's current stream."""
        for parity in (0, 1):
            self.before_write(parity)


def _run_grouped(step_fn: Callable, ticks: int, active: Callable, wires: list,
                 groups, carried: Callable) -> int:
    """The grouped tick loop: per tick one ``step_fn`` call a group with an
    active node, then each boundary's hop of the slots that carried a
    chunk (``carried(t, i)``: node i's objects at tick t), each in a
    ``repro_torch.hop`` span under the tick's ``repro_torch.tick``."""
    tick, hop = trace.spans("repro_torch.tick"), trace.spans("repro_torch.hop")
    hops = [_Hop(a, b) for a, b in zip(groups, groups[1:])]
    W = wires[0][0].shape[1]
    for t in range(ticks):
        lo, count = active(t)
        with tick():
            for g, (grp, pair) in enumerate(zip(groups, wires)):
                a, b = max(lo, grp.first), min(lo + count, grp.first + grp.count)
                if a < b:
                    if g < len(hops):
                        hops[g].before_write(t)
                    step_fn(pair[(t + 1) % 2], pair[t % 2], t, a, b - a)
            for g, h in enumerate(hops):
                runs = slot_runs(*carried(t, groups[g].first + groups[g].count - 1), W)
                if runs:
                    with hop():
                        h.copy(wires[g][t % 2][-1], wires[g + 1][t % 2][0], runs, t)
    for h in hops:
        h.finish()
    return ticks
