"""Streaming super-chunk executor: archive objects larger than device memory.

An object's blocks are split along the word axis into fixed-width
**super-chunks**, each an independent stripe run through the same
pipeline schedule, so a 10 GB object archives through a card that holds a
few hundred MB of it at a time (Repair Pipelining, Li et al., PAPERS.md,
is the cross-stripe scheduling model).

* ``StreamPlan`` / ``plan_stream`` / ``estimate_stripe_bytes`` /
  ``superchunk_words_for`` / ``budget_from_env`` are the JAX package's host
  math, copied so that the same budget gives the same stripe width: the
  archive manifests record that geometry.
* ``Program`` is what a pipelined entry point caches per key
  (``repro_torch.core.jitcache``): its device product tables, frozen slot
  or row tables and tick loop. Called on a device-resident object it runs
  the ticks reading the object in place, with no graph and no copy. For a
  streamed run it keeps, per buffer slot, a device input and output
  stripe, pinned host staging for both, and one CUDA graph of the whole
  tick sequence over that slot's buffers (``kernel.Graph``), so a stripe
  costs one replay and none of the wrappers' Python.
* ``CardProgram`` is the program over a card layout: one resident input
  and output tensor a card, never streamed.
* ``execute`` drives the stripes double-buffered on CUDA streams: stripe
  s's host input is staged into pinned memory and copied in on a copy
  stream; its graph replays on the current stream after the copy's event;
  its result is copied out into pinned memory on a second copy stream; and
  ``put_stripe(s)`` runs only once that copy's event has completed. So the
  host reads stripe s+1 and writes stripe s-1 while stripe s computes.

Positionwise codes (RapidRAID, LRC) apply their generator per word, so the
stripe-wise concatenation is bit-identical to the monolithic call, and the
single-stripe plan is exactly the monolithic call.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from repro_torch.core import gf, pipeline, trace
from repro_torch.kernels.gf_encode import kernel

#: env knob that forces a small per-device streaming budget
BUDGET_ENV = "RAPIDRAID_STREAM_BUDGET_BYTES"
# the words' signed views of the same size, which torch copies at any stride
_SIGNED_WORD = {8: torch.int8, 16: torch.int16}


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """How one object's word axis splits into equal-width super-chunks.

    All stripes share ``sc_words`` (the program's static shape); the last
    stripe holds only ``tail_words`` valid words and is zero-padded up to
    ``sc_words`` on the way in, trimmed on the way out.
    """

    total_words: int          # words per block across the whole object
    sc_words: int             # words per block per super-chunk (stripe)
    num_superchunks: int
    tail_words: int           # valid words in the final stripe

    @property
    def streaming(self) -> bool:
        """False when the plan is the degenerate single-stripe identity."""
        return self.num_superchunks > 1 or self.tail_words != self.sc_words

    def stripe_words(self, s: int) -> int:
        """Valid (un-padded) words of stripe ``s``."""
        return (self.tail_words if s == self.num_superchunks - 1
                else self.sc_words)

    def stripe_span(self, s: int) -> tuple[int, int]:
        """[start, stop) valid word range of stripe ``s`` in the object."""
        start = s * self.sc_words
        return start, start + self.stripe_words(s)


def plan_stream(total_words: int, superchunk_words: int | None, *,
                l: int, num_chunks: int) -> StreamPlan:
    """Split ``total_words`` into stripes of at most ``superchunk_words``.

    The stripe width is rounded DOWN to whole pipeline granules
    (``LANES[l] * num_chunks`` words, so every stripe splits into
    ``num_chunks`` chunks of whole int32 lanes) and never below one
    granule. ``superchunk_words=None`` (or >= the object) is the
    single-stripe identity plan: no padding, no trimming.
    """
    if total_words < 1:
        raise ValueError(f"plan_stream: need at least 1 word, got {total_words}")
    granule = gf.LANES[l] * num_chunks
    if superchunk_words is None or superchunk_words >= total_words:
        return StreamPlan(total_words, total_words, 1, total_words)
    if superchunk_words < 1:
        raise ValueError(
            f"plan_stream: superchunk_words must be >= 1, got "
            f"{superchunk_words}")
    sc = max(granule, (superchunk_words // granule) * granule)
    sc = min(sc, total_words)
    num = -(-total_words // sc)
    tail = total_words - (num - 1) * sc
    return StreamPlan(total_words, sc, num, tail)


def estimate_stripe_bytes(code, sc_words: int, *, rows_in: int | None = None,
                          rows_out: int | None = None) -> int:
    """Modeled peak live device bytes for one stripe of the chain encode.

    The JAX package's model, kept as it is so that a budget gives the same
    stripe width in both packages: the (rows_in, W) input words, a placed
    (n, max_blocks, W) packed local view, the packed codeword and the
    (rows_out, W) result, times 2 for two stripes in flight. It over-counts
    the port, which reads the blocks in place and keeps its result packed
    (``measure_footprint`` gives the real number on the card).
    """
    wb = code.l // 8
    rows_in = code.k if rows_in is None else rows_in
    rows_out = code.n if rows_out is None else rows_out
    max_b = max((len(b) for b in getattr(code, "place", [(0,)])), default=1)
    packed = 4 * (sc_words // gf.LANES[code.l] + 1)
    per_stripe = (rows_in * sc_words * wb            # input words
                  + code.n * max_b * packed          # placed + packed local
                  + code.n * packed                  # packed codeword
                  + rows_out * sc_words * wb)        # unpacked output
    return 2 * per_stripe


def superchunk_words_for(footprint_bytes: int, code, num_chunks: int) -> int:
    """Largest stripe width whose modeled device footprint fits the budget,
    floored to one pipeline granule (``estimate_stripe_bytes`` inverted)."""
    granule = gf.LANES[code.l] * num_chunks
    lo, hi = granule, granule
    while estimate_stripe_bytes(code, hi * 2) <= footprint_bytes:
        hi *= 2
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if estimate_stripe_bytes(code, mid) <= footprint_bytes:
            lo = mid
        else:
            hi = mid - 1
    return max(granule, (lo // granule) * granule)


def budget_from_env(default: int | None = None) -> int | None:
    """A forced streaming budget (``RAPIDRAID_STREAM_BUDGET_BYTES``)."""
    raw = os.environ.get(BUDGET_ENV)
    return int(raw) if raw else default


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


class Program:
    """One pipelined entry point's cached state for one key.

    ``ticks(src, out, wires)`` runs the whole tick sequence: ``src`` the
    packed int32 input (``in_lead`` + (lanes,)), read in place, ``out`` the
    packed output (``out_lead`` + (lanes,)), written in place, and
    ``wires`` the two wire buffers of shape ``wire_shape`` (None: fresh
    zeroed ones), or with a ``placement`` (the device of each chain
    position, ``pipeline.position_devices``) each position's pair
    (``pipeline.placed_wires``). A ``wire_shape`` of None: the ticks keep
    no wires the caller could hold (an unplaced decode or repair, whose
    sums never leave the kernel on the card), and ``wires`` is None. The
    builder closes it over what does not depend on the data: the product
    tables on ``device``, the frozen host tables.
    """

    def __init__(self, *, device: torch.device, l: int, sc_words: int,
                 in_lead: tuple[int, ...], out_lead: tuple[int, ...],
                 wire_shape: tuple[int, ...] | None, ticks: Callable, placement=None):
        self.device = device
        self.l = l
        self.sc_words = sc_words
        self.in_lead = tuple(in_lead)
        self.out_lead = tuple(out_lead)
        self.wire_shape = None if wire_shape is None else tuple(wire_shape)
        self.ticks = ticks
        self.placement = placement
        self._stripes: dict[int, _Stripes] = {}

    def _cache_size(self) -> int:
        """Signatures this program was built or captured for
        (``jitcache.compile_counts``): 1, plus one for each streamed depth
        past the first whose graphs it captured."""
        return max(1, len(self._stripes))

    @property
    def in_shape(self) -> tuple[int, ...]:
        return self.in_lead + (self.sc_words,)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The monolithic run: words ``in_shape`` on the program's device,
        read in place -> words ``out_lead + (sc_words,)`` on the device."""
        if tuple(x.shape) != self.in_shape or x.device != self.device:
            raise ValueError(f"program input {tuple(x.shape)} on {x.device}, want "
                             f"{self.in_shape} on {self.device}")
        with trace.span("repro_torch.buffers"):
            src = gf.pack_u32(x, self.l)
            out = torch.empty(self.out_lead + (src.shape[-1],), dtype=torch.int32,
                              device=self.device)
        self.ticks(src, out, None)
        with trace.span("repro_torch.unpack"):
            return gf.unpack_u32(out, self.l)

    def stripes(self, depth: int) -> "_Stripes":
        """The streamed run's buffers and graphs for ``depth`` stripes in
        flight behind the one computing, made at first use."""
        st = self._stripes.get(depth)
        if st is None:
            st = self._stripes[depth] = _Stripes(self, depth)
        return st


class CardProgram:
    """A program over a card layout (``storage.chain.CardLayout``): its input
    and output are one resident tensor a card. ``ticks(srcs, outs, wires)``
    runs the tick sequence over the cards' packed inputs (``in_leads[c]`` +
    (lanes,), read in place) and outputs (``out_leads[c]`` + (lanes,),
    written in place), with wires made a call (``wires`` None). It has no
    stripes: a resident batch is not streamed."""

    def __init__(self, *, cards, l: int, sc_words: int, in_leads, out_leads,
                 ticks: Callable):
        self.cards = tuple(cards)
        self.l = l
        self.sc_words = sc_words
        self.in_leads = tuple(tuple(x) for x in in_leads)
        self.out_leads = tuple(tuple(x) for x in out_leads)
        self.ticks = ticks

    def _cache_size(self) -> int:
        return 1

    def __call__(self, xs) -> list[torch.Tensor]:
        """Words ``in_leads[c] + (sc_words,)`` on card c, one tensor a card,
        read in place -> words ``out_leads[c] + (sc_words,)`` on card c."""
        shapes = [lead + (self.sc_words,) for lead in self.in_leads]
        if len(xs) != len(self.cards) or any(
                tuple(x.shape) != shape or x.device != d
                for x, shape, d in zip(xs, shapes, self.cards)):
            raise ValueError(f"program inputs {[(tuple(x.shape), str(x.device)) for x in xs]}, "
                             f"want {[(s, str(d)) for s, d in zip(shapes, self.cards)]}")
        with trace.span("repro_torch.buffers"):
            srcs = [gf.pack_u32(x, self.l) for x in xs]
            outs = [torch.empty(lead + (src.shape[-1],), dtype=torch.int32, device=d)
                    for lead, src, d in zip(self.out_leads, srcs, self.cards)]
        self.ticks(srcs, outs, None)
        with trace.span("repro_torch.unpack"):
            return [gf.unpack_u32(out, self.l) for out in outs]


class _Stripes:
    """A program's streamed-run state on the card: ``depth + 1`` buffer
    slots (device input and output stripe, pinned host staging of each),
    one set of wires they share where the program keeps wires (the slots'
    graphs run one after another on one stream), one captured graph a
    slot, two copy streams and each slot's events. A graph cannot span devices: a program whose placement
    puts a position on another device than its own captures none, and its
    slots run the ticks eagerly. The program owns every buffer for its lifetime, so no
    tensor is freed while a copy or a replay on another stream may still
    use it; ``run`` waits for every stripe's last copy before it returns."""

    def __init__(self, program: Program, depth: int):
        dev, l = program.device, program.l
        lanes = program.sc_words // gf.LANES[l]
        self.slots = depth + 1
        in_shape, out_shape = program.in_lead + (lanes,), program.out_lead + (lanes,)
        self.d_in = [torch.zeros(in_shape, dtype=torch.int32, device=dev)
                     for _ in range(self.slots)]
        self.d_out = [torch.zeros(out_shape, dtype=torch.int32, device=dev)
                      for _ in range(self.slots)]
        self.wires = (None if program.wire_shape is None else
                      pipeline.make_wires(program.wire_shape, dev, program.placement))
        devices = {dev} | set(program.placement or ())
        self.h_in = [torch.zeros(in_shape, dtype=torch.int32, pin_memory=True)
                     for _ in range(self.slots)]
        self.h_out = [torch.zeros(out_shape, dtype=torch.int32, pin_memory=True)
                      for _ in range(self.slots)]
        self.l = l
        self.h_out_words = [h.numpy().view(gf.WORD_DTYPE[l]) for h in self.h_out]
        # warm the kernels (library, first use of each instance) outside the
        # capture, then capture the tick sequence once a slot
        program.ticks(self.d_in[0], self.d_out[0], self.wires)
        for d in devices:
            torch.cuda.synchronize(d)
        self.graphs = None if len(devices) > 1 else [kernel.Graph(
            lambda i=i: program.ticks(self.d_in[i], self.d_out[i], self.wires), dev)
            for i in range(self.slots)]
        self.program = program
        self.h2d = torch.cuda.Stream(dev)
        self.d2h = torch.cuda.Stream(dev)
        self.in_done = [torch.cuda.Event() for _ in range(self.slots)]
        self.computed = [torch.cuda.Event() for _ in range(self.slots)]
        self.out_done = [torch.cuda.Event() for _ in range(self.slots)]
        self.device = dev

    def _stage(self, i: int, x) -> None:
        """Host stripe ``x`` (words, (..., w) with w <= sc_words) into slot
        i's pinned input, zero-padded to the stripe width. One torch copy
        through signed views of the words on both sides takes any width,
        start or stride and spreads over the host's threads (numpy's copy
        takes one)."""
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        x = np.asarray(x)
        w = x.shape[-1]
        dst = self.h_in[i].view(_SIGNED_WORD[self.l])
        dst[..., :w].copy_(torch.from_numpy(x.view(f"i{self.l // 8}")))
        dst[..., w:] = 0

    def run(self, num: int, get_stripe: Callable, put_stripe: Callable) -> None:
        cur = torch.cuda.current_stream(self.device)
        self.h2d.wait_stream(cur)
        self.d2h.wait_stream(cur)
        pending: collections.deque = collections.deque()
        try:
            for s in range(num):
                i = s % self.slots      # free: stripe s - slots has retired
                self._stage(i, get_stripe(s))
                with torch.cuda.stream(self.h2d):
                    self.d_in[i].copy_(self.h_in[i], non_blocking=True)
                    self.in_done[i].record(self.h2d)
                cur.wait_event(self.in_done[i])
                if self.graphs is None:
                    self.program.ticks(self.d_in[i], self.d_out[i], self.wires)
                else:
                    self.graphs[i].replay()
                self.computed[i].record(cur)
                self.d2h.wait_event(self.computed[i])
                with torch.cuda.stream(self.d2h):
                    self.h_out[i].copy_(self.d_out[i], non_blocking=True)
                    self.out_done[i].record(self.d2h)
                pending.append(s)
                while len(pending) >= self.slots:
                    s0 = pending.popleft()
                    self.out_done[s0 % self.slots].synchronize()
                    put_stripe(s0, self.h_out_words[s0 % self.slots])
            while pending:
                s0 = pending.popleft()
                self.out_done[s0 % self.slots].synchronize()
                put_stripe(s0, self.h_out_words[s0 % self.slots])
        finally:   # a stripe still in flight after a raise keeps no buffer busy
            for s0 in pending:
                self.out_done[s0 % self.slots].synchronize()


# ---------------------------------------------------------------------------
# the double-buffered executor
# ---------------------------------------------------------------------------


def execute(plan: StreamPlan, program: Program,
            get_stripe: Callable[[int], np.ndarray],
            put_stripe: Callable[[int, np.ndarray], None],
            *, depth: int = 1) -> None:
    """Drive every stripe of ``plan`` through ``program``, double-buffered.

    ``get_stripe(s)`` gives stripe s's host input words (numpy or a CPU
    tensor, ``in_lead`` + (w,) with w at most the stripe width; a shorter
    stripe is zero-padded); ``put_stripe(s, out)`` consumes the result
    words, ``out_lead`` + (sc_words,) (the caller trims the tail). On the
    card, ``out`` is the program's pinned buffer, valid until
    ``put_stripe`` returns, and ``depth`` stripes stay in flight behind the
    one being retired; results retire strictly in stripe order. On the CPU
    each stripe runs the ticks' plain versions in turn.
    """
    if depth < 1:
        raise ValueError(f"execute: depth must be >= 1, got {depth}")
    if program.device.type == "cuda":
        program.stripes(depth).run(plan.num_superchunks, get_stripe, put_stripe)
        return
    for s in range(plan.num_superchunks):
        x = np.asarray(get_stripe(s))
        stripe = np.zeros(x.shape[:-1] + (plan.sc_words,), x.dtype)
        stripe[..., :x.shape[-1]] = x
        put_stripe(s, program(torch.from_numpy(stripe)).numpy())


def run_words(program: Program, data, plan: StreamPlan, *,
              sink: Callable[[int, np.ndarray], None] | None = None,
              depth: int = 1):
    """Stream a word array through ``program`` stripe by stripe.

    With the identity plan this is exactly ``program(data)`` on the
    program's device (``data`` already there): same program, same output
    tensor, or ``sink(0, words)`` of it on the host and None. Otherwise
    ``data`` (..., total_words) is a host array or CPU tensor sliced along
    its last axis, and the trimmed results are either assembled into one
    (..., total_words) CPU tensor of words (returned) or handed to
    ``sink(s, words)`` per stripe (returns None): the bounded-memory path,
    where no full-object output buffer ever exists.
    """
    if not plan.streaming:
        out = program(data)
        if sink is None:
            return out
        sink(0, out.cpu().numpy())
        return None

    data = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    out_full: np.ndarray | None = None

    def get_stripe(s: int) -> np.ndarray:
        lo, hi = plan.stripe_span(s)
        return data[..., lo:hi]

    def put_stripe(s: int, out: np.ndarray) -> None:
        nonlocal out_full
        out = out[..., :plan.stripe_words(s)]
        if sink is not None:
            sink(s, out)
            return
        if out_full is None:
            out_full = np.empty(out.shape[:-1] + (plan.total_words,), dtype=out.dtype)
        lo, hi = plan.stripe_span(s)
        out_full[..., lo:hi] = out

    execute(plan, program, get_stripe, put_stripe, depth=depth)
    return None if sink is not None else torch.from_numpy(out_full)


def measure_footprint(fn: Callable, *sample_args) -> int | None:
    """Peak device bytes that ``fn(*sample_args)`` allocates above what was
    allocated before it (``torch.cuda.max_memory_allocated``): one stripe
    run from a program not yet built counts its buffers, wires, tables and
    graphs. Returns None on the CPU (no device allocator to read)."""
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn(*sample_args)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base
