"""The port's spans on the profiler's timeline.

Tracing is on exactly while a torch profiler runs: an operator who runs an
entry point under ``torch.profiler.profile(activities=[CPU, CUDA])`` finds
the ``repro_torch.*`` spans on the same clock as the kernels, copies and
memsets the profiler records, so a gap in the device's work can be put down
to the program span the host was in. With no profiler running, a span site
costs one check of the profiler's state and enters nothing.

On one thread the spans nest strictly; every span of an entry-point call
sits under its root, ``repro_torch.<entry>``:

- ``repro_torch.resolve``: argument checks, placement, the tuner's lookups
  and the stripe plan;
- ``repro_torch.lookup``: the program's ``jitcache.get``, and under it
  ``repro_torch.build`` on a miss;
- ``repro_torch.buffers``: the input's packed view and the output's
  allocation (``streaming.Program.__call__``);
- ``repro_torch.wires``: the run's wires, allocated and zeroed
  (``pipeline.make_wires``);
- ``repro_torch.tick``: one a tick, around its launches (placed: and the
  copies along the chain);
- ``repro_torch.hop``: under a tick over a card layout, one a card
  boundary whose forward carried a chunk at that tick, around the host's
  side of its copies to the next card (``pipeline._run_grouped``; the
  bytes are ``pipeline.stats()["wire_bytes_hopped"]``);
- ``repro_torch.unpack``: the output's word view.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import Callable

import torch

_OFF = nullcontext()


def _off():
    return _OFF


def span(name: str):
    """``torch.profiler.record_function(name)`` while a torch profiler runs,
    else a shared context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spans(name: str) -> Callable:
    """A maker of ``name`` spans for a loop, the profiler's state read once:
    ``tick = spans(name)`` before the loop, ``with tick():`` in it."""
    if torch.autograd._profiler_enabled():
        return functools.partial(torch.profiler.record_function, name)
    return _off


def root(entry: str) -> Callable:
    """Decorator: each call of an entry point in its ``repro_torch.<entry>``
    span (``entry`` is the first element of its programs' ``jitcache`` keys)."""
    name = f"repro_torch.{entry}"

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
