"""GPipe-style pipeline parallelism on the same chain scheduler as the
archival tier (``repro_torch.core.pipeline``).

The paper's insight — stream chunks through a chain of nodes, each
combining what it holds with what arrives — is pipeline parallelism
applied to storage. Here the roles map back: chain position -> pipeline
stage, chunk -> microbatch, running GF combination -> activations. Stage s
runs on the s-th device of the mesh's ``stage`` axis and processes
microbatch m at tick m + s (``pipeline.active_nodes``, the chain's ticks);
its activations move to the next stage's device, as ``lax.ppermute``
forwards them in the JAX package. One process drives every stage, as the
JAX package's single controller does; the backward pass is
``torch.autograd`` through the stages and the copies between them, so the
gradients land on the stacked parameters as ``jax.grad`` gives them. The
output comes back on ``x``'s device (the JAX package's masked ``psum``
broadcast of the last stage's result).

Usage:

    stage_params: tree of tensors stacked on a leading [n_stages] axis
    fn = make_pipeline_fn(stage_fn, mesh, n_micro)
    y = fn(stage_params, x)        # x (global_batch, ...) -> same shape
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import pipeline as sched
from repro_torch.storage import object_store

AXIS = "stage"


def stage_devices(mesh) -> list[torch.device]:
    """The device of each stage: the mesh's devices along ``stage``, at
    index 0 of every other axis."""
    if AXIS not in mesh.axis_names:
        raise ValueError(f"the mesh has no {AXIS!r} axis: {mesh.axis_names}")
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index(AXIS), 0)
    return [torch.device(d) for d in devs.reshape(devs.shape[0], -1)[:, 0]]


def make_pipeline_fn(stage_fn: Callable, mesh, n_micro: int):
    """Build a pipelined apply: (stacked_params, x) -> y.

    ``stage_fn(params_one_stage, x_mb) -> y_mb`` must preserve x's shape
    (a residual-block stack). x (B, ...) is split into ``n_micro``
    microbatches along the batch axis; stage s's slice of every stacked
    leaf is copied to its device (a copy autograd sees through).
    """
    devices = stage_devices(mesh)
    n = len(devices)

    def apply(stacked_params, x):
        B = x.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        leaves, treedef = object_store.tree_flatten(stacked_params)
        leads = {a.shape[0] for a in leaves}
        if leads != {n}:
            raise ValueError(f"stacked params lead with {leads}, want {n} stages")
        params = [treedef.unflatten(a[s].to(devices[s]) for a in leaves) for s in range(n)]
        xs = x.reshape(n_micro, B // n_micro, *x.shape[1:])
        outs: list = [None] * n_micro
        wire: list = [None] * n          # the activation entering each stage
        for t in range(sched.num_ticks(n_micro, n)):
            lo, count = sched.active_nodes(t, n, n_micro)
            sent = {}
            for s in range(lo, lo + count):
                m = t - s
                y = stage_fn(params[s], xs[m].to(devices[0]) if s == 0 else wire[s])
                if s == n - 1:
                    outs[m] = y.to(x.device)
                else:                     # ppermute: stage s -> s + 1
                    sent[s + 1] = y.to(devices[s + 1])
            for s, y in sent.items():
                wire[s] = y
        return torch.stack(outs).reshape(B, *x.shape[1:])

    return apply


def pipeline_loss_fn(stage_fn: Callable, mesh, n_micro: int, loss_of: Callable):
    """Pipelined scalar loss: loss_of(y, target) of the pipelined apply."""
    apply = make_pipeline_fn(stage_fn, mesh, n_micro)

    def loss(stacked_params, x, target):
        return loss_of(apply(stacked_params, x), target)

    return loss
