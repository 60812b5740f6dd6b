"""Device meshes: named axes over a row-major array of devices.

The JAX package runs single-controller: one process holds a ``Mesh`` over
``jax.devices()`` and places each chain position or parameter shard on one
of its devices. ``DeviceMesh`` is the port's counterpart over ``torch``
devices, also in one process. The same device may stand at several mesh
positions, so a mesh of n positions runs on one card as ``[cuda:0] * n``
(as the JAX tests build n host devices out of one CPU), and on a host with
several cards over each of them.

The builders are functions, never module-level constants, so importing
this module touches no device. They default to the visible CUDA devices;
an explicit ``devices=`` list (``["cpu"] * n`` in the tests) stands in for
the JAX package's forced host devices.

Production target of the sharding rules (``repro_torch.train.sharding``):
a (16, 16) (data, model) mesh, or (2, 16, 16) (pod, data, model) across
two pods, where ``pod`` acts as an outer data axis.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class DeviceMesh:
    """Axis names, a shape and a row-major array of ``torch.device``s.

    ``ids[i]`` is the index of flat entry i in the device list the mesh
    was drawn from (a JAX device's ``id``); by default ``range(size)``.
    Hashable and equal by content, so a program cache keys on it cheaply.
    """

    def __init__(self, axis_names, shape, devices, ids=None):
        self.axis_names = tuple(str(a) for a in axis_names)
        dims = tuple(int(s) for s in shape)
        flat = tuple(torch.device(d) for d in devices)
        if len(dims) != len(self.axis_names) or any(s < 1 for s in dims):
            raise ValueError(f"mesh shape {dims} does not fit axes {self.axis_names}")
        if len(flat) != math.prod(dims):
            raise ValueError(f"{len(flat)} devices for a mesh of shape {dims}")
        self.flat = flat
        self.ids = tuple(range(len(flat))) if ids is None else tuple(int(i) for i in ids)
        if len(self.ids) != len(flat):
            raise ValueError(f"{len(self.ids)} ids for {len(flat)} devices")
        self.shape = dict(zip(self.axis_names, dims))
        self.size = len(flat)

    @property
    def devices(self) -> np.ndarray:
        """The devices as an object array of the mesh's shape."""
        arr = np.empty(self.size, dtype=object)
        arr[:] = self.flat
        return arr.reshape(tuple(self.shape.values()))

    def _key(self) -> tuple:
        return (self.axis_names, tuple(self.shape.values()), self.flat, self.ids)

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and self._key() == other._key()

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, devices={[str(d) for d in self.flat]}, "
                f"ids={list(self.ids)})")


def visible_devices(kind: str = "cuda") -> list[torch.device]:
    """The devices a builder draws from by default: every visible card
    (none without CUDA), or the one host device for ``"cpu"``."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_list(devices) -> list[torch.device]:
    """``devices`` as torch devices, or the visible CUDA devices for None."""
    return visible_devices() if devices is None else [torch.device(d) for d in devices]


def make_production_mesh(multi_pod: bool = False, devices=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = device_list(devices)
    need = math.prod(shape)
    if len(devs) < need:
        raise ValueError(f"Number of devices {len(devs)} must be >= the product "
                         f"of mesh_shape {shape}")
    return DeviceMesh(axes, shape, devs[:need])


def make_local_mesh(data: int = 1, model: int = 1, devices=None) -> DeviceMesh:
    """Small mesh over the first data * model devices (tests / examples)."""
    devs = device_list(devices)
    need = data * model
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return DeviceMesh(("data", "model"), (data, model), devs[:need])


def mesh_tag(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
