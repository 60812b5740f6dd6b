"""Public tick ops: the CUDA kernel for CUDA tensors, the plain version for CPU.

``chain_tick`` / ``repair_tick`` run one pipeline tick over the node axis
(the form ``repro_torch.storage.chain`` drives). ``chain_step`` /
``repair_step`` keep the single-node shapes of the JAX package's ops at the
public boundary — one object, or a batch with a leading object axis — and
run as a one-node, one-chunk tick.

A tensor on the CPU takes the plain version in ``ref``; a tensor on a CUDA
device launches the kernel, and a failed build or launch raises. Nothing
falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gf_encode import kernel, ref


def _route(x: torch.Tensor, cuda_fn, cpu_fn):
    if x.device.type == "cuda":
        return cuda_fn
    if x.device.type == "cpu":
        return cpu_fn
    raise ValueError(f"no tick kernel for device {x.device}")


def chain_tick(wire_in, wire_out, local, out, bp_psi, bp_xi, l: int, t: int,
               num_chunks: int, node_lo: int, node_count: int) -> None:
    """One encode tick over nodes [node_lo, node_lo + node_count); see
    ``kernel.chain_tick`` for shapes. Writes ``out`` and ``wire_out`` in place."""
    fn = _route(local, kernel.chain_tick, ref.chain_tick_ref)
    fn(wire_in, wire_out, local, out, bp_psi, bp_xi, l, t, num_chunks,
       node_lo, node_count)


def repair_tick(wire_in, wire_out, local, out, bp, l: int, t: int,
                num_chunks: int, node_lo: int, node_count: int) -> None:
    """One decode tick over nodes [node_lo, node_lo + node_count); see
    ``kernel.repair_tick`` for shapes. Writes ``out`` or ``wire_out`` in place."""
    fn = _route(local, kernel.repair_tick, ref.repair_tick_ref)
    fn(wire_in, wire_out, local, out, bp, l, t, num_chunks, node_lo,
       node_count)


def chain_step(x_in: torch.Tensor, local: torch.Tensor, bp_psi: torch.Tensor,
               bp_xi: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-node RapidRAID chunk step, all int32 lanes.

    Single object (x_in (1, C), local (max_b, C)) or a batch of objects
    (x_in (O, 1, C), local (O, max_b, C)); ``bp_psi`` / ``bp_xi`` (max_b, l)
    bit-plane constants shared by the objects. Returns (c, x_out) shaped
    like ``x_in``.
    """
    single = local.dim() == 2
    if single:
        x_in, local = x_in[None], local[None]
    if local.dim() != 3:
        raise ValueError(f"chain_step: local {tuple(local.shape)} must be "
                         f"(max_b, C) or (O, max_b, C)")
    O, max_b, C = local.shape
    if tuple(x_in.shape) != (O, 1, C):
        raise ValueError(f"chain_step: x_in {tuple(x_in.shape)} must be {(O, 1, C)}")
    if bp_psi.shape != (max_b, l) or bp_xi.shape != (max_b, l):
        raise ValueError(f"chain_step: planes must be {(max_b, l)}")
    dev = local.device
    wire_out = torch.empty((2, O, C), dtype=torch.int32, device=dev)  # row 0 unused
    c = torch.empty((1, O, C), dtype=torch.int32, device=dev)
    chain_tick(x_in.contiguous().view(1, O, C), wire_out,
               local.contiguous()[None], c, bp_psi.contiguous()[None],
               bp_xi.contiguous()[None], l, 0, 1, 0, 1)
    c, xo = c.view(O, 1, C), wire_out[1].view(O, 1, C)
    return (c[0], xo[0]) if single else (c, xo)


def repair_step(x_in: torch.Tensor, local: torch.Tensor, bp: torch.Tensor,
                l: int) -> torch.Tensor:
    """Fused GF inner-product step (one helper's contribution), int32 lanes.

    Single object (x_in (rows, C), local (1, C)) or a batch
    (x_in (O, rows, C), local (O, 1, C)); ``bp`` (rows, l) bit-plane
    constants of the helper's coefficient column. Returns x_in ^ term.
    """
    single = x_in.dim() == 2
    if single:
        x_in, local = x_in[None], local[None]
    if x_in.dim() != 3:
        raise ValueError(f"repair_step: x_in {tuple(x_in.shape)} must be "
                         f"(rows, C) or (O, rows, C)")
    O, rows, C = x_in.shape
    if tuple(local.shape) != (O, 1, C):
        raise ValueError(f"repair_step: local {tuple(local.shape)} must be {(O, 1, C)}")
    if bp.shape != (rows, l):
        raise ValueError(f"repair_step: planes must be {(rows, l)}")
    dev = x_in.device
    # a one-node chain: node 0 is the last node, so it writes `out`, never the wire
    wire_out = torch.empty((1, O, rows, C), dtype=torch.int32, device=dev)
    out = torch.empty((O, rows, C), dtype=torch.int32, device=dev)
    repair_tick(x_in.contiguous()[None], wire_out, local.contiguous().view(1, O, C),
                out, bp.contiguous()[None], l, 0, 1, 0, 1)
    return out[0] if single else out
