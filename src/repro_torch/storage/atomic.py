"""Classical (atomic) erasure encoding — the paper's baseline (Fig. 1).

Two forms:

* ``encode_local``: the whole-object encode on ONE device (what the paper's
  single coding node executes; Table II's CPU-cost comparison). Static
  generator coefficients through the bit-plane ``gf_encode`` kernel.
* ``classical_distributed_encode``: the cluster-level flow — the k source
  blocks are gathered, the parities computed, and row i of the codeword is
  node i's block. On one card the gather is the identity: the codeword is
  the data rows followed by the parity rows, one ``gf_encode`` launch.

Entry points run on the card unless the caller passes ``device="cpu"``,
where the encode runs the kernel's plain PyTorch version.
``classical_distributed_encode(mesh=)`` (a ``DeviceMesh`` of n devices)
puts node i on the mesh's i-th device: the source blocks are gathered onto
each device that holds parity nodes, which computes the parities there
(one ``gf_encode`` launch a device), and each node's row is its own; the
codeword comes back on the first node's device.
"""
from __future__ import annotations

import torch

from repro_torch.core import gf
from repro_torch.core.classical import ClassicalRSCode
from repro_torch.core.codes import ErasureCode
from repro_torch.kernels.gf_encode import ops
from repro_torch.storage.chain import (_check_chunking, _resolve_device, _words,
                                       resolve_placement)


def encode_local(code, data_packed, device=None) -> torch.Tensor:
    """Single-device whole-object encode; (k, Bp) packed int32 -> (rows, Bp).

    For a classical code the systematic rows are free, so only the m parity
    rows are computed; for RapidRAID all n rows are (the paper's Table II
    accounting: both encode the same 704 MB object).
    """
    if isinstance(code, ClassicalRSCode):
        M = code.parity_matrix
    elif isinstance(code, ErasureCode):
        M = code.G  # any family's flattened generator (rows x sub_k)
    else:
        raise TypeError(type(code))
    dev = _resolve_device(device)
    return ops.encode_packed(M, torch.as_tensor(data_packed, device=dev), code.l)


def classical_distributed_encode(code: ClassicalRSCode, data, device=None,
                                 mesh=None) -> torch.Tensor:
    """data (k, B) words -> codeword (n, B) words: row i is node i's block,
    computed on the mesh's i-th device when a ``mesh`` is given."""
    what = "classical_distributed_encode"
    dev, placement, _ = resolve_placement(code.n, mesh, None, device, what)
    data = _words(data, code.l, code.k, what, dev)
    _check_chunking(data.shape[1], code.l, 1, what)
    packed = gf.pack_u32(data, code.l)
    if placement is None:
        parity = ops.encode_packed(code.parity_matrix, packed, code.l)
        return gf.unpack_u32(torch.cat([packed, parity]), code.l)
    parities = {d: ops.encode_packed(code.parity_matrix, packed.to(d), code.l)
                for d in dict.fromkeys(placement[code.k:])}     # the all-gather
    rows = [parities[d][j:j + 1].to(dev) for j, d in enumerate(placement[code.k:])]
    return gf.unpack_u32(torch.cat([packed] + rows), code.l)
