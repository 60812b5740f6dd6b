"""Build, bind and launch the hand-written CUDA kernels in ``csrc/``.

``gf_tick.cu`` holds the pipeline ticks (``chain_tick``, ``repair_tick``) and
the whole unplaced encode, decode or repair chain in one launch
(``encode_chain``, ``repair_chain``),
``gf_mxu.cu`` the bit-lifted encode on the int8 tensor cores
(``gf_encode_mxu``), ``gf_module.cu`` the driver-API loader of the
per-matrix kernels, and ``gf_encode.cu`` the template of the
static-coefficient bit-plane encode (``gf_encode``).

The first three are compiled with ``nvcc`` for ``sm_90a``, one process per
source, all started together, and linked into a shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use,
from the sources in this package only, into ``build/repro_torch/`` at the
root of the checkout; the library's file name carries a hash of the
sources and flags, so a stale build is never loaded.

``gf_encode`` is built per (matrix, field), as the TPU kernel bakes its
matrix into its body: ``encode_source`` writes the matrix's terms into the
template, the toolkit's NVRTC compiles it at the first call with that
matrix, and the cubin is cached in memory and under
``build/repro_torch/gf_encode/`` by a hash of the source and flags. ``gf_encode.compiles`` counts the builds, ``compile_log`` keeps
each one's time and compiler output.

Each launch wrapper checks device, dtype (int32 lanes, or words and int8
for the bit-lift), shape and contiguity of every tensor and raises on
anything else, launches on PyTorch's current stream, allocates nothing, and
raises if the launch reports an error. Each keeps a plain-integer
``launches`` counter that it bumps where it launches its kernel, and
nowhere else; a ``Graph`` of captured launches adds them again at each
replay. Outputs are written in place into the caller's buffers.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import gf, pipeline

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "gf_tick.cu", CSRC / "gf_mxu.cu", CSRC / "gf_module.cu")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-lcuda")   # the driver API: TMA descriptors, per-matrix modules
SUPPORTED_L = (8, 16)
_MAX_GRID_YZ = 65535

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the build for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgf_tick-{h.hexdigest()[:16]}.so"


def build_shared(sources, path: Path) -> str:
    """Compile ``sources`` with nvcc, one process per source, all at once,
    and link them into the shared library ``path`` (written atomically);
    returns the compilers' output (the ``-Xptxas -v`` reports)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [str(Path(tmp) / f"{i}-{Path(src).stem}.o") for i, src in enumerate(sources)]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objs)]
        outs = [proc.communicate() for proc in procs]
        log = "".join(out + err for out, err in outs)
        for src, proc in zip(sources, procs):
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
        so = str(Path(tmp) / "lib.so")
        proc = subprocess.run([_nvcc(), "-o", so, *objs, *LINK_FLAGS],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(so, path)  # atomic: a concurrent build never sees half a file
    return log + proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        log = build_shared(SOURCES, path)
        path.with_suffix(".log").write_text(log)
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_chain_tick.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                  i32, i64, i64, i64, i64, i32, i32, i32, i32, vp]
    lib.gf_chain_tick.restype = i32
    lib.gf_repair_tick.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                   i32, i64, i64, i64, i64, i32, i32, i32, i32, i32, vp]
    lib.gf_repair_tick.restype = i32
    lib.gf_repair_chain.argtypes = [vp, vp, vp, vp, i32, i32, i32, i64, i64, i64, i32, i32, vp]
    lib.gf_repair_chain.restype = i32
    lib.gf_encode_chain.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, i64, i64, vp]
    lib.gf_encode_chain.restype = i32
    lib.gf_encode_mxu.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, i32, i32, vp]
    lib.gf_encode_mxu.restype = i32
    lib.gf_encode_mxu_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.gf_encode_mxu_smem_bytes.restype = i64
    lib.gf_module_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(vp)]
    lib.gf_module_load.restype = i32
    lib.gf_module_launch_encode.argtypes = [vp, vp, vp, i64, i32, i64, i32, vp]
    lib.gf_module_launch_encode.restype = i32
    lib.gf_copy_async.argtypes = [vp, vp, i64, vp]
    lib.gf_copy_async.restype = i32
    _lib = lib
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``) for the current build, if any."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _check_tensors(name: str, dtypes: dict | None = None, strided: tuple[str, ...] = (),
                   **tensors: torch.Tensor) -> torch.device:
    """Same CUDA device, the expected dtype (``dtypes[key]``, else int32)
    and contiguity for every tensor (for the ``strided`` ones, contiguous
    rows: a unit stride in the last dimension); returns the device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {device}")
    for key, t in tensors.items():
        want = (dtypes or {}).get(key, torch.int32)
        if t.dtype != want:
            raise ValueError(f"{name}: {key} must be {want}, got {t.dtype}")
        if key in strided:
            if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
                raise ValueError(f"{name}: the rows of {key} must be contiguous")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return device


def _check_tick(name: str, l: int, t: int, num_chunks: int, node_lo: int,
                node_count: int, n: int, n_obj: int, W: int, stagger: int, S: int,
                Bp: int) -> None:
    """The tick's geometry: the field, the chunking, the node range inside
    the chain, and the object window. Every node of the range must lie
    within the run's span at tick t: 0 <= t - i < (n_obj - 1) * stagger +
    num_chunks (for lockstep, stagger 0, that is: it has a chunk); with
    stagger > num_chunks a node inside the span may fall between two
    objects, and its blocks do nothing. The wire has one slot per object
    in lockstep, ``pipeline.window_size`` slots when staggered."""
    if l not in SUPPORTED_L:
        raise ValueError(f"{name}: unsupported field GF(2^{l})")
    if S < 1 or S * num_chunks != Bp:
        raise ValueError(f"{name}: chunk of {S} lanes x {num_chunks} chunks "
                         f"!= stream of {Bp} lanes")
    if not (0 <= node_lo and 1 <= node_count and node_lo + node_count <= n):
        raise ValueError(f"{name}: nodes [{node_lo}, {node_lo + node_count}) "
                         f"outside a chain of {n}")
    if stagger < 0:
        raise ValueError(f"{name}: stagger must be >= 0 (0: lockstep), got {stagger}")
    span = (n_obj - 1) * stagger + num_chunks
    if not (0 <= t - (node_lo + node_count - 1) and t - node_lo < span):
        raise ValueError(f"{name}: a node in [{node_lo}, {node_lo + node_count}) "
                         f"has no chunk at tick {t} of {n_obj} objects x "
                         f"{num_chunks} chunks at stagger {stagger}")
    want = n_obj if stagger == 0 else pipeline.window_size(num_chunks, n_obj, stagger)
    if W != want:
        raise ValueError(f"{name}: wires of {W} slots, want {want} for {n_obj} objects "
                         f"at stagger {stagger}")
    if W < 1 or W > _MAX_GRID_YZ:
        raise ValueError(f"{name}: {W} window slots exceed the grid")


def _raise_on(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")


TABLE_BYTES = 256             # byte values a product table holds
MAX_TICK_NODES = 256          # active nodes one tick launch takes
MAX_TICK_SLOTS = 512          # replica slots one chain_tick launch takes
MAX_CHAIN_NODES = 256         # chain positions one repair_chain launch takes
ENCODE_CACHES = 8             # lane caches an encode_chain block keeps at most


def _byte_tables(planes: np.ndarray, l: int) -> np.ndarray:
    """(..., l) uint32 packed planes -> (..., l // 8, 256) uint32: entry v of
    table j is the xor of planes 8j + b over the set bits b of v, so a
    word's products are the xor of its bytes' entries."""
    planes = planes.astype(np.uint32).reshape(planes.shape[:-1] + (l // 8, 8))
    bits = ((np.arange(TABLE_BYTES)[:, None] >> np.arange(8)) & 1).astype(np.uint32)
    return np.bitwise_xor.reduce(planes[..., None, :] * bits, axis=-1)


def _field_planes(name: str, l: int, *planes) -> list[np.ndarray]:
    """The bit-planes as int64, checked to be (..., l) words of GF(2^l)."""
    out = [np.asarray(p).astype(np.int64) for p in planes]
    if l not in SUPPORTED_L or any(p.shape[-1:] != (l,) for p in out):
        raise ValueError(f"{name}: planes {[p.shape for p in out]} must be "
                         f"(..., {l}) for a supported field")
    if any(p.min(initial=0) < 0 or p.max(initial=0) >= 1 << l for p in out):
        raise ValueError(f"{name}: planes must be words of GF(2^{l})")
    return out


def product_tables(bp_psi, bp_xi, l: int) -> np.ndarray:
    """The ``chain_tick`` operand: each slot's products, from its bit-planes.

    ``bp_psi`` / ``bp_xi`` (..., l) bit-plane constants (``c * alpha^b``, as
    ``gf.bitplane_table`` gives them) -> (..., l // 8, 256) uint32 with
    ``out[..., j, v] = xi * (v << 8j) | psi * (v << 8j) << 16``: a slot's
    products of byte j of a word, the kept one in the low half and the
    forwarded one in the high half. Entry v is the xor of the planes of v's
    set bits, so the tables compute exactly what the planes do.
    """
    psi, xi = _field_planes("product_tables", l, bp_psi, bp_xi)
    if psi.shape != xi.shape:
        raise ValueError(f"product_tables: planes {psi.shape}, {xi.shape} differ")
    return _byte_tables(xi | psi << 16, l)


def repair_packs(rows: int, l: int) -> int:
    """Row packs of ``repair_tables``: 32 // l rows share a table entry."""
    return -(-rows // (32 // l))


def repair_tables(bp, l: int) -> np.ndarray:
    """The ``repair_tick`` operand: each node's products, from its bit-planes.

    ``bp`` (..., rows, l) bit-plane constants of a node's coefficients
    (``D[r] * alpha^b``) -> (..., repair_packs(rows, l), l // 8, 256)
    uint32. One entry packs the products of ``32 // l`` rows: at GF(2^16)
    ``out[..., p, j, v] = D[2p] * (v << 8j) | D[2p+1] * (v << 8j) << 16``,
    at GF(2^8) ``out[..., p, 0, v] = xor_r D[4p+r] * v << 8r``; the rows
    past ``rows`` in the last pack are zero. Built from the planes by
    linearity, as ``product_tables`` is.
    """
    (bp,) = _field_planes("repair_tables", l, bp)
    if bp.ndim < 2 or bp.shape[-2] < 1:
        raise ValueError(f"repair_tables: planes {bp.shape} must be (..., rows, l)")
    per, rows = 32 // l, bp.shape[-2]
    packs = repair_packs(rows, l)
    padded = np.zeros(bp.shape[:-2] + (packs * per, l), np.int64)
    padded[..., :rows, :] = bp
    padded = padded.reshape(bp.shape[:-2] + (packs, per, l)) << (l * np.arange(per))[:, None]
    return _byte_tables(np.bitwise_or.reduce(padded, axis=-2), l)


def _check_slots(name: str, slots, n_blocks: int) -> np.ndarray:
    """The slot table as (n, max_b) int32 on the host, each a block index in
    [0, n_blocks) or -1 (no block)."""
    slots = np.asarray(slots)
    if (slots.ndim != 2 or not 1 <= slots.shape[1] <= MAX_TICK_SLOTS
            or slots.dtype.kind not in "iu"):
        raise ValueError(f"{name}: slots {slots.shape} must be (n, max_b) integers, "
                         f"1 <= max_b <= {MAX_TICK_SLOTS}")
    if slots.size and (slots.min() < -1 or slots.max() >= n_blocks):
        raise ValueError(f"{name}: slots must be block indices below {n_blocks} or -1")
    return np.ascontiguousarray(slots, dtype=np.int32)


def _check_shard_rows(name: str, shard_rows, n_rows: int) -> np.ndarray:
    """The row table as (n,) int32 on the host, each a row in [0, n_rows)."""
    rows = np.asarray(shard_rows)
    if rows.ndim != 1 or rows.size < 1 or rows.dtype.kind not in "iu":
        raise ValueError(f"{name}: shard_rows {rows.shape} must be (n,) integers")
    if rows.min() < 0 or rows.max() >= n_rows:
        raise ValueError(f"{name}: shard_rows must be rows below {n_rows}")
    return np.ascontiguousarray(rows, dtype=np.int32)


_CHECKED_TABLES: dict[int, tuple] = {}   # id -> (table, bound, checked copy)


def _checked_table(check, name: str, table, bound: int) -> np.ndarray:
    """``check(name, table, bound)``, done once for a frozen table: the
    entry points pass the same read-only host table (cached per code, plan
    or chain length) to every tick, and a min/max on every call is host
    time each launch pays. A table counts as frozen when it is a numpy array
    that owns its data and is not writeable; it must not be unfrozen."""
    hit = _CHECKED_TABLES.get(id(table))
    if hit is not None and hit[0] is table and hit[1] == bound:
        return hit[2]
    checked = check(name, table, bound)
    if isinstance(table, np.ndarray) and table.base is None and not table.flags.writeable:
        if len(_CHECKED_TABLES) >= 1024:
            _CHECKED_TABLES.clear()
        _CHECKED_TABLES[id(table)] = (table, bound, checked)
    return checked


def encode_plan(slots) -> tuple[np.ndarray, int]:
    """The ``encode_chain`` kernel's walk of an (n, max_b) slot table: a
    (terms, 5) int32 plan, each node's terms in chain order, and the number
    of lane caches it keeps, at most ``ENCODE_CACHES``. A term is a slot
    that holds a block: (its flat index i * max_b + s into the tables, the
    block, the cache it reads the block's lanes from or -1 for global
    memory, the cache it keeps them in for a later term or -1, 1 on its
    node's last term, else 0); a node that holds no block gets one term
    (-1, -1, -1, -1, 1). A block read again later is kept in the lowest
    free cache while one is free, and its cache is freed at its last read;
    a node's terms read their caches first, so a cache freed at a node
    serves the node's own new block: a block held by two nodes crosses HBM
    once, and the (16,11) code keeps 5 caches."""
    slots = np.asarray(slots, dtype=np.int32)
    left = collections.Counter(int(b) for b in slots.ravel() if b >= 0)  # reads to come
    held: dict[int, int] = {}
    free = list(range(ENCODE_CACHES))
    terms = []
    for i, row in enumerate(slots.tolist()):
        used = [(s, b) for s, b in enumerate(row) if b >= 0]
        used.sort(key=lambda sb: sb[1] not in held)          # cached reads first
        node = []
        for s, b in used:
            left[b] -= 1
            src = dst = -1
            if b in held:
                src = held[b] if left[b] else held.pop(b)
                if not left[b]:
                    free = sorted(free + [src])
            elif left[b] and free:
                held[b] = dst = free.pop(0)
            node.append([i * slots.shape[1] + s, b, src, dst, 0])
        node = node or [[-1, -1, -1, -1, 0]]
        node[-1][4] = 1
        terms += node
    plan = np.array(terms, dtype=np.int32).reshape(-1, 5)
    return plan, int(plan[:, 3].max(initial=-1)) + 1


class EncodePlan:
    """A slot table made ready for ``encode_chain``: ``slots`` the (n,
    max_b) int32 table on the host, each a block index below ``n_blocks``
    or -1; ``terms`` its ``encode_plan`` on ``device``; ``caches`` the lane
    caches the plan keeps. A program makes its plan once, when it is built,
    and holds it as long as it lives: a captured graph reads ``terms`` at
    its address."""

    def __init__(self, slots, n_blocks: int, device):
        self.slots = _check_slots("encode_chain", slots, n_blocks)
        self.n_blocks = n_blocks
        terms, self.caches = encode_plan(self.slots)
        self.terms = torch.from_numpy(terms).to(device)


def launch_ranges(node_lo: int, node_count: int, per: int) -> list[tuple[int, int]]:
    """The (first node, node count) of each launch of a tick over
    [node_lo, node_lo + node_count), at most ``per`` nodes a launch."""
    end = node_lo + node_count
    return [(lo, min(per, end - lo)) for lo in range(node_lo, end, per)]


def chain_tick(wire_in: torch.Tensor, wire_out: torch.Tensor, src: torch.Tensor,
               slots, out: torch.Tensor, tables: torch.Tensor, l: int, t: int,
               num_chunks: int, node_lo: int, node_count: int, stagger: int = 0) -> None:
    """One encode tick on the card (replaces ``chain_step_kernel``).

    Shapes: ``src`` (B_obj, R, Bp) the objects' packed blocks, read in
    place; ``slots`` (n, max_b) host integers, node i's slot s holding block
    ``slots[i, s]`` or nothing (-1), any max_b up to 512; ``out`` (n, B_obj,
    Bp), any strides with contiguous rows (a (B_obj, n, Bp) batch passes
    ``out.transpose(0, 1)`` and is written in place); ``tables`` (n, max_b,
    l // 8, 256) from ``product_tables``; ``wire_in`` (>= node_lo +
    node_count, W, S) with S * num_chunks == Bp; ``wire_out`` (n or n + 1,
    W, S). Node i of [node_lo, node_lo + node_count) reads ``wire_in[i]``,
    writes its chunk of ``out[i]`` and, where that row exists,
    ``wire_out[i + 1]``: an n-row ``wire_out`` drops the last node's wire,
    which no node reads.

    ``stagger`` 0 is lockstep: W == B_obj, slot w is object w, and every
    object is at chunk t - i. ``stagger`` s >= 1 staggers the objects'
    chains s ticks apart: W == ``pipeline.window_size(num_chunks, B_obj,
    s)``, node i works chunk t - i - b * s of each object b that has one,
    in wire slot b % W; slots with no such object do nothing.

    A launch takes at most ``min(256, 512 // max_b)`` nodes, since the slot
    table travels in its parameters; a tick over more nodes is several
    launches over node sub-ranges, and ``chain_tick.launches`` counts each.
    """
    device = _check_tensors("chain_tick", strided=("out",), wire_in=wire_in,
                            wire_out=wire_out, src=src, out=out, tables=tables)
    if src.dim() != 3:
        raise ValueError(f"chain_tick: src {tuple(src.shape)} must be (B_obj, R, Bp)")
    n_obj, R, Bp = src.shape
    slots = _checked_table(_check_slots, "chain_tick", slots, R)
    n, max_b = slots.shape
    S, W = wire_in.shape[-1], wire_in.shape[1] if wire_in.dim() == 3 else 0
    _check_tick("chain_tick", l, t, num_chunks, node_lo, node_count, n, n_obj, W,
                stagger, S, Bp)
    if out.shape != (n, n_obj, Bp) or tables.shape != (n, max_b, l // 8, TABLE_BYTES):
        raise ValueError(f"chain_tick: out {tuple(out.shape)} / tables "
                         f"{tuple(tables.shape)} do not match {n} nodes x "
                         f"{max_b} slots of src {tuple(src.shape)}")
    last = node_lo + node_count
    if (wire_in.dim() != 3 or wire_in.shape[0] < last
            or wire_out.dim() != 3 or wire_out.shape[0] not in (n, n + 1)
            or wire_out.shape[1:] != wire_in.shape[1:]):
        raise ValueError(f"chain_tick: wires {tuple(wire_in.shape)} -> "
                         f"{tuple(wire_out.shape)} do not fit nodes < {last} of {n}")
    if wire_in.data_ptr() == wire_out.data_ptr():
        raise ValueError("chain_tick: wire_in and wire_out must not alias")
    lib = load_library()
    per = min(MAX_TICK_NODES, MAX_TICK_SLOTS // max_b)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo, count in launch_ranges(node_lo, node_count, per):
            rc = lib.gf_chain_tick(wire_in.data_ptr(), wire_out.data_ptr(),
                                   src.data_ptr(), out.data_ptr(), tables.data_ptr(),
                                   slots.ctypes.data, l, max_b, W, n_obj, stagger,
                                   num_chunks, R, Bp, S, out.stride(0), out.stride(1), t,
                                   lo, count, wire_out.shape[0], stream)
            _raise_on("chain_tick", rc)
            chain_tick.launches += 1


chain_tick.launches = 0


def repair_tick(wire_in: torch.Tensor, wire_out: torch.Tensor,
                shards: torch.Tensor, shard_rows, out: torch.Tensor | None,
                tables: torch.Tensor, l: int, t: int, num_chunks: int,
                node_lo: int, node_count: int, head_zero: bool = False,
                stagger: int = 0, last_forwards: bool = False) -> None:
    """One decode or repair tick on the card (replaces ``repair_step_kernel``).

    Shapes: ``shards`` (R, B_obj, Bp) the callers' packed shards, read in
    place, any strides with contiguous rows (a (B_obj, R, Bp) batch passes
    ``shards.transpose(0, 1)``); ``shard_rows`` (n,) host integers, node
    i's shard being row ``shard_rows[i]``; ``tables`` (n,
    repair_packs(rows, l), l // 8, 256) from ``repair_tables``, node i's
    coefficients for each of the ``rows`` sums; ``out`` (B_obj, rows, Bp);
    ``wire_in`` and ``wire_out`` (n, W, rows, S) with S * num_chunks ==
    Bp. Node i adds its products to the partial sums in ``wire_in[i]`` and
    writes them to ``wire_out[i + 1]``, or, for the last node n - 1, to its
    chunk of ``out``. With ``head_zero`` the caller says ``wire_in[0]`` is
    zero (as the pipeline keeps it): node 0 starts from zero sums and that
    row is not read. ``stagger`` and W as in ``chain_tick``. With
    ``last_forwards`` node n - 1 forwards its sums to ``wire_out[n]`` like
    any other node (``wire_out`` then has n + 1 rows) and nothing is written
    to ``out``, which may be None: the launch of one chain position placed
    on its own device, whose successor is another launch
    (``pipeline.software_pipeline``'s ``placement``).

    Any rows: the tables are staged in shared memory in turn where they do
    not fit at once. A launch takes at most 256 nodes (the row table
    travels in its parameters); a tick over more nodes is several launches,
    and ``repair_tick.launches`` counts each.
    """
    if out is None and not last_forwards:
        raise ValueError("repair_tick: out is needed unless the last node forwards")
    outs = {} if out is None else {"out": out}
    device = _check_tensors("repair_tick", strided=("shards",), wire_in=wire_in,
                            wire_out=wire_out, shards=shards, tables=tables, **outs)
    if shards.dim() != 3 or wire_in.dim() != 4 or (out is not None and out.dim() != 3):
        raise ValueError(f"repair_tick: shards {tuple(shards.shape)} / wire_in "
                         f"{tuple(wire_in.shape)} must be (R, B_obj, Bp) / (n, W, rows, S)")
    R, n_obj, Bp = shards.shape
    rows = wire_in.shape[2]
    shard_rows = _checked_table(_check_shard_rows, "repair_tick", shard_rows, R)
    n = shard_rows.shape[0]
    S, W = wire_in.shape[-1], wire_in.shape[1]
    _check_tick("repair_tick", l, t, num_chunks, node_lo, node_count, n, n_obj, W,
                stagger, S, Bp)
    if (rows < 1 or (out is not None and out.shape != (n_obj, rows, Bp))
            or tables.shape != (n, repair_packs(rows, l), l // 8, TABLE_BYTES)):
        raise ValueError(f"repair_tick: tables {tuple(tables.shape)} / out "
                         f"{None if out is None else tuple(out.shape)} do not match {n} "
                         f"nodes of {rows} sums over shards {tuple(shards.shape)}")
    out_rows = n + 1 if last_forwards else n
    if wire_in.shape != (n, W, rows, S) or wire_out.shape != (out_rows, W, rows, S):
        raise ValueError(f"repair_tick: wires {tuple(wire_in.shape)} -> "
                         f"{tuple(wire_out.shape)} must be {(n, W, rows, S)} -> "
                         f"{(out_rows, W, rows, S)}")
    if wire_in.data_ptr() == wire_out.data_ptr():
        raise ValueError("repair_tick: wire_in and wire_out must not alias")
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo, count in launch_ranges(node_lo, node_count, MAX_TICK_NODES):
            rc = lib.gf_repair_tick(wire_in.data_ptr(), wire_out.data_ptr(),
                                    shards.data_ptr(), 0 if out is None else out.data_ptr(),
                                    tables.data_ptr(), shard_rows.ctypes.data, l, n, W,
                                    n_obj, stagger, num_chunks, rows, Bp, S,
                                    shards.stride(0), shards.stride(1), t, lo, count,
                                    int(head_zero), int(last_forwards), stream)
            _raise_on("repair_tick", rc)
            repair_tick.launches += 1


repair_tick.launches = 0


def check_chain(name: str, shards: torch.Tensor, shard_rows, out: torch.Tensor,
                tables: torch.Tensor, l: int, check_rows=_check_shard_rows) -> np.ndarray:
    """The operands of a whole decode or repair chain (``repair_chain``):
    the field, ``shards`` (R, B_obj, Bp), ``out`` (B_obj, rows, Bp) with
    B_obj, rows and Bp at least 1, ``tables`` (h, repair_packs(rows, l),
    l // 8, 256) for the h positions of ``shard_rows``; returns the row
    table as (h,) int32 on the host, from ``check_rows(name, shard_rows,
    R)``."""
    if l not in SUPPORTED_L:
        raise ValueError(f"{name}: unsupported field GF(2^{l})")
    if shards.dim() != 3 or out.dim() != 3 or tables.dim() != 4:
        raise ValueError(f"{name}: shards {tuple(shards.shape)} / out {tuple(out.shape)} / "
                         f"tables {tuple(tables.shape)} must be (R, B_obj, Bp) / "
                         f"(B_obj, rows, Bp) / (h, packs, l // 8, 256)")
    R, n_obj, Bp = shards.shape
    shard_rows = check_rows(name, shard_rows, R)
    h, rows = shard_rows.shape[0], out.shape[1]
    if (n_obj < 1 or Bp < 1 or rows < 1 or out.shape != (n_obj, rows, Bp)
            or tables.shape != (h, repair_packs(rows, l), l // 8, TABLE_BYTES)):
        raise ValueError(f"{name}: tables {tuple(tables.shape)} / out {tuple(out.shape)} do "
                         f"not match {h} positions of {rows} sums over shards "
                         f"{tuple(shards.shape)}")
    return shard_rows


def repair_chain(shards: torch.Tensor, shard_rows, out: torch.Tensor,
                 tables: torch.Tensor, l: int) -> None:
    """A whole unplaced decode or repair chain on the card, in one launch
    (replaces the chain of ``repair_step_kernel`` ticks).

    Operands as ``repair_tick``'s, with no wire, tick or window: ``shards``
    (R, B_obj, Bp) read in place, any strides with contiguous rows;
    ``shard_rows`` (h,) host integers, chain position p reading shard row
    ``shard_rows[p]``; ``tables`` (h, repair_packs(rows, l), l // 8, 256)
    from ``repair_tables``; ``out`` (B_obj, rows, Bp), contiguous. Writes
    ``out[b] = sum_p D_p * shards[shard_rows[p], b]``, the sums the last
    position of the pipelined chain writes, every position's products added
    in chain order, starting from zero sums.

    A launch takes at most 256 positions (the row table travels in its
    parameters); a longer chain is several launches, each after the first
    carrying on from the sums the one before left in ``out``, and
    ``repair_chain.launches`` counts each.
    """
    device = _check_tensors("repair_chain", strided=("shards",), shards=shards, out=out,
                            tables=tables)
    shard_rows = check_chain("repair_chain", shards, shard_rows, out, tables, l,
                             functools.partial(_checked_table, _check_shard_rows))
    _, n_obj, Bp = shards.shape
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo, count in launch_ranges(0, shard_rows.shape[0], MAX_CHAIN_NODES):
            rc = lib.gf_repair_chain(shards.data_ptr(), out.data_ptr(), tables.data_ptr(),
                                     shard_rows.ctypes.data, l, out.shape[1], n_obj, Bp,
                                     shards.stride(0), shards.stride(1), lo, count, stream)
            _raise_on("repair_chain", rc)
            repair_chain.launches += 1


repair_chain.launches = 0


def check_encode_chain(name: str, src: torch.Tensor, slots, out: torch.Tensor,
                       tables: torch.Tensor, l: int) -> np.ndarray:
    """The operands of a whole encode chain (``encode_chain``): the field,
    ``src`` (B_obj, R, Bp), ``out`` (n, B_obj, Bp) with B_obj, R and Bp at
    least 1, ``tables`` (n, max_b, l // 8, 256) for the n nodes of
    ``slots``, a slot table or an ``EncodePlan`` of blocks below R; returns
    the slot table as (n, max_b) int32 on the host."""
    if l not in SUPPORTED_L:
        raise ValueError(f"{name}: unsupported field GF(2^{l})")
    if src.dim() != 3 or out.dim() != 3 or tables.dim() != 4:
        raise ValueError(f"{name}: src {tuple(src.shape)} / out {tuple(out.shape)} / tables "
                         f"{tuple(tables.shape)} must be (B_obj, R, Bp) / (n, B_obj, Bp) / "
                         f"(n, max_b, l // 8, 256)")
    n_obj, R, Bp = src.shape
    if not isinstance(slots, EncodePlan):
        slots = _check_slots(name, slots, R)
    elif slots.n_blocks > R:
        raise ValueError(f"{name}: the plan's blocks lie below {slots.n_blocks}, "
                         f"src holds {R}")
    else:
        slots = slots.slots
    n, max_b = slots.shape
    if (n_obj < 1 or R < 1 or Bp < 1 or n < 1 or out.shape != (n, n_obj, Bp)
            or tables.shape != (n, max_b, l // 8, TABLE_BYTES)):
        raise ValueError(f"{name}: out {tuple(out.shape)} / tables {tuple(tables.shape)} do "
                         f"not match {n} nodes x {max_b} slots of src {tuple(src.shape)}")
    return slots


def encode_chain(src: torch.Tensor, slots, out: torch.Tensor, tables: torch.Tensor,
                 l: int) -> None:
    """A whole unplaced encode chain on the card, in one launch (replaces the
    chain of ``chain_step_kernel`` ticks).

    Operands as ``chain_tick``'s, with no wire, tick or window: ``src``
    (B_obj, R, Bp) the objects' packed blocks, read in place; ``slots``
    (n, max_b) host integers, node i's slot s holding block ``slots[i, s]``
    or nothing (-1), any max_b up to 512, or that table's ``EncodePlan`` on
    this card; ``out`` (n, B_obj, Bp), any strides with contiguous rows;
    ``tables`` (n, max_b, l // 8, 256) from ``product_tables``. Writes every
    node's codeword row, ``out[i, b] = x_i ^ sum_s xi[i, s] * block``, where
    x_0 = 0 and x_{i+1} = x_i ^ sum_s psi[i, s] * block: what the chain of
    ticks writes. A bare slot table is made into a plan for this call
    alone, copied to the card; a program passes the plan it holds, and
    copies nothing. ``encode_chain.launches`` counts each launch.
    """
    device = _check_tensors("encode_chain", strided=("out",), src=src, out=out, tables=tables)
    checked = check_encode_chain("encode_chain", src, slots, out, tables, l)
    plan = slots if isinstance(slots, EncodePlan) else EncodePlan(checked, src.shape[1], device)
    if plan.terms.device != device:
        raise ValueError(f"encode_chain: the plan lies on {plan.terms.device}, the "
                         f"tensors on {device}")
    n_obj, R, Bp = src.shape
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gf_encode_chain(src.data_ptr(), out.data_ptr(), tables.data_ptr(),
                                 plan.terms.data_ptr(), l, plan.terms.shape[0], n_obj, R,
                                 plan.caches, Bp, out.stride(0), out.stride(1), stream)
    _raise_on("encode_chain", rc)
    encode_chain.launches += 1


encode_chain.launches = 0


# ---------------------------------------------------------------------------
# gf_encode: one kernel per (matrix, field), compiled at first use
# ---------------------------------------------------------------------------

def copy_async(dst: torch.Tensor, src: torch.Tensor, stream: torch.cuda.Stream) -> None:
    """Copies ``src`` into ``dst`` on ``stream`` and orders it against
    nothing else: contiguous tensors of one dtype and size, on one card or
    on two (a peer copy), ``stream`` on either card. The caller orders the
    copy against the cards' streams with events. (``Tensor.copy_`` between
    two cards runs on the source card's current stream and makes both
    cards' current streams wait for each other first.)"""
    for name, x in (("dst", dst), ("src", src)):
        if x.device.type != "cuda" or not x.is_contiguous():
            raise ValueError(f"copy_async: {name} must be a contiguous CUDA tensor, "
                             f"got one on {x.device}")
    if dst.dtype != src.dtype or dst.shape != src.shape:
        raise ValueError(f"copy_async: {src.dtype} {tuple(src.shape)} into "
                         f"{dst.dtype} {tuple(dst.shape)}")
    lib = load_library()
    with torch.cuda.device(stream.device):
        _raise_on("copy_async", lib.gf_copy_async(dst.data_ptr(), src.data_ptr(),
                                                  src.numel() * src.element_size(),
                                                  stream.cuda_stream))


ENCODE_TEMPLATE = CSRC / "gf_encode.cu"
ENCODE_DIR = BUILD_DIR / "gf_encode"
ENCODE_ROW_GROUP = 16      # rows whose accumulators share one pass over the inputs
ENCODE_THREADS = 256
ENCODE_MAX_THREADS = 256   # the template's __launch_bounds__
NVRTC_FLAGS = ("--gpu-architecture=sm_90a", "--std=c++17", "--ptxas-options=-v")

_encode_fns: dict = {}                # (M bytes, shape, l, device index) -> function
compile_log: list[dict] = []          # one entry per matrix kernel built or loaded in this process


def encode_source(M, l: int, template: str | None = None) -> str:
    """The CUDA source of the ``gf_encode`` kernel specialised to M over GF(2^l).

    Every nonzero plane ``M[r, j] * alpha^b`` (``gf.bitplane_table``) is one
    term: ``T2`` folds two terms of a row, ``T1`` takes one. Masks are built
    only for the (input row, bit) pairs some row of the group uses, two at a
    time; rows go in groups of ``ENCODE_ROW_GROUP``. Each used input row is
    one case of a switch in a loop that the compiler unrolls; the case loads
    the next input row before its terms. Written so, the blocks stay in
    order instead of every load being hoisted to the top: on the card the
    (16,11) generator's kernel took 48 registers and 1.103 ms this way,
    against 74 registers and 1.283 ms written as one straight block, and
    the (12, 64) one built in 6.3 s without spills instead of 10.4 s with
    them (``chip_smoke.py``, PERF.md).
    """
    M = np.asarray(M)
    if M.ndim != 2 or l not in SUPPORTED_L:
        raise ValueError(f"encode_source: bad matrix {M.shape} or l={l}")
    planes = gf.bitplane_table(M, l)
    rows, k = M.shape
    defines = "\n".join((f"#define GF_L {l}", f"#define GF_ROWS {rows}", f"#define GF_K {k}",
                         f"#define GF_LSB 0x{gf.LSB_MASK[l]:08x}u"))
    body = []
    for r0 in range(0, rows, ENCODE_ROW_GROUP):
        group = range(r0, min(r0 + ENCODE_ROW_GROUP, rows))
        inputs = [j for j in range(k) if planes[group.start:group.stop, j].any()]
        body.append("  {")
        body += [f"    u32 a{r} = 0;" for r in group]
        if inputs:
            body.append(f"    u32 nx;\n    LOAD(nx, {inputs[0]})")
            body.append(f"#pragma unroll\n    for (int s = 0; s < {len(inputs)}; ++s) {{")
            body.append("      const u32 v = nx;\n      switch (s) {")
        for s, j in enumerate(inputs):
            body.append(f"        case {s}: {{")
            if s + 1 < len(inputs):
                body.append(f"          LOAD(nx, {inputs[s + 1]})")
            used = [b for b in range(l) if planes[group.start:group.stop, j, b].any()]
            for p in range(0, len(used), 2):
                pair = used[p:p + 2]
                for b in pair:
                    body.append(f"          MASK(m{j}_{b}, {b})")
                for r in group:
                    terms = [f"m{j}_{b}, 0x{int(planes[r, j, b]):x}u" for b in pair
                             if planes[r, j, b]]
                    if terms:
                        body.append(f"          T{len(terms)}(a{r}, {', '.join(terms)})")
            body.append("        } break;")
        if inputs:
            body.append("      }\n    }")
        body += [f"    STORE({r}, a{r})" for r in group]
        body.append("  }")
    src = ENCODE_TEMPLATE.read_text() if template is None else template
    return src.replace("@DEFINES@", defines).replace("@BODY@", "\n".join(body))


def encode_key(M, l: int, template: str | None = None,
               flags: tuple[str, ...] = NVRTC_FLAGS) -> str:
    """Cache key of a specialised kernel: a hash of its source (M, l, the
    template) and the compiler flags."""
    return _source_key(encode_source(M, l, template), flags)


def _source_key(src: str, flags: tuple[str, ...]) -> str:
    h = hashlib.sha256(src.encode())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:20]


def _nvrtc() -> ctypes.CDLL:
    """The CUDA toolkit's NVRTC library (beside the nvcc that builds the rest)."""
    dirs = [Path(os.environ[v]) / "lib64" for v in ("CUDA_HOME", "CUDA_PATH") if v in os.environ]
    try:
        dirs.append(Path(_nvcc()).resolve().parents[1] / "lib64")
    except RuntimeError:
        pass
    dirs.append(Path("/usr/local/cuda/lib64"))
    for d in dirs:
        for cand in sorted(d.glob("libnvrtc.so*")):
            if "builtins" not in cand.name:
                try:
                    return ctypes.CDLL(str(cand))
                except OSError:
                    continue
    raise RuntimeError(f"libnvrtc not found in {[str(d) for d in dirs]}: the per-matrix "
                       f"gf_encode kernels cannot be built")


def _nvrtc_compile(nvrtc: ctypes.CDLL, src: str) -> tuple[bytes, str]:
    prog = ctypes.c_void_p()
    rc = nvrtc.nvrtcCreateProgram(ctypes.byref(prog), src.encode(), b"gf_encode.cu", 0,
                                  None, None)
    if rc:
        raise RuntimeError(f"gf_encode: nvrtcCreateProgram failed ({rc})")
    try:
        opts = (ctypes.c_char_p * len(NVRTC_FLAGS))(*(f.encode() for f in NVRTC_FLAGS))
        rc = nvrtc.nvrtcCompileProgram(prog, len(NVRTC_FLAGS), opts)
        size = ctypes.c_size_t()
        nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        nvrtc.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        if rc:
            raise RuntimeError(f"gf_encode: NVRTC failed ({rc}):\n{log}")
        nvrtc.nvrtcGetCUBINSize(prog, ctypes.byref(size))
        cubin = ctypes.create_string_buffer(size.value)
        rc = nvrtc.nvrtcGetCUBIN(prog, cubin)
        if rc:
            raise RuntimeError(f"gf_encode: nvrtcGetCUBIN failed ({rc})")
        return cubin.raw, log
    finally:
        nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))


def _encode_cubin(M: np.ndarray, l: int) -> tuple[bytes, dict]:
    """The cubin of M's kernel: from the disk cache, else compiled with NVRTC
    and cached."""
    src = encode_source(M, l)
    key = _source_key(src, NVRTC_FLAGS)
    path = ENCODE_DIR / f"gf_encode-{key}.cubin"
    info = {"key": key, "rows": M.shape[0], "k": M.shape[1], "l": l}
    if path.exists():
        log = path.with_suffix(".log")
        return path.read_bytes(), {**info, "route": "disk",
                                   "log": log.read_text() if log.exists() else ""}
    ENCODE_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cubin, log = _nvrtc_compile(_nvrtc(), src)
    seconds = time.perf_counter() - t0
    gf_encode.compiles += 1
    path.with_suffix(".log").write_text(log)
    fd, tmp = tempfile.mkstemp(suffix=".cubin", dir=ENCODE_DIR)
    with os.fdopen(fd, "wb") as f:
        f.write(cubin)
    os.replace(tmp, path)  # atomic, as for the library
    return cubin, {**info, "route": "nvrtc", "compile_s": seconds, "log": log}


def _encode_fn(M: np.ndarray, l: int, device: torch.device) -> int:
    M = np.ascontiguousarray(M, dtype=np.int64)
    mkey = (M.tobytes(), M.shape, l, device.index)
    fn = _encode_fns.get(mkey)
    if fn is not None:
        return fn
    t0 = time.perf_counter()
    cubin, info = _encode_cubin(M, l)
    lib = load_library()
    handle = ctypes.c_void_p()
    with torch.cuda.device(device):
        rc = lib.gf_module_load(cubin, b"gf_encode_kernel", ctypes.byref(handle))
    if rc:
        raise RuntimeError(f"gf_encode: loading the kernel of a {M.shape} matrix failed "
                           f"with CUDA driver error {rc}")
    info["first_use_s"] = time.perf_counter() - t0
    compile_log.append(info)
    _encode_fns[mkey] = handle.value
    return handle.value


def gf_encode(data: torch.Tensor, M, out: torch.Tensor, l: int,
              threads: int = ENCODE_THREADS) -> None:
    """Static-coefficient encode on the card (replaces ``gf_encode_kernel``).

    Shapes: ``data`` (O, k, Bp) packed lanes, ``M`` the (rows, k) GF(2^l)
    coefficients (host integers), ``out`` (O, rows, Bp). The first call
    with a matrix builds its kernel (``encode_source``; cached in memory
    and under ``build/repro_torch/gf_encode/``); ``threads`` (32..256, a
    multiple of 32) per block, one lane a thread.
    """
    device = _check_tensors("gf_encode", data=data, out=out)
    if l not in SUPPORTED_L:
        raise ValueError(f"gf_encode: unsupported field GF(2^{l})")
    M = np.asarray(M)
    if M.ndim != 2 or M.size == 0 or not np.issubdtype(M.dtype, np.integer):
        raise ValueError(f"gf_encode: coefficients {M.shape} must be a (rows, k) integer matrix")
    if M.min() < 0 or M.max() >= 1 << l:
        raise ValueError(f"gf_encode: coefficients outside GF(2^{l})")
    rows, k = M.shape
    if data.dim() != 3 or data.shape[1] != k or out.shape != (data.shape[0], rows, data.shape[2]):
        raise ValueError(f"gf_encode: data {tuple(data.shape)} / out {tuple(out.shape)} do not "
                         f"match a ({rows}, {k}) matrix")
    O, _, Bp = data.shape
    if threads % 32 or not 32 <= threads <= ENCODE_MAX_THREADS:
        raise ValueError(f"gf_encode: {threads} threads per block not a multiple of 32 "
                         f"in [32, {ENCODE_MAX_THREADS}]")
    if O < 1 or O > _MAX_GRID_YZ:
        raise ValueError(f"gf_encode: {O} objects exceed the grid")
    if Bp == 0:
        return
    fn = _encode_fn(M, l, device)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gf_module_launch_encode(fn, data.data_ptr(), out.data_ptr(), Bp, O, Bp,
                                         threads, stream)
    if rc:
        raise RuntimeError(f"gf_encode: launch failed with CUDA driver error {rc}")
    gf_encode.launches += 1


gf_encode.launches = 0
gf_encode.compiles = 0


# ---------------------------------------------------------------------------
# gf_encode_mxu: the bit-lift on the int8 tensor cores (wgmma)
# ---------------------------------------------------------------------------

def bitlift_matrix(M, l: int) -> np.ndarray:
    """Lift (rows, k) GF(2^l) coefficients to the (rows*l, k*l) F2 matrix (int8).

    bit_i(c * x) = xor_b bit_b(x) * bit_i(c * alpha^b), so
    ``out[r*l + i, j*l + b] = bit_i(M[r, j] * alpha^b)``.
    """
    planes = gf.bitplane_table(M, l).astype(np.int64)        # (rows, k, l_b)
    rows, k = planes.shape[:2]
    bits = (planes[..., None] >> np.arange(l)) & 1           # (rows, k, l_b, l_i)
    return bits.transpose(0, 3, 1, 2).reshape(rows * l, k * l).astype(np.int8)


def padded_bitlift(M, l: int) -> np.ndarray:
    """``bitlift_matrix`` zero-padded to whole 16 x 32 int8 fragments."""
    lifted = bitlift_matrix(M, l)
    R, K = lifted.shape
    out = np.zeros((-(-R // 16) * 16, -(-K // 32) * 32), dtype=np.int8)
    out[:R, :K] = lifted
    return out


MXU_MAX_SMEM = 232448   # shared memory one block may use on the H100 (227 KB)


def mxu_tiling(rows: int, k: int, l: int) -> tuple[int, int, int]:
    """(NT, n-tiles, K_pad) of the bit-lift: the lifted rows padded to a
    multiple of 64 and cut into n-tiles of NT (64, 128 or 256, wgmma's N),
    the lifted columns padded to K_pad, a multiple of wgmma's 32-byte K."""
    npad = -(-rows * l // 64) * 64
    nt = 256 if npad % 256 == 0 else 128 if npad % 128 == 0 else 64
    return nt, npad // nt, -(-k * l // 32) * 32


def mxu_row_order(rows: int, l: int) -> np.ndarray:
    """Lifted row held by each column n of the wgmma product.

    In an n-tile of NT columns, thread t of a quad holds accumulator columns
    8c + 2t + p; ordered q = 2c + p, they are the l bits (q % l) of its
    NT / (4l) output rows t * NT / (4l) + q // l. So a thread's registers
    hold whole output words."""
    nt, n_tiles, _ = mxu_tiling(rows, 1, l)
    n = np.arange(nt * n_tiles)
    tile, nn = np.divmod(n, nt)
    c, rem = np.divmod(nn, 8)
    t, p = np.divmod(rem, 2)
    rr, b = np.divmod(2 * c + p, l)
    return (tile * (nt // l) + t * (nt // (4 * l)) + rr) * l + b


def mxu_operand(M, l: int) -> np.ndarray:
    """The lifted matrix as ``gf_encode_mxu`` keeps it in shared memory.

    Rows in ``mxu_row_order``, zero-padded to n-tiles x NT rows and K_pad
    columns, stored K-major as wgmma's unswizzled core matrices of 8 rows x
    16 bytes: shape (K_pad / 32, n-tiles, NT / 8, 2, 8, 16) = (k-step,
    n-tile, 8-row group, 16-byte half of the k-step, row, byte), in memory
    order."""
    M = np.asarray(M)
    rows, k = M.shape
    nt, n_tiles, K_pad = mxu_tiling(rows, k, l)
    lifted = bitlift_matrix(M, l)
    full = np.zeros((nt * n_tiles, K_pad), dtype=np.int8)
    full[:rows * l, :k * l] = lifted
    A = full[mxu_row_order(rows, l)]
    img = A.reshape(nt * n_tiles // 8, 8, K_pad // 32, 2, 16).transpose(2, 0, 3, 1, 4)
    return np.ascontiguousarray(img).reshape(K_pad // 32, n_tiles, nt // 8, 2, 8, 16)


def mxu_operand_lifted(image: np.ndarray, rows: int, l: int) -> np.ndarray:
    """Inverse of ``mxu_operand``: the zero-padded lifted matrix in its
    natural row order, (n-tiles x NT, K_pad)."""
    ks, n_tiles, nt8 = image.shape[:3]
    npad, K_pad = n_tiles * nt8 * 8, ks * 32
    A = image.reshape(ks, npad // 8, 2, 8, 16).transpose(1, 3, 0, 2, 4).reshape(npad, K_pad)
    full = np.empty_like(A)
    full[mxu_row_order(rows, l)] = A
    return full


def mxu_smem_bytes(rows: int, k: int, l: int) -> int:
    """Shared memory one ``gf_encode_mxu`` block needs for a (rows, k) matrix
    (the library computes it, so it needs the card's build)."""
    nt, n_tiles, K_pad = mxu_tiling(rows, k, l)
    return int(load_library().gf_encode_mxu_smem_bytes(l, k, nt, n_tiles, K_pad))


def gf_encode_mxu(data: torch.Tensor, operand: torch.Tensor, out: torch.Tensor,
                  l: int) -> None:
    """Bit-lifted encode on the int8 tensor cores (replaces
    ``gf_encode_mxu_kernel``).

    Shapes: ``data`` (k, B) and ``out`` (rows, B) words (uint8 for GF(2^8),
    uint16 for GF(2^16)); ``operand`` the int8 ``mxu_operand`` of the
    (rows, k) matrix. Ragged B is zero-filled by the loads and masked in the
    stores. Raises, before launching, if the lifted matrix and the tile
    buffers exceed the 227 KB of shared memory a block may use.
    """
    word = gf.TORCH_WORD_DTYPE.get(l)
    if word is None:
        raise ValueError(f"gf_encode_mxu: unsupported field GF(2^{l})")
    device = _check_tensors("gf_encode_mxu", {"data": word, "out": word,
                                              "operand": torch.int8},
                            data=data, operand=operand, out=out)
    if data.dim() != 2 or out.dim() != 2 or operand.dim() != 6:
        raise ValueError("gf_encode_mxu: data and out must be 2-D, operand 6-D")
    k, B = data.shape
    rows = out.shape[0]
    if rows < 1 or k < 1 or out.shape[1] != B:
        raise ValueError(f"gf_encode_mxu: out {tuple(out.shape)} does not match data "
                         f"{tuple(data.shape)}")
    nt, n_tiles, K_pad = mxu_tiling(rows, k, l)
    if tuple(operand.shape) != (K_pad // 32, n_tiles, nt // 8, 2, 8, 16):
        raise ValueError(f"gf_encode_mxu: operand {tuple(operand.shape)} is not the "
                         f"mxu_operand of a ({rows}, {k}) matrix over GF(2^{l})")
    if B >= 1 << 31:
        raise ValueError(f"gf_encode_mxu: {B} words exceed the 2^31 TMA coordinates")
    smem = mxu_smem_bytes(rows, k, l)
    if smem > MXU_MAX_SMEM:
        raise ValueError(f"gf_encode_mxu: a ({rows}, {k}) matrix over GF(2^{l}) needs "
                         f"{smem} bytes of shared memory (lifted matrix and tile buffers); "
                         f"a block may use at most {MXU_MAX_SMEM} (227 KB)")
    if B == 0:
        return
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gf_encode_mxu(data.data_ptr(), out.data_ptr(), operand.data_ptr(),
                               l, rows, k, B, nt, n_tiles, K_pad, stream)
    if rc >= 10000:
        raise RuntimeError(f"gf_encode_mxu: building the TMA descriptor failed with "
                           f"CUDA driver error {rc - 10000}")
    _raise_on("gf_encode_mxu", rc)
    gf_encode_mxu.launches += 1


gf_encode_mxu.launches = 0

KERNELS = (chain_tick, repair_tick, repair_chain, encode_chain, gf_encode, gf_encode_mxu)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


class Graph:
    """Kernel launches captured once in a CUDA graph and replayed.

    ``run()`` is captured on a side stream (``torch.cuda.graph``); its
    kernels, buffers and table pointers are bound at capture, so the
    caller keeps every tensor it touches alive and in place, and warms the
    kernels (library load, first use of each instance) before. The
    wrappers' counters count what ``run()`` would launch while it is
    captured; those counts are taken back (capture launches nothing) and
    added again at each ``replay()``, which launches them all on the
    current stream. So ``launch_counts`` counts a replayed launch as any
    other.
    """

    def __init__(self, run, device: torch.device):
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                run()
        after = launch_counts()
        self.launches = {name: after[name] - before[name] for name in after}
        for fn in KERNELS:
            fn.launches -= self.launches[fn.__name__]

    def replay(self) -> None:
        self.graph.replay()
        for fn in KERNELS:
            fn.launches += self.launches[fn.__name__]
