"""Build, bind and launch the hand-written CUDA kernels in ``csrc/``.

``gf_tick.cu`` holds the pipeline ticks (``chain_tick``, ``repair_tick``),
``gf_encode.cu`` the static-coefficient bit-plane encode (``gf_encode``) and
``gf_mxu.cu`` the bit-lifted encode on the int8 tensor cores
(``gf_encode_mxu``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. The build runs at first
use, from the sources in this package only, into ``build/repro_torch/`` at
the root of the checkout; the library's file name carries a hash of the
sources and flags, so a stale build is never loaded.

Each launch wrapper checks device, dtype (int32 lanes, or words and int8
for the bit-lift), shape and contiguity of every tensor and raises on anything else, launches on PyTorch's current
stream, allocates nothing, and raises if the launch reports an error. Each
keeps a plain-integer ``launches`` counter that it bumps where it launches
its kernel, and nowhere else. Outputs are written in place into the
caller's buffers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import gf

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "gf_tick.cu", CSRC / "gf_encode.cu", CSRC / "gf_mxu.cu")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SUPPORTED_L = (8, 16)
MAX_B = (1, 2)
_MAX_GRID_YZ = 65535
_MAX_STATIC_SMEM = 48 * 1024
MAX_ENCODE_THREADS = 512

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgf_tick-{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_chain_tick.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i64,
                                  i64, i32, i32, i32, i32, vp]
    lib.gf_chain_tick.restype = i32
    lib.gf_repair_tick.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                   i64, i64, i32, i32, i32, i32, vp]
    lib.gf_repair_tick.restype = i32
    lib.gf_encode.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, i32, vp]
    lib.gf_encode.restype = i32
    lib.gf_encode_mxu.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, i32, vp]
    lib.gf_encode_mxu.restype = i32
    _lib = lib
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``) for the current build, if any."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _check_tensors(name: str, dtypes: dict | None = None,
                   **tensors: torch.Tensor) -> torch.device:
    """Same CUDA device, the expected dtype (``dtypes[key]``, else int32)
    and contiguity for every tensor; returns the device."""
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
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return device


def _check_tick(name: str, l: int, t: int, num_chunks: int, node_lo: int,
                node_count: int, n: int, O: int, S: int, Bp: int) -> None:
    if l not in SUPPORTED_L:
        raise ValueError(f"{name}: unsupported field GF(2^{l})")
    if S < 1 or S * num_chunks != Bp:
        raise ValueError(f"{name}: chunk of {S} lanes x {num_chunks} chunks "
                         f"!= stream of {Bp} lanes")
    if not (0 <= node_lo and 1 <= node_count and node_lo + node_count <= n):
        raise ValueError(f"{name}: nodes [{node_lo}, {node_lo + node_count}) "
                         f"outside a chain of {n}")
    if not (0 <= t - (node_lo + node_count - 1) and t - node_lo < num_chunks):
        raise ValueError(f"{name}: a node in [{node_lo}, {node_lo + node_count}) "
                         f"has no chunk at tick {t} of {num_chunks} chunks")
    if O < 1 or O > _MAX_GRID_YZ or node_count > _MAX_GRID_YZ:
        raise ValueError(f"{name}: {O} objects x {node_count} nodes exceed the grid")


def _raise_on(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")


def chain_tick(wire_in: torch.Tensor, wire_out: torch.Tensor,
               local: torch.Tensor, out: torch.Tensor, bp_psi: torch.Tensor,
               bp_xi: torch.Tensor, l: int, t: int, num_chunks: int,
               node_lo: int, node_count: int) -> None:
    """One encode tick on the card (replaces ``chain_step_kernel``).

    Shapes: ``local`` (n, O, max_b, Bp), ``out`` (n, O, Bp), ``bp_psi`` and
    ``bp_xi`` (n, max_b, l), ``wire_in`` (>= node_lo + node_count, O, S) and
    ``wire_out`` (>= node_lo + node_count + 1, O, S) with S * num_chunks ==
    Bp. Node i of [node_lo, node_lo + node_count) reads ``wire_in[i]`` and
    chunk t - i of its local blocks, writes that chunk of ``out[i]`` and
    writes ``wire_out[i + 1]``.
    """
    device = _check_tensors("chain_tick", wire_in=wire_in, wire_out=wire_out,
                            local=local, out=out, bp_psi=bp_psi, bp_xi=bp_xi)
    if local.dim() != 4:
        raise ValueError(f"chain_tick: local {tuple(local.shape)} must be "
                         f"(n, O, max_b, Bp)")
    n, O, max_b, Bp = local.shape
    S = wire_in.shape[-1]
    _check_tick("chain_tick", l, t, num_chunks, node_lo, node_count, n, O, S, Bp)
    if max_b not in MAX_B:
        raise ValueError(f"chain_tick: max_b={max_b} not in {MAX_B}")
    if (out.shape != (n, O, Bp) or bp_psi.shape != (n, max_b, l)
            or bp_xi.shape != (n, max_b, l)):
        raise ValueError(f"chain_tick: out {tuple(out.shape)} / planes "
                         f"{tuple(bp_psi.shape)}, {tuple(bp_xi.shape)} do not "
                         f"match local {tuple(local.shape)}")
    last = node_lo + node_count
    if (wire_in.dim() != 3 or wire_in.shape[0] < last or wire_in.shape[1] != O
            or wire_out.dim() != 3 or wire_out.shape[0] < last + 1
            or wire_out.shape[1:] != wire_in.shape[1:]):
        raise ValueError(f"chain_tick: wires {tuple(wire_in.shape)} -> "
                         f"{tuple(wire_out.shape)} do not fit nodes < {last}")
    if wire_in.data_ptr() == wire_out.data_ptr():
        raise ValueError("chain_tick: wire_in and wire_out must not alias")
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gf_chain_tick(wire_in.data_ptr(), wire_out.data_ptr(),
                               local.data_ptr(), out.data_ptr(),
                               bp_psi.data_ptr(), bp_xi.data_ptr(), l, max_b,
                               O, Bp, S, t, num_chunks, node_lo, node_count,
                               stream)
    _raise_on("chain_tick", rc)
    chain_tick.launches += 1


chain_tick.launches = 0


def repair_tick(wire_in: torch.Tensor, wire_out: torch.Tensor,
                local: torch.Tensor, out: torch.Tensor, bp: torch.Tensor,
                l: int, t: int, num_chunks: int, node_lo: int,
                node_count: int) -> None:
    """One decode tick on the card (replaces ``repair_step_kernel``).

    Shapes: ``local`` (n, O, Bp), ``bp`` (n, rows, l), ``wire_in`` and
    ``wire_out`` (n, O, rows, S), ``out`` (O, rows, Bp) with S * num_chunks
    == Bp. Node i adds its term to the partial sums in ``wire_in[i]`` and
    writes them to ``wire_out[i + 1]``, or, for the last node n - 1, to
    chunk t - i of ``out``.
    """
    device = _check_tensors("repair_tick", wire_in=wire_in, wire_out=wire_out,
                            local=local, out=out, bp=bp)
    if local.dim() != 3 or bp.dim() != 3:
        raise ValueError(f"repair_tick: local {tuple(local.shape)} / planes "
                         f"{tuple(bp.shape)} must be (n, O, Bp) / (n, rows, l)")
    n, O, Bp = local.shape
    rows = bp.shape[1]
    S = wire_in.shape[-1]
    _check_tick("repair_tick", l, t, num_chunks, node_lo, node_count, n, O, S, Bp)
    if bp.shape != (n, rows, l) or out.shape != (O, rows, Bp):
        raise ValueError(f"repair_tick: planes {tuple(bp.shape)} / out "
                         f"{tuple(out.shape)} do not match local "
                         f"{tuple(local.shape)}")
    if wire_in.shape != (n, O, rows, S) or wire_out.shape != wire_in.shape:
        raise ValueError(f"repair_tick: wires {tuple(wire_in.shape)} -> "
                         f"{tuple(wire_out.shape)} must be {(n, O, rows, S)}")
    if rows < 1 or rows * l * 4 > _MAX_STATIC_SMEM:
        raise ValueError(f"repair_tick: {rows} rows of planes do not fit "
                         f"shared memory")
    if wire_in.data_ptr() == wire_out.data_ptr():
        raise ValueError("repair_tick: wire_in and wire_out must not alias")
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gf_repair_tick(wire_in.data_ptr(), wire_out.data_ptr(),
                                local.data_ptr(), out.data_ptr(), bp.data_ptr(),
                                l, n, O, rows, Bp, S, t, num_chunks, node_lo,
                                node_count, stream)
    _raise_on("repair_tick", rc)
    repair_tick.launches += 1


repair_tick.launches = 0


def gf_encode(data: torch.Tensor, planes: torch.Tensor, out: torch.Tensor,
              l: int, threads: int) -> None:
    """Static-coefficient encode on the card (replaces ``gf_encode_kernel``).

    Shapes: ``data`` (O, k, Bp) packed lanes, ``planes`` (rows, k, l) with
    ``planes[r, j, b] = M[r, j] * alpha^b`` (``gf.bitplane_table``), ``out``
    (O, rows, Bp). ``threads`` (1..512) lanes per block; the kernel masks the
    ragged end of Bp itself.
    """
    device = _check_tensors("gf_encode", data=data, planes=planes, out=out)
    if l not in SUPPORTED_L:
        raise ValueError(f"gf_encode: unsupported field GF(2^{l})")
    if data.dim() != 3 or planes.dim() != 3:
        raise ValueError(f"gf_encode: data {tuple(data.shape)} / planes "
                         f"{tuple(planes.shape)} must be (O, k, Bp) / (rows, k, l)")
    O, k, Bp = data.shape
    rows = planes.shape[0]
    if rows < 1 or k < 1 or planes.shape != (rows, k, l) or out.shape != (O, rows, Bp):
        raise ValueError(f"gf_encode: planes {tuple(planes.shape)} / out "
                         f"{tuple(out.shape)} do not match data {tuple(data.shape)}")
    if (rows + 1) * k * l * 4 > _MAX_STATIC_SMEM:
        raise ValueError(f"gf_encode: a ({rows}, {k}) matrix's planes and flags "
                         f"({(rows + 1) * k * l * 4} bytes) exceed the "
                         f"{_MAX_STATIC_SMEM} bytes of shared memory the kernel uses")
    if not 1 <= threads <= MAX_ENCODE_THREADS:
        raise ValueError(f"gf_encode: {threads} threads per block not in "
                         f"[1, {MAX_ENCODE_THREADS}]")
    if O < 1 or O > _MAX_GRID_YZ:
        raise ValueError(f"gf_encode: {O} objects exceed the grid")
    if Bp == 0:
        return
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gf_encode(data.data_ptr(), out.data_ptr(), planes.data_ptr(),
                           l, rows, k, Bp, O, threads, stream)
    _raise_on("gf_encode", rc)
    gf_encode.launches += 1


gf_encode.launches = 0


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
    """``bitlift_matrix`` zero-padded to whole 16 x 32 int8 MMA fragments."""
    lifted = bitlift_matrix(M, l)
    R, K = lifted.shape
    out = np.zeros((-(-R // 16) * 16, -(-K // 32) * 32), dtype=np.int8)
    out[:R, :K] = lifted
    return out


# gf_mxu.cu keeps a warp's A fragments in registers: at most 2 m-tiles of 16
# lifted rows per warp (8 warps) and 8 k-steps of 32 lifted columns.
MXU_MAX_LIFTED = 256


def gf_encode_mxu(data: torch.Tensor, lifted: torch.Tensor, out: torch.Tensor,
                  l: int) -> None:
    """Bit-lifted encode on the int8 tensor cores (replaces
    ``gf_encode_mxu_kernel``).

    Shapes: ``data`` (k, B) and ``out`` (rows, B) words (uint8 for GF(2^8),
    uint16 for GF(2^16)); ``lifted`` the (R_pad, K_pad) int8
    ``padded_bitlift`` of the (rows, k) matrix. Ragged B is masked in the
    kernel.
    """
    word = gf.TORCH_WORD_DTYPE.get(l)
    if word is None:
        raise ValueError(f"gf_encode_mxu: unsupported field GF(2^{l})")
    device = _check_tensors("gf_encode_mxu", {"data": word, "out": word,
                                              "lifted": torch.int8},
                            data=data, lifted=lifted, out=out)
    if data.dim() != 2 or out.dim() != 2 or lifted.dim() != 2:
        raise ValueError("gf_encode_mxu: data, out and lifted must be 2-D")
    k, B = data.shape
    rows = out.shape[0]
    R_pad, K_pad = lifted.shape
    if (rows < 1 or k < 1 or out.shape[1] != B or R_pad != -(-rows * l // 16) * 16
            or K_pad != -(-k * l // 32) * 32):
        raise ValueError(f"gf_encode_mxu: lifted {tuple(lifted.shape)} / out "
                         f"{tuple(out.shape)} do not match data {tuple(data.shape)}")
    if R_pad > MXU_MAX_LIFTED or K_pad > MXU_MAX_LIFTED:
        raise ValueError(f"gf_encode_mxu: a ({rows}, {k}) matrix lifts to "
                         f"{R_pad} x {K_pad} padded bits; the kernel takes at most "
                         f"{MXU_MAX_LIFTED} x {MXU_MAX_LIFTED} (rows * l and k * l "
                         f"up to {MXU_MAX_LIFTED})")
    if B == 0:
        return
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gf_encode_mxu(data.data_ptr(), out.data_ptr(), lifted.data_ptr(),
                               l, rows, k, B, R_pad, K_pad, stream)
    _raise_on("gf_encode_mxu", rc)
    gf_encode_mxu.launches += 1


gf_encode_mxu.launches = 0

KERNELS = (chain_tick, repair_tick, gf_encode, gf_encode_mxu)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
