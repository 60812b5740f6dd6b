#!/usr/bin/env python3
"""Time two builds of the static-coefficient encode kernels in one process.

    python3 tools/ab_static_encode.py --old DIR [--seed 0] [--reps 5]

DIR holds an earlier ``gf_encode.cu`` and ``gf_mxu.cu`` (the table-driven
bit-plane encode and the ``mma.sync`` bit-lift, whose C entry points are
``gf_encode(data, out, planes, l, rows, k, Bp, O, threads, stream)`` and
``gf_encode_mxu(x, out, lifted, l, rows, k, B, R_pad, K_pad, stream)``).
They are built with nvcc into a second library beside the package's own and
run in turns with the package's kernels — old, new, new, old — at the
(16,11) GF(2^16) 2^25-word shapes of ``chip_smoke.py``: the bit-plane
encode with the RapidRAID generator (16 rows) and the classical parity
(5 rows), the bit-lift with the generator. Every output is checked equal
between the two builds. Prints one JSON line with the CUDA-event medians
and the card's name and power limit, and writes it to
``chiprun_out/ab_static_encode.json``. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import classical, gf, rapidraid  # noqa: E402
from repro_torch.kernels.gf_encode import kernel  # noqa: E402

N, K, L, B = 16, 11, 16, 1 << 25


def build_old(old: Path) -> ctypes.CDLL:
    out = kernel.BUILD_DIR / "ab_old" / "libgf_old.so"
    kernel.build_shared([old / "gf_encode.cu", old / "gf_mxu.cu"], out)
    lib = ctypes.CDLL(str(out))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_encode.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, i32, vp]
    lib.gf_encode_mxu.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, i32, vp]
    return lib


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="directory of the earlier sources")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_static_encode: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    old = build_old(args.old)
    kernel.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    G = rapidraid.RapidRAIDCode.make(N, K, l=L, seed=args.seed).G
    P = classical.make_code(N, K, L).parity_matrix
    rng = np.random.default_rng(args.seed)
    data_np = rng.integers(0, 1 << L, size=(K, B), dtype=np.uint16)
    words = torch.from_numpy(data_np).to(dev)                     # (k, B) uint16
    lanes = words.view(torch.int32)[None]                          # (1, k, Bp)
    Bp = B // 2

    def old_encode(M):
        planes = torch.from_numpy(gf.bitplane_table(M, L).astype(np.int32)).to(dev)
        out = torch.empty((1, M.shape[0], Bp), dtype=torch.int32, device=dev)
        run = lambda: old.gf_encode(lanes.data_ptr(), out.data_ptr(), planes.data_ptr(), L,
                                    M.shape[0], K, Bp, 1, 512, stream)
        return run, out

    def new_encode(M):
        out = torch.empty((1, M.shape[0], Bp), dtype=torch.int32, device=dev)
        return (lambda: kernel.gf_encode(lanes, M, out, L)), out

    def old_mxu(M):
        lifted = torch.from_numpy(kernel.padded_bitlift(M, L)).to(dev)
        out = torch.empty((M.shape[0], B), dtype=torch.uint16, device=dev)
        run = lambda: old.gf_encode_mxu(words.data_ptr(), out.data_ptr(), lifted.data_ptr(), L,
                                        M.shape[0], K, B, lifted.shape[0], lifted.shape[1],
                                        stream)
        return run, out

    def new_mxu(M):
        operand = torch.from_numpy(kernel.mxu_operand(M, L)).to(dev)
        out = torch.empty((M.shape[0], B), dtype=torch.uint16, device=dev)
        return (lambda: kernel.gf_encode_mxu(words, operand, out, L)), out

    result = {"card": smi, "shape": f"({N},{K}) GF(2^{L}), {B} words", "reps": args.reps}
    for name, M, make_old, make_new in (("gf_encode 16 rows", G, old_encode, new_encode),
                                        ("gf_encode 5 rows", P, old_encode, new_encode),
                                        ("gf_encode_mxu 16 rows", G, old_mxu, new_mxu)):
        runs = {"old": make_old(M), "new": make_new(M)}
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(median_ms(runs[which][0], args.reps))
        torch.cuda.synchronize()
        a, b = runs["old"][1], runs["new"][1]
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            raise RuntimeError(f"{name}: the two builds disagree")
        result[name] = {"old_ms": times["old"], "new_ms": times["new"]}
        print(f"{name}: old {times['old']} ms, new {times['new']} ms (old, new, new, old)")
    line = json.dumps(result)
    print(line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_static_encode.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
