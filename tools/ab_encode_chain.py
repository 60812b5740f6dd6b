#!/usr/bin/env python3
"""Time the whole-chain encode kernel (``encode_chain``) at the benchmark's
shapes, against the chain of ticks it replaces, in one process.

    python3 tools/ab_encode_chain.py [--old FILE ...] [--reps 5] [--seed 0]

Two shapes of the (16,11) RapidRAID code over GF(2^16), blocks of 2^25
words (2^24 lanes): ``archive16``, 16 objects archived at once, as the
benchmark's archive cell does (nodes 5-10 hold two replica blocks, 22 slots
an object), and ``single``, the one-object ``pipelined_encode``. Each runs,
in turns, as the pipelined programs ran it before (``chain_tick`` ticks
over fresh zeroed wires, 8 chunks, lockstep for the one object and a
stagger of 1 for the batch: ``ticks``), as one ``kernel.encode_chain``
launch (``chain``), and, for each ``--old``, as the ``gf_encode_chain`` of
another ``gf_tick.cu`` with the same C interface (put under the gitignored
``build/``, e.g. an earlier version taken from git history; named by its
file's stem): ticks, the others, chain, chain, the others in reverse, ticks. Every
result is checked against the ticks'. Prints one JSON line a shape with the
CUDA-event medians, the bytes the result needs (k blocks read, n rows
written) and their time at 3.35 TB/s, the kernel's shared-memory lookups in
byte tables (4 a lane and slot) and in nibble tables (8), and the card's
name and power limit.
Needs one CUDA card with about 48 GB free.
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

from repro_torch.core import rapidraid  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops  # noqa: E402
from repro_torch.storage import chain  # noqa: E402

N, K, L, LANES, NUM_CHUNKS, OBJECTS = 16, 11, 16, 1 << 24, 8, 16
HBM_BYTES_PER_S = 3.35e12


def build_old(source: Path) -> ctypes.CDLL:
    out = kernel.BUILD_DIR / "ab_old_encode" / f"libgf_tick_{source.stem}.so"
    kernel.build_shared([source], out)
    lib = ctypes.CDLL(str(out))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_encode_chain.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, i64, i64, vp]
    lib.gf_encode_chain.restype = i32
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="another gf_tick.cu with gf_encode_chain (repeatable)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = torch.device("cuda")
    olds = {path.stem: build_old(path) for path in args.old}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    code = rapidraid.RapidRAIDCode.make(N, K, l=L, seed=0)
    slots = chain.placement_slots(code)
    tables = chain.device_tables(chain.product_tables(code), dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for name, n_obj, stagger in (("archive16", OBJECTS, 1), ("single", 1, 0)):
        src = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_obj, K, LANES), generator=gen,
                            dtype=torch.int32, device=dev)
        want = torch.empty((n_obj, N, LANES), dtype=torch.int32, device=dev)
        got = torch.empty_like(want)
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan = kernel.EncodePlan(slots, K, dev)
        runs = {
            "ticks": lambda: ops._encode_chain_ticks(src, slots, want.transpose(0, 1), tables,
                                                     L, NUM_CHUNKS, stagger),
            "chain": lambda: kernel.encode_chain(src, plan, got.transpose(0, 1), tables, L),
        }
        for stem, lib in olds.items():
            def run_old(lib=lib, stem=stem):
                out = got.transpose(0, 1)
                rc = lib.gf_encode_chain(src.data_ptr(), out.data_ptr(), tables.data_ptr(),
                                         plan.terms.data_ptr(), L, plan.terms.shape[0], n_obj,
                                         K, plan.caches, LANES, out.stride(0), out.stride(1),
                                         stream)
                if rc:
                    raise RuntimeError(f"{stem} gf_encode_chain: CUDA error {rc}")
            runs[stem] = run_old
        order = ["ticks", *olds, "chain", "chain", *reversed(olds), "ticks"]
        times: dict[str, list[float]] = {}
        for which in order:
            if which != "ticks":
                got.fill_(-1)
            times.setdefault(which, []).append(median_ms(runs[which], args.reps))
            torch.cuda.synchronize()
            if which != "ticks" and not torch.equal(got, want):
                raise AssertionError(f"{name}: {which} differs from the ticks")
        needed = 4 * LANES * n_obj * (K + N)   # each block lane read once, each row written once
        used = int((slots >= 0).sum())
        lookups = {"byte": 4 * used * LANES * n_obj, "nibble": 8 * used * LANES * n_obj}
        ms = {w: statistics.median(v) for w, v in times.items()}
        print(json.dumps({
            "shape": name, "objects": n_obj, "slots": used, "lanes": LANES, "ms": ms,
            "runs_ms": times, "needed_bytes": needed,
            "hbm_bound_ms": 1e3 * needed / HBM_BYTES_PER_S,
            "roofline_pct": {w: 100 * 1e3 * needed / HBM_BYTES_PER_S / v for w, v in ms.items()},
            "lookups": lookups, "card": smi}), flush=True)
        del src, want, got, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
