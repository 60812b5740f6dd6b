#!/usr/bin/env python3
"""Time the whole-chain decode and repair kernel (``repair_chain``) at the
benchmark's shapes, against the chain of ticks it replaces, in one process.

    python3 tools/ab_repair_chain.py [--old FILE ...] [--reps 5] [--seed 0]

Two shapes of the (16,11) RapidRAID code over GF(2^16), blocks of 2^25
words (2^24 lanes): ``restore``, the decode of one object from the 11
survivors of the first decodable 5-node loss in a seeded order (11
positions, 11 rows); ``repair16``, one lost node's row rebuilt for 16
objects from its 11 helpers among 15 survivors, the shards laid out (16,
15, lanes) and read through the batch's strides (11 positions, one row).
Each runs, in turns, as the pipelined programs ran it before (the ticks
over fresh zeroed wires, 8 chunks, lockstep for the one object and a
stagger of 1 for the batch: ``ticks``), as one ``kernel.repair_chain``
launch (``chain``), and, for each ``--old``, as the ``gf_repair_chain`` of
another ``gf_tick.cu`` with the same C interface (put under the gitignored
``build/``; named by its file's stem): ticks, the others, chain, chain, the
others in reverse, ticks. Every result is checked against the ticks'. Prints one JSON line a shape with the
CUDA-event medians, the bytes the result needs and their time at 3.35 TB/s,
the kernel's shared-memory lookups (8 a lane, row pack and position in its
16-entry nibble tables; 4 in the byte tables of a one-pack chain) and their
rate, and the card's name and power limit.
Needs one CUDA card with about 24 GB free.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
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
from repro_torch.storage import chain, repair  # noqa: E402

N, K, L, LANES, NUM_CHUNKS, LOST, OBJECTS = 16, 11, 16, 1 << 24, 8, 5, 16
HBM_BYTES_PER_S = 3.35e12


def build_old(source: Path) -> ctypes.CDLL:
    out = kernel.BUILD_DIR / "ab_old_chain" / f"libgf_tick_{source.stem}.so"
    kernel.build_shared([source], out)
    lib = ctypes.CDLL(str(out))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_repair_chain.argtypes = [vp, vp, vp, vp, i32, i32, i32, i64, i64, i64, i32, i32, vp]
    lib.gf_repair_chain.restype = i32
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


def shapes(code, seed: int, dev):
    """name -> (shards (R, B_obj, lanes) int32, row table, tables, rows, stagger)."""
    rng = np.random.default_rng(seed)
    combos = list(itertools.combinations(range(N), LOST))
    lost = next(list(combos[j]) for j in rng.permutation(len(combos))
                if code.decodable([i for i in range(N) if i not in combos[j]]))
    ids = tuple(i for i in range(N) if i not in lost)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def lanes(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen, dtype=torch.int32,
                             device=dev)
    restore = (lanes(len(ids), 1, LANES), chain.identity_rows(len(ids)),
               chain.decode_operands(code, ids, dev), K, 0)
    survivors = tuple(range(1, N))
    rows_table, tables = repair.repair_operands(code, (0,), survivors, dev)
    batch = lanes(OBJECTS, len(survivors), LANES).transpose(0, 1)
    return {"restore": restore, "repair16": (batch, rows_table, tables, 1, 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="another gf_tick.cu with gf_repair_chain (repeatable)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = torch.device("cuda")
    olds = {path.stem: build_old(path) for path in args.old}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    code = rapidraid.RapidRAIDCode.make(N, K, l=L, seed=0)
    for name, (shards, rows_table, tables, rows, stagger) in shapes(code, args.seed, dev).items():
        R, n_obj, Bp = shards.shape
        h = len(rows_table)
        outs = {w: torch.empty((n_obj, rows, Bp), dtype=torch.int32, device=dev)
                for w in ("ticks", "chain", *olds)}
        runs = {
            "ticks": lambda: ops._repair_chain_ticks(shards, rows_table, outs["ticks"], tables,
                                                     L, NUM_CHUNKS, stagger),
            "chain": lambda: kernel.repair_chain(shards, rows_table, outs["chain"], tables, L),
        }
        stream = torch.cuda.current_stream(dev).cuda_stream
        frozen = np.ascontiguousarray(rows_table, dtype=np.int32)
        for stem, lib in olds.items():
            def run_old(lib=lib, stem=stem):
                rc = lib.gf_repair_chain(shards.data_ptr(), outs[stem].data_ptr(),
                                         tables.data_ptr(), frozen.ctypes.data, L, rows, n_obj,
                                         Bp, shards.stride(0), shards.stride(1), 0, h, stream)
                if rc:
                    raise RuntimeError(f"{stem} gf_repair_chain: CUDA error {rc}")
            runs[stem] = run_old
        order = ["ticks", *olds, "chain", "chain", *reversed(olds), "ticks"]
        times: dict[str, list[float]] = {}
        for which in order:
            if which in runs:
                times.setdefault(which, []).append(median_ms(runs[which], args.reps))
        torch.cuda.synchronize()
        for which in runs:
            if not torch.equal(outs[which], outs["ticks"]):
                raise AssertionError(f"{name}: {which} differs from the ticks")
        needed = 4 * Bp * n_obj * (h + rows)        # each shard lane read once, each sum written once
        packs = kernel.repair_packs(rows, L)
        per_pack = 8 if packs > 1 else 4        # nibble lookups a lane, byte lookups for one pack
        lookups = per_pack * packs * h * Bp * n_obj
        ms = {w: statistics.median(v) for w, v in times.items()}
        print(json.dumps({
            "shape": name, "positions": h, "rows": rows, "objects": n_obj, "lanes": Bp,
            "ms": ms, "runs_ms": times, "needed_bytes": needed,
            "hbm_bound_ms": 1e3 * needed / HBM_BYTES_PER_S,
            "roofline_pct": {w: 100 * 1e3 * needed / HBM_BYTES_PER_S / v for w, v in ms.items()},
            "lookups": lookups, "table": "nibble" if packs > 1 else "byte",
            "lookups_per_s": {w: lookups / (v * 1e-3) for w, v in ms.items() if w != "ticks"},
            "card": smi}))
        del shards, outs, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
