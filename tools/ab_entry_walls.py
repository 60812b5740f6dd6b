#!/usr/bin/env python3
"""Wall medians of the monolithic pipelined encode and decode of one checkout.

    python3 tools/ab_entry_walls.py [--src DIR] [--reps 21] [--seed 0]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds its kernels, and times ``chain.pipelined_encode`` of the paper's
(16,11) GF(2^16) object (11 blocks of 2^25 words, 704 MiB, resident on the
card, 8 chunks) and ``chain.pipelined_decode`` from the 11 survivors of
nodes [5, 6, 7, 8, 14]: host clock around each synchronized call, after
one warm call each. Then the launch-bound case, where the host's time a
call shows, on 64 of Fig. 4's 5.8 MB objects (11 blocks of 2^18 words):
a loop of 64 encodes and one of 64 decodes, each loop synchronized once,
and the staggered batches (``multi.pipelined_encode_many``,
``pipelined_decode_many``, ``repair.pipelined_repair_many`` of the 5 lost
blocks, stagger 1), each timed twice a rep: the wall of the synchronized
call and the host's time until the call returns (its launches enqueued).
Prints one JSON line with the card's name and power limit. To compare
two checkouts on one card, run it for each in turns in one command
(parent, change, change, parent), e.g. with the parent unpacked by ``git
archive`` under the gitignored ``build/``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_entry_walls: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import gf, rapidraid
    from repro_torch.storage import chain, multi, repair

    dev = torch.device("cuda")
    code = rapidraid.RapidRAIDCode.make(16, 11, l=16, seed=args.seed)
    data_np = np.random.default_rng(args.seed).integers(0, 1 << 16, size=(11, 1 << 25),
                                                        dtype=np.uint16)
    data = gf.unpack_u32(torch.from_numpy(data_np.view(np.int32)).to(dev), 16)
    ids = [i for i in range(16) if i not in (5, 6, 7, 8, 14)]
    cw = chain.pipelined_encode(code, data, num_chunks=8)
    shards = gf.unpack_u32(gf.pack_u32(cw, 16)[torch.tensor(ids, device=dev)], 16)
    back = chain.pipelined_decode(code, ids, shards, num_chunks=8)
    torch.cuda.synchronize()
    if not torch.equal(gf.pack_u32(back, 16), gf.pack_u32(data, 16)):
        raise RuntimeError("decode != data")

    def walls(fn, enqueued: list[float] | None = None) -> list[float]:
        out = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            if enqueued is not None:
                enqueued.append((t1 - t0) * 1e3)
        return out

    enc = walls(lambda: chain.pipelined_encode(code, data, num_chunks=8))
    dec = walls(lambda: chain.pipelined_decode(code, ids, shards, num_chunks=8))
    small, small_shards = (gf.unpack_u32(gf.pack_u32(x, 16)[:, :1 << 17].contiguous(), 16)
                           for x in (data, shards))   # int32 lanes: CUDA copies no uint16
    loop_enc = walls(lambda: [chain.pipelined_encode(code, small, num_chunks=8)
                              for _ in range(64)])
    loop_dec = walls(lambda: [chain.pipelined_decode(code, ids, small_shards, num_chunks=8)
                              for _ in range(64)])
    lost = [5, 6, 7, 8, 14]
    objects, shards64 = (gf.unpack_u32(gf.pack_u32(x, 16)[None].expand(64, -1, -1)
                                       .contiguous(), 16) for x in (small, small_shards))
    batches, enqueue = {}, {}
    for name, fn in (
            ("encode", lambda: multi.pipelined_encode_many(code, objects, 8, 1)),
            ("decode", lambda: multi.pipelined_decode_many(code, ids, shards64, 8, 1)),
            ("repair", lambda: repair.pipelined_repair_many(code, ids, shards64, lost, 8, 1))):
        fn()
        enqueue[name] = []
        batches[name] = walls(fn, enqueue[name])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(json.dumps({"src": args.src, "card": card,
                      "encode_median_ms": statistics.median(enc),
                      "decode_median_ms": statistics.median(dec),
                      "loop64_encode_median_ms": statistics.median(loop_enc),
                      "loop64_decode_median_ms": statistics.median(loop_dec),
                      **{f"batch64_{name}_median_ms": statistics.median(w)
                         for name, w in batches.items()},
                      **{f"batch64_{name}_enqueue_median_ms": statistics.median(w)
                         for name, w in enqueue.items()},
                      "encode_ms": enc, "decode_ms": dec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
