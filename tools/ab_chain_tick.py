#!/usr/bin/env python3
"""Time two builds of the encode tick (``chain_tick``) in one process.

    python3 tools/ab_chain_tick.py --old FILE [--old-api gathered|slots] [--seed 0] [--reps 5]

FILE is an earlier ``gf_tick.cu``, built with nvcc into a second library
beside the package's own. Its chain tick takes one of two C interfaces:

- ``gathered`` (the default; e.g. ``git show 8aea85b:...``):
  ``gf_chain_tick(wire_in, wire_out, local, out, bp_psi, bp_xi, l, max_b,
  O, Bp, S, t, num_chunks, node_lo, node_count, stream)`` over gathered
  (n, O, max_b, Bp) blocks and (n, max_b, l) planes, writing the wire of
  every node, the last one too;
- ``slots`` (e.g. ``git show 019af0c:...``, the lockstep tick before the
  object window): ``gf_chain_tick(wire_in, wire_out, src, out, tables,
  slots, l, max_b, O, R, Bp, S, t, node_lo, node_count, fwd_rows,
  stream)``, the package's operands without the window's arguments.

The 23 encode ticks of ``chip_smoke.py``'s main path — a (16,11) RapidRAID
code over GF(2^16), 2^25 words a block, 8 chunks — run through the old
build (on the gathered placement, as the old encode made it, or on the
package's operands) and through the package's kernel (reading the blocks
in place through the slot table) in turns: old, new, new, old. With
``slots``, the package's kernel is also called straight through ctypes,
as the old one is (``new_direct``: old, new, new_direct, new_direct, new,
old), so the two builds' launches cost the host the same. Both codewords are checked equal to the
static encode by the code's generator (``kernel.gf_encode``). Prints one
JSON line with the CUDA-event medians, the device bytes the old encode's
operands (placement copy, planes, output, wires) take above the object,
and the card's name and power limit, and writes it to
``chiprun_out/ab_chain_tick.json``. Needs one CUDA card.
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

from repro_torch.core import gf, pipeline, rapidraid  # noqa: E402
from repro_torch.kernels.gf_encode import kernel  # noqa: E402
from repro_torch.storage import chain  # noqa: E402

N, K, L, B, NUM_CHUNKS = 16, 11, 16, 1 << 25, 8


def build_old(source: Path, api: str) -> ctypes.CDLL:
    out = kernel.BUILD_DIR / "ab_old" / f"libgf_tick_old_{api}.so"
    kernel.build_shared([source], out)
    lib = ctypes.CDLL(str(out))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_chain_tick.argtypes = (
        [vp, vp, vp, vp, vp, vp, i32, i32, i32, i64, i64, i32, i32, i32, i32, vp]
        if api == "gathered" else
        [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i64, i64, i32, i32, i32, i32, vp])
    lib.gf_chain_tick.restype = i32
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


def ticks(wire_shape, dev, tick):
    """The main path's ticks through ``tick(wire_in, wire_out, t, lo, count)``
    on ping-pong wires of ``wire_shape``; returns the run."""
    wires = [torch.zeros(wire_shape, dtype=torch.int32, device=dev) for _ in range(2)]

    def run():
        for t in range(pipeline.num_ticks(NUM_CHUNKS, N)):
            lo, count = pipeline.active_nodes(t, N, NUM_CHUNKS)
            tick(wires[(t + 1) % 2], wires[t % 2], t, lo, count)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="the earlier gf_tick.cu")
    ap.add_argument("--old-api", choices=("gathered", "slots"), default="gathered",
                    help="the earlier chain tick's C interface")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_chain_tick: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    old = build_old(args.old, args.old_api)
    kernel.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    code = rapidraid.RapidRAIDCode.make(N, K, l=L, seed=args.seed)
    data = np.random.default_rng(args.seed).integers(0, 1 << L, size=(K, B), dtype=np.uint16)
    data_p = gf.pack_u32(torch.from_numpy(data).to(dev), L)            # (k, Bp)
    Bp, S = data_p.shape[1], data_p.shape[1] // NUM_CHUNKS
    want = torch.empty((1, N, Bp), dtype=torch.int32, device=dev)
    kernel.gf_encode(data_p[None], code.G, want, L)

    # the old encode's operands: the gathered placement and its planes, or
    # the package's operands; its output and its wire rows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    outs = {"old": torch.empty((N, 1, Bp), dtype=torch.int32, device=dev)}
    src, slots, tables = chain.encode_operands(code, data_p)
    if args.old_api == "gathered":
        idx, valid = chain.placement_indices(code)
        local = data_p[torch.tensor(idx, dtype=torch.int64, device=dev)]
        local.masked_fill_(~torch.tensor(valid, device=dev)[:, :, None], 0)
        bp_psi, bp_xi = (torch.from_numpy(p.astype(np.int32)).to(dev)
                         for p in chain.bitplane_coeff_planes(code))

    def old_tick(wi, wo, t, lo, count):
        if args.old_api == "gathered":
            rc = old.gf_chain_tick(wi.data_ptr(), wo.data_ptr(), local.data_ptr(),
                                   outs["old"].data_ptr(), bp_psi.data_ptr(), bp_xi.data_ptr(),
                                   L, code.chain.max_blocks, 1, Bp, S, t, NUM_CHUNKS, lo,
                                   count, stream)
        else:
            rc = old.gf_chain_tick(wi.data_ptr(), wo.data_ptr(), src.data_ptr(),
                                   outs["old"].data_ptr(), tables.data_ptr(), slots.ctypes.data,
                                   L, code.chain.max_blocks, 1, K, Bp, S, t, lo, count, N,
                                   stream)
        if rc:
            raise RuntimeError(f"old chain_tick: CUDA error {rc}")

    rows = N + 1 if args.old_api == "gathered" else N
    runs = {"old": ticks((rows, 1, S), dev, old_tick)}
    runs["old"]()
    torch.cuda.synchronize()
    old_bytes = torch.cuda.max_memory_allocated() - resident

    outs["new"] = torch.empty((N, 1, Bp), dtype=torch.int32, device=dev)

    def new_tick(wi, wo, t, lo, count):
        kernel.chain_tick(wi, wo, src, slots, outs["new"], tables, L, t, NUM_CHUNKS, lo,
                          count)

    runs["new"] = ticks((N, 1, S), dev, new_tick)
    turns = ("old", "new", "new", "old")
    if args.old_api == "slots":
        # the package's kernel also called straight through ctypes, as the
        # old one is: the same host cost a launch, so a difference is the card's
        lib = kernel.load_library()
        outs["new_direct"] = torch.empty((N, 1, Bp), dtype=torch.int32, device=dev)

        def direct_tick(wi, wo, t, lo, count):
            rc = lib.gf_chain_tick(wi.data_ptr(), wo.data_ptr(), src.data_ptr(),
                                   outs["new_direct"].data_ptr(), tables.data_ptr(),
                                   slots.ctypes.data, L, code.chain.max_blocks, 1, 1, 0,
                                   NUM_CHUNKS, K, Bp, S, Bp, Bp, t, lo, count, N, stream)
            if rc:
                raise RuntimeError(f"chain_tick: CUDA error {rc}")

        runs["new_direct"] = ticks((N, 1, S), dev, direct_tick)
        turns = ("old", "new", "new_direct", "new_direct", "new", "old")
    times = {which: [] for which in runs}
    for which in turns:
        times[which].append(median_ms(runs[which], args.reps))
    torch.cuda.synchronize()
    for which, out in outs.items():
        if not torch.equal(out[:, 0], want[0]):
            raise RuntimeError(f"{which} chain_tick: the codeword differs from the static encode")
    result = {"card": smi, "shape": f"({N},{K}) GF(2^{L}), {B} words, {NUM_CHUNKS} chunks, "
              f"{pipeline.num_ticks(NUM_CHUNKS, N)} ticks", "old_api": args.old_api,
              "reps": args.reps,
              **{f"{which}_ms": ms for which, ms in times.items()},
              "old_operand_bytes_above_object": old_bytes}
    print(f"chain_tick: {times} ms in turns {turns}; the old encode's operands take "
          f"{old_bytes / 2**30:.3f} GiB above the object")
    line = json.dumps(result)
    print(line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_chain_tick.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
