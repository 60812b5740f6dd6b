#!/usr/bin/env python3
"""Time two builds of the decode and repair tick (``repair_tick``) in one process.

    python3 tools/ab_repair_tick.py --old FILE [--old-api planes|rows|window] [--seed 0]
        [--reps 5]

FILE is an earlier ``gf_tick.cu`` (put under the gitignored ``build/``),
built with nvcc into a second library beside the package's own. Its
repair tick takes one of three C interfaces:

- ``planes`` (the default; e.g. ``git show 772ced6:...``):
  ``gf_repair_tick(wire_in, wire_out, local, out, bp, l, n, O, rows, Bp,
  S, t, num_chunks, node_lo, node_count, stream)`` over (n, O, Bp) shards
  gathered in chain order and (n, rows, l) planes;
- ``rows`` (e.g. ``git show 019af0c:...``, the lockstep tick before the
  object window): ``gf_repair_tick(wire_in, wire_out, shards, out,
  tables, shard_rows, l, n, O, rows, Bp, S, t, node_lo, node_count,
  head_zero, stream)``, the package's operands without the window's
  arguments;
- ``window`` (e.g. ``git show e5b6a88:...``, the object window before
  ``last_forwards``): the package's interface without that flag.

At ``chip_smoke.py``'s shapes — a (16,11) RapidRAID code over GF(2^16),
2^25 words a block, 8 chunks, 5 nodes lost (the first decodable 5-node
pattern in a seeded order) — the 18 ticks of the decode from the 11
survivors and the 18 ticks of the pipelined repair of the 5 lost blocks run
through the old build (on the helpers' shards gathered in chain order, as
the old repair made them, or on the package's operands) and through the
package's kernel (reading the shards in place through the row table, node
0's zero head row not read) in turns: old, new, new, old. With ``rows`` or
``window``, the package's kernel is also called straight through ctypes,
as the old one is (``new_direct``: old, new, new_direct, new_direct, new,
old), so the two builds' launches cost the host the same. Every result is
checked against the object or the lost codeword rows. Prints one JSON line
with the CUDA-event medians and the card's name and power limit. Needs one
CUDA card.
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

from repro_torch.core import fault_tolerance, gf, pipeline, rapidraid  # noqa: E402
from repro_torch.kernels.gf_encode import kernel  # noqa: E402
from repro_torch.storage import chain, repair  # noqa: E402

N, K, L, B, NUM_CHUNKS, LOST = 16, 11, 16, 1 << 25, 8, 5


def build_old(source: Path, api: str) -> ctypes.CDLL:
    out = kernel.BUILD_DIR / "ab_old_repair" / f"libgf_tick_old_{api}.so"
    kernel.build_shared([source], out)
    lib = ctypes.CDLL(str(out))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_repair_tick.argtypes = {
        "planes": [vp, vp, vp, vp, vp, i32, i32, i32, i32, i64, i64, i32, i32, i32, i32, vp],
        "rows": [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i64, i64, i32, i32, i32, i32, vp],
        "window": [vp] * 6 + [i32] * 7 + [i64] * 4 + [i32] * 4 + [vp]}[api]
    lib.gf_repair_tick.restype = i32
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


def ticks(n, wire_shape, dev, tick):
    """A run of the ticks of an n-node chain through ``tick(wire_in,
    wire_out, t, lo, count)`` on ping-pong wires of ``wire_shape``."""
    wires = [torch.zeros(wire_shape, dtype=torch.int32, device=dev) for _ in range(2)]

    def run():
        for t in range(pipeline.num_ticks(NUM_CHUNKS, n)):
            lo, count = pipeline.active_nodes(t, n, NUM_CHUNKS)
            tick(wires[(t + 1) % 2], wires[t % 2], t, lo, count)
    return run


def first_decodable_loss(code, seed: int) -> list[int]:
    combos = list(itertools.combinations(range(code.n), LOST))
    for j in np.random.default_rng(seed).permutation(len(combos)):
        alive = sorted(set(range(code.n)) - set(combos[j]))
        if code.decodable(alive):
            return list(combos[j])
    raise RuntimeError(f"no decodable {LOST}-node loss pattern")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="the earlier gf_tick.cu")
    ap.add_argument("--old-api", choices=("planes", "rows", "window"), default="planes",
                    help="the earlier repair tick's C interface")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_repair_tick: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    old = build_old(args.old, args.old_api)
    lib = kernel.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    code = rapidraid.RapidRAIDCode.make(N, K, l=L, seed=args.seed)
    data_np = np.random.default_rng(args.seed).integers(0, 1 << L, size=(K, B), dtype=np.uint16)
    data_p = torch.from_numpy(data_np.view(np.int32)).to(dev)      # (k, Bp) packed lanes
    cw_p = gf.pack_u32(chain.pipelined_encode(code, gf.unpack_u32(data_p, L)), L)
    lost = first_decodable_loss(code, args.seed)
    ids = [i for i in range(N) if i not in lost]
    shards_p = cw_p[torch.tensor(ids, device=dev)]                   # (11, Bp)
    Bp = shards_p.shape[1]
    S = Bp // NUM_CHUNKS

    # decode: node i holds survivor i; repair: position p holds helper order[p]
    helpers, R = fault_tolerance.repair_plan(code, lost, ids)
    order = pipeline.position_nodes(len(helpers), reverse=True)
    cases = {
        "decode": {"rows": K, "want": data_p,
                   "old_local": shards_p[:, None],
                   "old_bp": chain.decode_planes(code, tuple(ids)),
                   "rows_table": np.arange(len(ids), dtype=np.int32),
                   "tables": chain.decode_operands(code, ids, dev)},
        "repair": {"rows": LOST, "want": cw_p[torch.tensor(lost, device=dev)],
                   "old_local": shards_p[torch.tensor([ids.index(helpers[p]) for p in order],
                                                      device=dev)][:, None],
                   "old_bp": chain.column_bitplanes(R, L)[order]},
    }
    cases["repair"]["rows_table"], cases["repair"]["tables"] = repair.repair_operands(
        code, lost, ids, dev)

    result = {"card": smi, "shape": f"({N},{K}) GF(2^{L}), {B} words, {NUM_CHUNKS} chunks, "
              f"lost {lost}", "old_api": args.old_api, "reps": args.reps}
    for name, c in cases.items():
        h, rows = len(ids) if name == "decode" else len(helpers), c["rows"]
        bp = torch.from_numpy(np.ascontiguousarray(c["old_bp"], dtype=np.int32)).to(dev)
        outs = {w: torch.empty((1, rows, Bp), dtype=torch.int32, device=dev)
                for w in ("old", "new", "new_direct")}

        def old_tick(wi, wo, t, lo, count, c=c, bp=bp, outs=outs, h=h, rows=rows):
            if args.old_api == "planes":
                rc = old.gf_repair_tick(wi.data_ptr(), wo.data_ptr(), c["old_local"].data_ptr(),
                                        outs["old"].data_ptr(), bp.data_ptr(), L, h, 1, rows,
                                        Bp, S, t, NUM_CHUNKS, lo, count, stream)
            elif args.old_api == "rows":
                rc = old.gf_repair_tick(wi.data_ptr(), wo.data_ptr(), shards_p.data_ptr(),
                                        outs["old"].data_ptr(), c["tables"].data_ptr(),
                                        c["rows_table"].ctypes.data, L, h, 1, rows, Bp, S, t,
                                        lo, count, 1, stream)
            else:
                rc = old.gf_repair_tick(wi.data_ptr(), wo.data_ptr(), shards_p.data_ptr(),
                                        outs["old"].data_ptr(), c["tables"].data_ptr(),
                                        c["rows_table"].ctypes.data, L, h, 1, 1, 0, NUM_CHUNKS,
                                        rows, Bp, S, Bp, Bp, t, lo, count, 1, stream)
            if rc:
                raise RuntimeError(f"old repair_tick: CUDA error {rc}")

        def new_tick(wi, wo, t, lo, count, c=c, outs=outs):
            kernel.repair_tick(wi, wo, shards_p[:, None], c["rows_table"], outs["new"],
                               c["tables"], L, t, NUM_CHUNKS, lo, count, head_zero=True)

        def direct_tick(wi, wo, t, lo, count, c=c, outs=outs, h=h, rows=rows):
            # the package's kernel straight through ctypes, as the old one is
            rc = lib.gf_repair_tick(wi.data_ptr(), wo.data_ptr(), shards_p.data_ptr(),
                                    outs["new_direct"].data_ptr(), c["tables"].data_ptr(),
                                    c["rows_table"].ctypes.data, L, h, 1, 1, 0, NUM_CHUNKS,
                                    rows, Bp, S, Bp, Bp, t, lo, count, 1, 0, stream)
            if rc:
                raise RuntimeError(f"repair_tick: CUDA error {rc}")

        runs = {"old": ticks(h, (h, 1, rows, S), dev, old_tick),
                "new": ticks(h, (h, 1, rows, S), dev, new_tick)}
        turns = ("old", "new", "new", "old")
        if args.old_api != "planes":
            runs["new_direct"] = ticks(h, (h, 1, rows, S), dev, direct_tick)
            turns = ("old", "new", "new_direct", "new_direct", "new", "old")
        else:
            del outs["new_direct"]
        times = {which: [] for which in runs}
        for which in turns:
            times[which].append(median_ms(runs[which], args.reps))
        torch.cuda.synchronize()
        for which, out in outs.items():
            if not torch.equal(out[0], c["want"]):
                raise RuntimeError(f"{which} repair_tick: the {name} differs from its want")
        result.update({f"{name}_{which}_ms": ms for which, ms in times.items()})
        print(f"repair_tick {name} ({pipeline.num_ticks(NUM_CHUNKS, h)} ticks, {rows} rows): "
              f"{times} ms in turns {turns}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
