#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass or the script exits non-zero before its
last line:

1. Build the CUDA tick kernels from ``src/repro_torch/kernels/gf_encode/csrc``
   with nvcc (timed) and print the card's name and power limit.
2. Hold each kernel bit-exact against its plain PyTorch version on the card,
   for GF(2^8) and GF(2^16), one and two replica slots, and a ragged lane
   count; print each kernel's median time at those shapes.
3. The main path at the paper's production size (§VI, Table II): a (16,11)
   RapidRAID code over GF(2^16) archives a 704 MiB object (11 blocks of
   2^25 words) by ``pipelined_encode`` in 8 chunks; 5 nodes are lost (the
   first decodable 5-node pattern in a seeded order) and
   ``pipelined_decode`` reads the object back from the 11 survivors.
   Launch counters are set to 0 just before and read just after. The
   codeword is checked whole against the plain packed matvec on the card
   and in sampled windows against the host numpy field; the decoded object
   must equal the data.
4. Replay the main path's ticks through each kernel and through its plain
   version, check they agree, and time both; print one JSON line with
   every kernel's numbers, then the device line.

Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import gf, pipeline, rapidraid  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402
from repro_torch.storage import chain  # noqa: E402

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet and
# Hopper white paper): HBM3 bandwidth, and the non-tensor INT32 rate
# (132 SMs x 64 INT32 lanes x 2 ops x 1.98 GHz) — no tensor core computes a
# GF(2^l) product, so the integer pipes are the peak for this arithmetic.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

N, K, L = 16, 11, 16
NUM_CHUNKS = 8
LOST = 5
REPLACES = {
    "chain_tick": "src/repro/kernels/gf_encode/kernel.py:115",
    "repair_tick": "src/repro/kernels/gf_encode/kernel.py:164",
}
SOURCE = "src/repro_torch/kernels/gf_encode/csrc/gf_tick.cu"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` in ms, each run synchronized."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rand_i32(gen: torch.Generator, shape, dev) -> torch.Tensor:
    """Uniform 32-bit patterns as int32."""
    return torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64,
                         device=dev).to(torch.int32)


def planes(rng: np.random.Generator, shape, l: int, dev) -> torch.Tensor:
    coeffs = rng.integers(1, 1 << l, size=shape)
    return torch.from_numpy(gf.bitplane_table(coeffs, l).astype(np.int32)).to(dev)


def phase_kernels(dev, seed: int, errs: dict) -> None:
    """Each kernel against its plain version at small, ragged shapes."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, O, chunks, t = 5, 2, 3, 3            # tick 3: nodes 1..3 active
    for l, max_b in itertools.product((8, 16), (1, 2)):
        S = 1000 + 3 * l + max_b                # not a multiple of the tile
        wire_in = rand_i32(gen, (n + 1, O, S), dev)
        local = rand_i32(gen, (n, O, max_b, S * chunks), dev)
        bp_psi = planes(rng, (n, max_b), l, dev)
        bp_xi = planes(rng, (n, max_b), l, dev)
        bp_psi[2, max_b - 1] = 0                # a padded slot: all planes zero
        bp_xi[2, max_b - 1] = 0
        bp_psi[3] = 0                           # a last node: no psi
        lo, count = pipeline.active_nodes(t, n, chunks)
        outs = []
        for fn in (kernel.chain_tick, ref.chain_tick_ref):
            out = torch.zeros((n, O, S * chunks), dtype=torch.int32, device=dev)
            wire_out = torch.zeros_like(wire_in)
            fn(wire_in, wire_out, local, out, bp_psi, bp_xi, l, t, chunks, lo, count)
            outs.append((out, wire_out))
        torch.cuda.synchronize()
        for got, want in zip(outs[0], outs[1]):
            check(torch.equal(got, want), f"chain_tick l={l} max_b={max_b}")
            errs["chain_tick"] = max(errs["chain_tick"], max_abs_err(got, want))
        # the single-node op with the JAX shapes, batched
        x1 = rand_i32(gen, (O, 1, S), dev)
        loc1 = rand_i32(gen, (O, max_b, S), dev)
        c, xo = ops.chain_step(x1, loc1, bp_psi[0], bp_xi[0], l)
        for o in range(O):
            cr, xr = ref.chain_step_ref(x1[o], loc1[o], _coeffs(bp_psi[0]),
                                        _coeffs(bp_xi[0]), l)
            check(torch.equal(c[o], cr) and torch.equal(xo[o], xr),
                  f"chain_step l={l} max_b={max_b}")
        wire_out = torch.zeros_like(wire_in)
        out = torch.zeros((n, O, S * chunks), dtype=torch.int32, device=dev)
        ms = median_ms(lambda: kernel.chain_tick(wire_in, wire_out, local, out,
                                                 bp_psi, bp_xi, l, t, chunks,
                                                 lo, count), 20)
        print(f"chain_tick  l={l:2d} max_b={max_b} nodes={count} O={O} S={S}: "
              f"bit-exact, median {ms:.4f} ms")

    n, t = 4, 4                                 # tick 4: nodes 2..3, 3 is last
    for l, rows in itertools.product((8, 16), (3, 11)):
        S = 1000 + 3 * l + rows
        wire_in = rand_i32(gen, (n, O, rows, S), dev)
        local = rand_i32(gen, (n, O, S * chunks), dev)
        bp = planes(rng, (n, rows), l, dev)
        lo, count = pipeline.active_nodes(t, n, chunks)
        outs = []
        for fn in (kernel.repair_tick, ref.repair_tick_ref):
            out = torch.zeros((O, rows, S * chunks), dtype=torch.int32, device=dev)
            wire_out = torch.zeros_like(wire_in)
            fn(wire_in, wire_out, local, out, bp, l, t, chunks, lo, count)
            outs.append((out, wire_out))
        torch.cuda.synchronize()
        for got, want in zip(outs[0], outs[1]):
            check(torch.equal(got, want), f"repair_tick l={l} rows={rows}")
            errs["repair_tick"] = max(errs["repair_tick"], max_abs_err(got, want))
        acc = ops.repair_step(wire_in[0], local[0, :, None, :S].contiguous(), bp[0], l)
        for o in range(O):
            want = ref.repair_step_ref(wire_in[0, o], local[0, o, :S],
                                       _coeffs(bp[0]), l)
            check(torch.equal(acc[o], want), f"repair_step l={l} rows={rows}")
        wire_out = torch.zeros_like(wire_in)
        out = torch.zeros((O, rows, S * chunks), dtype=torch.int32, device=dev)
        ms = median_ms(lambda: kernel.repair_tick(wire_in, wire_out, local, out,
                                                  bp, l, t, chunks, lo, count), 20)
        print(f"repair_tick l={l:2d} rows={rows:2d} nodes={count} O={O} S={S}: "
              f"bit-exact, median {ms:.4f} ms")


def _coeffs(bp_rows: torch.Tensor) -> np.ndarray:
    """Coefficients back from their bit-plane rows: plane 0 is c * alpha^0."""
    return bp_rows[:, 0].cpu().numpy()


def first_decodable_loss(code, seed: int) -> list[int]:
    combos = list(itertools.combinations(range(code.n), LOST))
    for j in np.random.default_rng(seed).permutation(len(combos)):
        alive = sorted(set(range(code.n)) - set(combos[j]))
        if code.decodable(alive):
            return list(combos[j])
    raise RuntimeError(f"no decodable {LOST}-node loss pattern")


def replay(n: int, tick, wire_shape, dev, run_tick):
    """A fresh run of the main path's ticks through ``tick``; returns its timer."""
    wires = [torch.zeros(wire_shape, dtype=torch.int32, device=dev) for _ in range(2)]

    def run():
        for t in range(pipeline.num_ticks(NUM_CHUNKS, n)):
            lo, count = pipeline.active_nodes(t, n, NUM_CHUNKS)
            run_tick(tick, wires[(t + 1) % 2], wires[t % 2], t, lo, count)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the code's coefficients and of the data")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    seed = args.seed

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    kernel.load_library()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"build: {build_s:.2f} s ({kernel.library_path().name})")
    print("ptxas:", " | ".join(line.strip() for line in kernel.build_log().splitlines()
                              if "registers" in line or "spill" in line))
    print(smi)  # the card's name and power limit, as nvidia-smi gives them

    # -- phase 2: kernels vs plain versions, small ragged shapes -------------
    errs = {"chain_tick": 0, "repair_tick": 0}
    phase_kernels(dev, seed, errs)

    # -- phase 3: the main path at full size ----------------------------------
    code = rapidraid.RapidRAIDCode.make(N, K, l=L, seed=seed)
    B = 1 << 25
    rng = np.random.default_rng(seed)
    data_np = rng.integers(0, 1 << L, size=(K, B), dtype=np.uint16)
    data_p = torch.from_numpy(data_np.view(np.int32)).to(dev)   # packed lanes
    data = gf.unpack_u32(data_p, L)
    obj_bytes = data_np.nbytes
    lost = first_decodable_loss(code, seed)
    ids = [i for i in range(N) if i not in lost]
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    cw = chain.pipelined_encode(code, data, num_chunks=NUM_CHUNKS)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    enc_counts = kernel.launch_counts()
    enc_peak = torch.cuda.max_memory_allocated()
    cw_p = gf.pack_u32(cw, L)
    shards = gf.unpack_u32(cw_p[torch.tensor(ids, device=dev)], L)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = chain.pipelined_decode(code, ids, shards, num_chunks=NUM_CHUNKS)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3
    counts = kernel.launch_counts()
    dec_peak = torch.cuda.max_memory_allocated()

    enc_ticks = pipeline.num_ticks(NUM_CHUNKS, N)
    dec_ticks = pipeline.num_ticks(NUM_CHUNKS, len(ids))
    check(enc_counts == {"chain_tick": enc_ticks, "repair_tick": 0},
          f"encode launches {enc_counts}, want {enc_ticks} chain_tick")
    check(counts == {"chain_tick": enc_ticks, "repair_tick": dec_ticks},
          f"decode launches {counts}, want {dec_ticks} repair_tick")
    check(tuple(cw.shape) == (N, B), f"codeword shape {tuple(cw.shape)}")
    check(torch.equal(gf.pack_u32(rec, L), data_p), "decoded object == data")
    check(torch.equal(cw_p, gf.gf_matvec_packed(code.G, data_p, L)),
          "codeword == plain packed matvec on the card")
    chunk = B // NUM_CHUNKS
    starts = [0, chunk - 32, 3 * chunk - 64, 5 * chunk - 2, B - 64,
              int(rng.integers(0, B // 2 - 64)) * 2]
    for s in starts:                      # lane-aligned windows, some straddling chunks
        win = cw_p[:, s // 2:s // 2 + 32].cpu().numpy().view(np.uint16)
        want = gf.gf_matmul_np(code.G, data_np[:, s:s + 64], L)
        check(np.array_equal(win, want), f"codeword window at word {s} vs host field")
    # repeat calls, outside the counted run: the first call above also pays
    # for first use of each CUDA module in the process
    enc_warm = wall_ms(lambda: chain.pipelined_encode(code, data, num_chunks=NUM_CHUNKS))
    dec_warm = wall_ms(lambda: chain.pipelined_decode(code, ids, shards,
                                                      num_chunks=NUM_CHUNKS))
    mib = obj_bytes / 2**20
    print(f"main path: ({N},{K}) GF(2^{L}) seed={seed}, object {obj_bytes} bytes "
          f"({mib:.0f} MiB), {NUM_CHUNKS} chunks, lost nodes {lost}")
    print(f"encode: {enc_ms:.3f} ms wall first call, {enc_warm:.3f} ms median of "
          f"5 repeats ({mib / enc_warm * 1e3:.1f} MiB/s of object), chain_tick "
          f"launches {enc_counts['chain_tick']}, peak {enc_peak / 2**30:.2f} GiB")
    print(f"decode: {dec_ms:.3f} ms wall first call, {dec_warm:.3f} ms median of "
          f"5 repeats ({mib / dec_warm * 1e3:.1f} MiB/s of object), repair_tick "
          f"launches {counts['repair_tick']}, peak {dec_peak / 2**30:.2f} GiB")
    print(f"checks: decode == data, codeword == plain matvec, "
          f"{len(starts)} windows == host gf_matmul_np")

    # -- phase 4: the main path's ticks, kernel vs plain version --------------
    Bp, S = B // 2, B // 2 // NUM_CHUNKS
    local, bp_psi, bp_xi = chain.encode_operands(code, data_p)
    placement_ms = median_ms(lambda: chain.encode_operands(code, data_p), 5)
    enc_outs = {}

    def enc_tick(tick, wi, wo, t, lo, count):
        tick(wi, wo, local, enc_outs[tick], bp_psi, bp_xi, L, t, NUM_CHUNKS, lo, count)

    timings = {}
    for tick, reps in ((kernel.chain_tick, 5), (ref.chain_tick_ref, 3)):
        enc_outs[tick] = torch.empty((N, 1, Bp), dtype=torch.int32, device=dev)
        timings[tick] = median_ms(replay(N, tick, (N + 1, 1, S), dev, enc_tick), reps)
    check(torch.equal(enc_outs[kernel.chain_tick], enc_outs[ref.chain_tick_ref]),
          "chain_tick == plain version over the main path's ticks")
    check(torch.equal(enc_outs[kernel.chain_tick][:, 0], cw_p), "replayed codeword")
    errs["chain_tick"] = max(errs["chain_tick"], max_abs_err(
        enc_outs[kernel.chain_tick], enc_outs[ref.chain_tick_ref]))

    dec_local = gf.pack_u32(shards, L)[:, None]
    bp = chain.decode_operands(code, ids, dev)
    n_alive = len(ids)
    dec_outs = {}

    def dec_tick(tick, wi, wo, t, lo, count):
        tick(wi, wo, dec_local, dec_outs[tick], bp, L, t, NUM_CHUNKS, lo, count)

    for tick, reps in ((kernel.repair_tick, 5), (ref.repair_tick_ref, 3)):
        dec_outs[tick] = torch.empty((1, K, Bp), dtype=torch.int32, device=dev)
        timings[tick] = median_ms(
            replay(n_alive, tick, (n_alive, 1, K, S), dev, dec_tick), reps)
    check(torch.equal(dec_outs[kernel.repair_tick], dec_outs[ref.repair_tick_ref]),
          "repair_tick == plain version over the main path's ticks")
    check(torch.equal(dec_outs[kernel.repair_tick][0], data_p), "replayed decode")
    errs["repair_tick"] = max(errs["repair_tick"], max_abs_err(
        dec_outs[kernel.repair_tick], dec_outs[ref.repair_tick_ref]))

    # Bounds over all of a run's ticks. Per active node and lane, chain_tick
    # reads the wire and each replica slot and writes the codeword and the
    # wire; each slot with nonzero planes costs l masks (shift, and), an
    # xi multiply + xor, and a psi multiply + xor where psi is nonzero.
    # repair_tick reads the local lane and `rows` sums and writes `rows`
    # sums, with l masks and rows * l multiply + xor.
    valid = code.chain.block_valid
    psi_nz = code.chain.psi != 0
    enc_bytes = sum(3 + int(valid[i].sum()) for i in range(N)) * Bp * 4
    enc_ops = sum(L * (4 + 2 * int(psi_nz[i, s]))
                  for i in range(N) for s in range(code.chain.max_blocks)
                  if valid[i, s]) * Bp
    dec_bytes = n_alive * (2 * K + 1) * Bp * 4
    dec_ops = n_alive * (2 * L + 2 * K * L) * Bp
    rows = []
    for name, tick, plain, nbytes, nops in (
            ("chain_tick", kernel.chain_tick, ref.chain_tick_ref, enc_bytes, enc_ops),
            ("repair_tick", kernel.repair_tick, ref.repair_tick_ref, dec_bytes, dec_ops)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": timings[tick],
            "plain_ms": timings[plain], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes a GF(2^l) multiply-accumulate
            "library_ms": None,
            "bytes": nbytes, "ops": nops,
        })
        print(f"{name}: {counts[name]} launches on the main path; over its ticks "
              f"{timings[tick]:.3f} ms (plain {timings[plain]:.3f} ms), bound "
              f"{max(bytes_ms, ops_ms):.3f} ms (bytes {bytes_ms:.3f}, ops {ops_ms:.3f})")
    print(f"encode placement (gather + mask of the replica blocks): "
          f"{placement_ms:.3f} ms")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
