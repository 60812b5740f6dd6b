#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass or the script exits non-zero before its
last line:

1. Build the CUDA kernels from ``src/repro_torch/kernels/gf_encode/csrc``
   with nvcc, one process per source (timed), and print the card's name
   and power limit.
2. Hold each kernel bit-exact against its plain PyTorch version on the card,
   for GF(2^8) and GF(2^16), one and two objects and ragged lane counts:
   ``chain_tick`` at 1, 2, 3 and 5 replica slots (30 and 50, whose tables
   are staged in turn), with and without the last node's wire, and over
   300 active nodes (several launches); ``repair_tick`` through row tables
   that are not the identity, with node 0's head row read and skipped, at
   3, 11 and 13 rows, past the first kernel's 48 KB of planes (800 rows at
   GF(2^16), 1600 at GF(2^8)) and over 300 active nodes. Print each
   kernel's median time at the small shapes.
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
   version, check they agree and give the codeword and the object, and
   time both; print the host build of the encode's and the decode's
   product tables, first and cached, and the encode's peak device bytes.
   (``tools/ab_chain_tick.py`` and ``tools/ab_repair_tick.py`` time earlier
   builds of the tick kernels against the package's.)
5. Hold the static-coefficient kernels (bit-plane ``gf_encode``, built per
   matrix at its first use, and bit-lift ``gf_encode_mxu``) bit-exact
   against their plain versions on the card at small, ragged shapes,
   including matrices past the size limits of their first versions; print
   each kernel's median time there.
6. The slice of the paper's other half on the same object: the atomic
   classical encode (a (16,11) Cauchy Reed-Solomon code, the paper's CEC
   baseline), the single-node RapidRAID encode (``atomic.encode_local``),
   the bit-lift encode (``ops.encode_mxu``), repair of the 5 lost codeword
   blocks from the 11 survivors (``repair.pipelined_repair`` as a reverse
   chain of repair ticks, and ``repair.star_repair``) and a degraded read of
   3 object blocks over a 2^19-word window. Each entry point runs once with
   the counters set to 0 just before and read just after, and its result is
   checked; then wall time of 5 repeats and peak device bytes. Then each
   per-matrix ``gf_encode`` build's time and ptxas report, and the
   bit-lift's shared memory per block.
7. Replay each new kernel's launches of phase 6, and the repair ticks,
   against the plain versions and time both.
8. Multi-object archival at Fig. 4's concurrency (paper §VI): 16 objects,
   each the paper's 704 MiB (11 blocks of 2^25 words; not cut), made on the
   card from the seed, run through ``pipelined_encode_many``,
   ``pipelined_repair_many`` of the 5 lost blocks and
   ``pipelined_decode_many`` from the 11 survivors at stagger 1, each once
   with the counters set to 0 just before and read just after (launches ==
   ``num_ticks_many``: 38, 33, 33) and its peak device bytes above the
   resident inputs. Checks: every codeword against the plain packed matvec
   on the card and windows of three objects against host numpy; the
   repaired rows and the decoded objects. Wall times, first call and median
   of 5, at staggers 1, 4 and 8 and for the loop of 16 single-object calls
   beside each path; then each path's ticks replayed through the kernel and
   its plain version (the ``chain_tick[many]`` and ``repair_tick[many]``
   rows). The codewords are freed once the survivors and lost rows are
   taken, and the repair runs before the decode, whose wires are 15 GiB:
   the phase peaks near 65 GiB, at the decode's plain replay.
9. The staggered ticks against their plain versions tick by tick (every
   tick's wire and the outputs) for 16 objects of 2^22 words and 64 of
   Fig. 4's 5.8 MB object (11 blocks of 2^18 words), at staggers 1, 3, 8
   and 9 (past the chunk count); both routes timed at stagger 1, and at 64
   objects each staggered entry point against the loop of 64 single calls.
10. The code families at small shapes: ``encode_local`` of an LRC (16,11)
   and an MBR (6,4) generator against ``encode_np``; an LRC block repaired
   from its local group by ``pipelined_repair`` and ``star_repair`` against
   ``repair_np``.
11. Streaming at a size users stream: the (16,11) code over an object of
   11 blocks of 2^28 words (5.5 GiB), made on the card from the seed and
   kept in pinned host memory, at a 1 GiB device budget
   (``streaming.superchunk_words_for``: 2^21 words a stripe, 128
   stripes). ``pipelined_encode``, ``pipelined_decode`` from the 11
   survivors and ``pipelined_repair`` of the 5 lost rows stream it with a
   ``sink`` that hashes each output row incrementally (sha256), each twice:
   the first call with the counters at 0 just before and read just after
   (stripes x ticks, plus the one warm-up run a program makes before it
   captures its graphs), the second building no program. Each digest is
   held against that of the monolithic call on the card, and the stripe's
   device footprint (``streaming.measure_footprint`` of a program's first
   stripe) against the budget. Printed: walls, the pinned h2d and d2h
   rates on a 256 MiB buffer, the bound max(in-bytes / h2d, out-bytes /
   d2h, the ticks' time), and the overlap (the serial sum of copies and
   ticks over the wall). Then phase 3's 704 MiB object streamed at 2^20 and
   2^22 words a stripe, its digests held against phase 3's codeword.
12. The archive at the paper's size: a 16-node ``NodeStore`` in a
   temporary directory takes phase 3's object by ``hot_save``; then
   ``archive_step`` on the card, the loss of nodes ``[5, 6, 7, 8, 14]``,
   ``restore_blocks_ex`` (degraded, the object bit-exact; its decode runs on
   the host, the JAX package's route), ``repair`` (every coded blob's
   digest equals the manifest's), ``read_range_ex`` of 1 MiB across a block
   boundary, the same ``archive_step`` streamed at 4 MiB stripes into a
   second store (blobs and ``coded_digests`` identical), and
   ``archive_many`` / ``repair_many`` over 8 objects of 11 blocks of 6 MiB
   at stagger 1 against one ``archive_step`` / ``repair`` each. Each wall is
   printed with the share the kernels take (CUDA events around each
   launch or graph replay). The store is removed at the end.
13. Checkpointing a real train state: whisper-base's (``WHISPER_BASE_PARAMS``:
   the JAX package's model and AdamW state at full depth, 83 leaves, a
   1.227 GiB blob), made on the card from the seed, through a
   ``CheckpointManager`` on 16-node (16,11) GF(2^16) stores in a temporary
   directory: ``save_sharded`` (blocks against ``tree_to_bytes``, the
   codeword against the plain matvec on the card, ``num_ticks`` chain_tick
   launches), a second save of new values building no program, nodes
   ``[5, 6, 7, 8, 14]`` lost and ``restore_sharded`` bit for bit (repair
   ticks counted), the static route (``use_devices=False``: coded blobs
   equal step 1's byte for byte, one ``gf_encode`` launch each way), the
   host route (``save`` x 3 with ``hot_keep=1``, so ``_migrate_old``
   archives two steps; ``restore`` after the losses, the archived step
   through ``restore_sharded``, ``read_range`` across a leaf boundary), and
   a save streamed at a 256 MiB ``footprint_bytes`` (its stripe record, its
   digests equal the device-direct save's, a bit-exact restore through the
   host decode). Each step's wall, kernels' share and peak device bytes
   above what was resident are printed, and each store's bytes before it
   is removed.
14. The control plane: ``autotune.prewarm`` in search mode on the (16,11)
   GF(2^16) code at 2^25 words a block and 4 objects, with a tuning cache
   of the run's own; the calibration, both dispatch timings and the
   winner, the tuned chunk counts and stagger are printed. Then a cached
   process: the entry points at ``num_chunks=None`` / ``stagger=None``
   make zero probes and equal the explicit calls; ``encode_auto`` on a
   ``"vpu"`` and an ``"mxu"`` entry launches ``gf_encode`` /
   ``gf_encode_mxu`` and equals the plain versions; a probe whose kernel
   fails raises; ``archive_step`` with a topology whose nodes 3 and 9 are
   slowed 4x records the scheduler's plan and restores bit for bit; and
   ``python -m repro_torch.autotune`` on the warm cache exits 0 with zero
   probes.
15. The live cluster at a real size: the (16,11) GF(2^16) code on a
   16-node ``ChurnNodeStore`` in a temporary directory, blocks of 16 MiB
   (objects of 176 MiB), ``LifecycleConfig(arrival_rate=1.0,
   archive_age=3, batch_max=4)`` under ``churn.bounded_trace(16, 11, 24,
   fail_rate=0.05)``, behind ``benchmarks/fig_serving.py``'s admission
   controller (rate 2, burst 4, read capacity 8, 2 in flight), served by
   ``ServingEngine`` over the default ``WorkloadConfig`` (8 reads a tick,
   Zipf 1.1 over 16 ranks, 4-256 KiB, 2M users) for 24 ticks, with the
   counters at 0 just before the first tick and read after the last
   (``chain_tick`` for the migrations, ``repair_tick`` for the coded
   scrub). Checks: no lost object, no wrong byte, shards healed,
   ``verify_all`` restores every object digest-verified. Printed: each
   tick's wall and the kernels' share of it, the peak bytes on disk, the
   modelled read latencies. Then the same trace and workload at 4 KiB
   blocks on the card and with the plain versions (``device="cpu"``):
   per-tick rows, serving reports and store trees equal, file by file.
16. LM serving: qwen3-1.7b at full width and depth (28 layers, d_model
   2048, vocab 151936, 2.03 B float32 parameters made on the card from the
   seed) serves a batch of 4 prompts of 2048 tokens and 64 greedy new
   tokens through ``launch.serve.generate`` in bfloat16 (prefill wall,
   decode tokens/s, peak device bytes; no GF kernel launches); 4 decode
   steps after a prefill against one prefill over the longer prompt, in
   float32 (TF32 off) at rtol = atol = 2e-2 and in bfloat16 within 2e-2 of
   the logits' largest magnitude; a 2-layer full-width copy in float32
   (TF32 off) on the card against the host: the same greedy tokens, logits
   within 1e-3.

Then one JSON line with every kernel's numbers over all of the run's
launches (the staggered launches of phase 8 in rows of their own;
``slice_launches``: each kernel's launches over phases 13-14's counted
runs, every one of which must be above 0, and over phase 15's soak), and
the device line.

Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import devio, manager  # noqa: E402
from repro_torch.core import (autotune, churn, classical, codes, fault_tolerance,  # noqa: E402
                              gf, jitcache,
                              pipeline, rapidraid, scheduler, streaming, topology)
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.admission import AdmissionConfig, AdmissionController  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.storage import (archive, atomic, chain, lifecycle, multi,  # noqa: E402
                                 object_store, repair, serving, workload)

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet and
# Hopper white paper): HBM3 bandwidth, the non-tensor INT32 rate
# (132 SMs x 64 INT32 lanes x 2 ops x 1.98 GHz) — no tensor core computes a
# GF(2^l) product, so the integer pipes are the peak for the bit-plane
# arithmetic — and the dense int8 tensor-core rate the bit-lift runs on.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
INT8_OPS_PER_S = 1979e12

N, K, L = 16, 11, 16
NUM_CHUNKS = 8
LOST = 5
READ_BLOCKS = [0, 5, 10]
READ_WORDS = 1 << 19
PAST_CAPS_MXU = [(17, 11), (2, 17)]
PAST_CAPS_PACKED = (12, 64)
PAST_CAPS_MAX_B = (3, 5)                 # chain_tick slot counts past the unrolled 1 and 2
PAST_CAPS_ROWS = ((16, 800), (8, 1600))  # repair_tick rows past 48 KB of planes
MANY_OBJECTS = 16                        # Fig. 4's concurrent objects (paper §VI)
MANY_BLOCK_WORDS = 1 << 25               # each the paper's 704 MiB object (Table II)
MANY_STAGGERS = (1, 4, 8)                # the first is the counted run's
TICK_SHAPES = ((16, 1 << 22), (64, 1 << 18))   # phase 9: (objects, words a block)
TICK_STAGGERS = (1, 3, 8, NUM_CHUNKS + 1)
FAMILY_CODES = (("lrc", 16, 11, 16), ("mbr", 6, 4, 8))   # phase 10: (family, n, k, l)
STREAM_BLOCK_WORDS = 1 << 28             # phase 11: 11 blocks of 2^28 words, 5.5 GiB
STREAM_BUDGET = 1 << 30                  # phase 11: device bytes a stripe may take
STREAM_WIDTHS = (1 << 20, 1 << 22)       # phase 11: the 704 MiB object's stripe widths
COPY_RATE_BYTES = 256 << 20              # phase 11: the buffer the copy rates are taken on
ARCHIVE_STRIPE_BYTES = 4 << 20           # phase 12: 2^21 words, phase 11's stripe width
ARCHIVE_OBJECTS = 8                      # phase 12: archive_many / repair_many batch
ARCHIVE_BLOCK_BYTES = 6 << 20            # phase 12: each of the batch's 11 blocks
READ_RANGE_BYTES = 1 << 20               # phase 12: read_range_ex across a block boundary
# Phase 13: whisper-base's train state as the JAX package's
# benchmarks/fig_checkpoint.py builds it (model.init and adamw.init_opt of
# configs/whisper_base.py, at full depth): each parameter's path and shape,
# all float32; the AdamW m and v mirror the parameters, beside an int32
# count and an np.int64 step: 83 leaves, a 1,316,999,375-byte blob.
WHISPER_BASE_PARAMS = (
    ("dec_layers/attn/wk", (6, 512, 512)), ("dec_layers/attn/wo", (6, 512, 512)),
    ("dec_layers/attn/wq", (6, 512, 512)), ("dec_layers/attn/wv", (6, 512, 512)),
    ("dec_layers/mlp/wg", (6, 512, 2048)), ("dec_layers/mlp/wi", (6, 512, 2048)),
    ("dec_layers/mlp/wo", (6, 2048, 512)), ("dec_layers/norm1/scale", (6, 512)),
    ("dec_layers/norm2/scale", (6, 512)), ("dec_layers/norm_x/scale", (6, 512)),
    ("dec_layers/xattn/wk", (6, 512, 512)), ("dec_layers/xattn/wo", (6, 512, 512)),
    ("dec_layers/xattn/wq", (6, 512, 512)), ("dec_layers/xattn/wv", (6, 512, 512)),
    ("embed", (51865, 512)),
    ("enc_layers/attn/wk", (6, 512, 512)), ("enc_layers/attn/wo", (6, 512, 512)),
    ("enc_layers/attn/wq", (6, 512, 512)), ("enc_layers/attn/wv", (6, 512, 512)),
    ("enc_layers/mlp/wg", (6, 512, 2048)), ("enc_layers/mlp/wi", (6, 512, 2048)),
    ("enc_layers/mlp/wo", (6, 2048, 512)), ("enc_layers/norm1/scale", (6, 512)),
    ("enc_layers/norm2/scale", (6, 512)), ("enc_norm/scale", (512,)),
    ("final_norm/scale", (512,)), ("lm_head", (512, 51865)),
)
WHISPER_BLOB_BYTES = 1316999375
CKPT_LOST = [5, 6, 7, 8, 14]             # phase 13: the nodes lost before restore_sharded
CKPT_STREAM_BUDGET = 256 << 20           # phase 13: footprint_bytes of the streamed save
CKPT_RANGE_BYTES = 1 << 20               # phase 13: read_range across a leaf boundary
TUNE_BLOCK_WORDS = 1 << 25               # phase 14: the paper's block, 2^25 words
TUNE_OBJECTS = 4                         # phase 14: prewarm's b_obj
SLOW_NODES = (3, 9)                      # phase 14: slowed 4x in the archive's topology
LIVE_BLOCK_BYTES = 16 << 20              # phase 15: blocks of 16 MiB, objects of 176 MiB
LIVE_TICKS = 24                          # phase 15: ticks of churn, arrivals and reads
# Phase 15's churn: at 0.03 the seed-0 trace heals nothing, because the
# admission controller (read_capacity = the mean request rate) denies every
# routine repair and no loss is urgent; at 0.05 the scrub heals shards.
LIVE_FAIL_RATE = 0.05
LIVE_PARITY_BLOCK_BYTES = 4 << 10        # phase 15: the card-against-plain run
LM_ARCH = "qwen3-1.7b"                   # phase 16: served at full width and depth
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 64    # phase 16: four q_chunks of prompt
LM_CHECK_STEPS = 4                       # phase 16: decode steps held against one prefill
# Phase 16's consistency bound: tests/test_models.py:86's rtol = atol in
# float32; in bfloat16 the largest error within it of the logits' scale (a
# (B, 1, D) product and a (B, S, D) one round differently, and at 28 layers
# 5-6% of the logits fall outside the elementwise bound while float32 agrees
# to 2e-5).
LM_TOL = 2e-2
LM_CPU_LAYERS, LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_NEW = 2, 2, 32, 8
LM_CPU_TOL = 1e-3                        # phase 16: float32 card (TF32 off) vs host, rtol = atol
REPLACES = {
    "chain_tick": "src/repro/kernels/gf_encode/kernel.py:115",
    "repair_tick": "src/repro/kernels/gf_encode/kernel.py:164",
    "gf_encode": "src/repro/kernels/gf_encode/kernel.py:68",
    "gf_encode_mxu": "src/repro/kernels/gf_encode/kernel.py:241",
    # the staggered launches of phase 8, kept apart from the single-object rows
    "chain_tick[many]": "src/repro/kernels/gf_encode/kernel.py:115",
    "repair_tick[many]": "src/repro/kernels/gf_encode/kernel.py:164",
}
# Why each row's library_ms is null: there is no PyTorch call to time.
_NO_GF = "no PyTorch call computes a GF(2^l) multiply-accumulate (no carry-less or finite-field product)"
LIBRARY_WHY = {
    "chain_tick": _NO_GF, "repair_tick": _NO_GF, "gf_encode": _NO_GF,
    "chain_tick[many]": _NO_GF, "repair_tick[many]": _NO_GF,
    "gf_encode_mxu": "no PyTorch call computes the bit-lift with its unpack and mod-2 "
                     "repack; an int8 matmul is only its middle step",
}
CSRC = "src/repro_torch/kernels/gf_encode/csrc/"
SOURCE = {"chain_tick": CSRC + "gf_tick.cu", "repair_tick": CSRC + "gf_tick.cu",
          "gf_encode": CSRC + "gf_encode.cu", "gf_encode_mxu": CSRC + "gf_mxu.cu",
          "chain_tick[many]": CSRC + "gf_tick.cu", "repair_tick[many]": CSRC + "gf_tick.cu"}


def whisper_state(fill, count: int = 1, step: int = 1) -> dict:
    """Phase 13's train state: ``fill(shape)`` makes each float32 leaf of
    the parameters and of AdamW's m and v (``WHISPER_BASE_PARAMS``), beside
    an int32 ``count`` tensor and an ``np.int64`` step. ``fill`` on the
    ``meta`` device gives the layout without data."""
    def params() -> dict:
        out: dict = {}
        for path, shape in WHISPER_BASE_PARAMS:
            *head, leaf = path.split("/")
            node = out
            for key in head:
                node = node.setdefault(key, {})
            node[leaf] = fill(shape)
        return out
    template = fill((1,))
    return {"opt": {"count": torch.full((), count, dtype=torch.int32, device=template.device),
                    "m": params(), "v": params()},
            "params": params(), "step": np.int64(step)}


def smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query>`` for the card, as one csv line."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def only(**launches: int) -> dict[str, int]:
    """A ``launch_counts()`` dict: the given kernels' counts, every other 0."""
    return {name: launches.get(name, 0) for name in kernel.launch_counts()}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the elements, taken 2^27 at a time (phase 8's
    tensors are 16 GiB)."""
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 27
    return max((int((a[i:i + step].long() - b[i:i + step].long()).abs().max().item())
                for i in range(0, a.numel(), step)), default=0)


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
    n, R, chunks, t = 5, 4, 3, 4            # tick 4: nodes 2..4, 4 is the last
    lo, count = pipeline.active_nodes(t, n, chunks)
    for l, max_b, S, O in itertools.product((8, 16), (1, 2) + PAST_CAPS_MAX_B, (37, 1000, 1002),
                                            (1, 2)):
        wire_in, src, slots, psi, xi, tables = chain_case(rng, gen, l, max_b, n, R, O, S,
                                                          chunks, dev)
        wire_rows = n if O == 1 else n + 1      # without and with the last node's wire
        check_chain_tick(wire_in, src, slots, tables, l, t, chunks, lo, count, wire_rows,
                         errs, f"l={l} max_b={max_b} S={S} O={O}")
        if (S, O) != (1000, 2):
            continue
        # the single-node op with the JAX shapes, batched
        x1 = rand_i32(gen, (O, 1, S), dev)
        loc1 = rand_i32(gen, (O, max_b, S), dev)
        p_psi, p_xi = (torch.from_numpy(gf.bitplane_table(c[0], l).astype(np.int32)).to(dev)
                       for c in (psi, xi))
        c, xo = ops.chain_step(x1, loc1, p_psi, p_xi, l)
        for o in range(O):
            cr, xr = ref.chain_step_ref(x1[o], loc1[o], psi[0], xi[0], l)
            check(torch.equal(c[o], cr) and torch.equal(xo[o], xr),
                  f"chain_step l={l} max_b={max_b}")
        out = torch.zeros((n, O, S * chunks), dtype=torch.int32, device=dev)
        wire_out = torch.zeros((wire_rows, O, S), dtype=torch.int32, device=dev)
        ms = median_ms(lambda: kernel.chain_tick(wire_in, wire_out, src, slots, out, tables,
                                                 l, t, chunks, lo, count), 20)
        print(f"chain_tick  l={l:2d} max_b={max_b} nodes={count} O=1,2 S=37,1000,1002: "
              f"bit-exact; median at O={O} S={S}: {ms:.4f} ms")
    # slots whose tables pass 48 KB, staged one group after another
    for l, max_b in ((16, 30), (8, 50)):
        wire_in, src, slots, _, _, tables = chain_case(rng, gen, l, max_b, n, R, 2, 1000,
                                                       chunks, dev)
        check_chain_tick(wire_in, src, slots, tables, l, t, chunks, lo, count, n + 1, errs,
                         f"l={l} max_b={max_b}")
    # a tick over more active nodes than one launch takes
    n_wide, chunks_wide, t_wide = 310, 300, 305
    lo_w, count_w = pipeline.active_nodes(t_wide, n_wide, chunks_wide)
    for l, max_b, S in ((8, 1, 4), (16, 2, 3), (16, 3, 4)):
        wire_in, src, slots, _, _, tables = chain_case(rng, gen, l, max_b, n_wide, R, 2, S,
                                                       chunks_wide, dev)
        before = kernel.chain_tick.launches
        check_chain_tick(wire_in, src, slots, tables, l, t_wide, chunks_wide, lo_w, count_w,
                         n_wide, errs, f"{count_w} nodes l={l} max_b={max_b} S={S}")
        want = -(-count_w // min(kernel.MAX_TICK_NODES, kernel.MAX_TICK_SLOTS // max_b))
        check(kernel.chain_tick.launches - before == want,
              f"chain_tick over {count_w} nodes: {kernel.chain_tick.launches - before} "
              f"launches, want {want}")
    print(f"chain_tick past the old caps: max_b={PAST_CAPS_MAX_B} at O=1,2 S=37,1000,1002, "
          f"max_b=30 (l=16) and 50 (l=8) staged in turn, {count_w} active nodes at "
          f"max_b=1,2,3: bit-exact")

    n, O = 4, 2                                 # tick 4: nodes 2..3, 3 is last; tick 2: 0..2
    for l, rows in itertools.product((8, 16), (3, 11, 13)):
        S = 1000 + 3 * l + rows
        wire_in, shards, shard_rows, tables, bp = repair_case(rng, gen, l, rows, n, O, S,
                                                              chunks, dev)
        check_repair_tick(wire_in, shards, shard_rows, tables, l, chunks, errs,
                          f"l={l} rows={rows} S={S}")
        acc = ops.repair_step(wire_in[0], shards[0, :, None, :S].contiguous(), bp[0], l)
        for o in range(O):
            want = ref.repair_step_ref(wire_in[0, o], shards[0, o, :S], _coeffs(bp[0]), l)
            check(torch.equal(acc[o], want), f"repair_step l={l} rows={rows}")
        lo, count = pipeline.active_nodes(4, n, chunks)
        wire_out = torch.zeros_like(wire_in)
        out = torch.zeros((O, rows, S * chunks), dtype=torch.int32, device=dev)
        ms = median_ms(lambda: kernel.repair_tick(wire_in, wire_out, shards, shard_rows, out,
                                                  tables, l, 4, chunks, lo, count), 20)
        print(f"repair_tick l={l:2d} rows={rows:2d} nodes={count} O={O} S={S}: "
              f"bit-exact, median {ms:.4f} ms")
    # rows past 48 KB of planes: tables staged in turn
    for (l, rows), S, O in itertools.product(PAST_CAPS_ROWS, (37, 1000), (1, 2)):
        wire_in, shards, shard_rows, tables, _ = repair_case(rng, gen, l, rows, n, O, S,
                                                             chunks, dev)
        check_repair_tick(wire_in, shards, shard_rows, tables, l, chunks, errs,
                          f"past the old cap l={l} rows={rows} S={S} O={O}")
    # a tick over more active nodes than one launch takes
    rows, l, S = 3, 16, 8
    t_wide = n_wide - 1
    lo_w, count_w = pipeline.active_nodes(t_wide, n_wide, chunks_wide)
    wire_in, shards, shard_rows, tables, _ = repair_case(rng, gen, l, rows, n_wide, 1, S,
                                                         chunks_wide, dev)
    before = kernel.repair_tick.launches
    check_repair_tick(wire_in, shards, shard_rows, tables, l, chunks_wide, errs,
                      f"{count_w} nodes", ticks=((t_wide, False),))
    check(kernel.repair_tick.launches - before == 2,
          f"repair_tick over {count_w} nodes: {kernel.repair_tick.launches - before} launches")
    print(f"repair_tick past the old caps: (l, rows) {PAST_CAPS_ROWS} at O=1,2 S=37,1000, "
          f"{count_w} active nodes; row tables not the identity, head row read and "
          f"skipped: bit-exact")


def chain_case(rng, gen, l, max_b, n, R, O, S, chunks, dev):
    """Operands of one chain tick: blocks read through slots, a padded slot
    (-1) and a last node without psi; returns the coefficients too."""
    wire_in = rand_i32(gen, (n + 1, O, S), dev)
    src = rand_i32(gen, (O, R, S * chunks), dev)
    slots = rng.integers(0, R, size=(n, max_b)).astype(np.int32)
    psi, xi = rng.integers(1, 1 << l, size=(2, n, max_b))
    slots[2, max_b - 1] = -1                # a padded slot
    psi[2, max_b - 1] = xi[2, max_b - 1] = 0
    psi[n - 1] = 0                          # the last node: no psi
    bp_psi, bp_xi = gf.bitplane_table(psi, l), gf.bitplane_table(xi, l)
    tables = torch.from_numpy(kernel.product_tables(bp_psi, bp_xi, l).view(np.int32)).to(dev)
    check_table_planes(tables, bp_psi, bp_xi, l, f"l={l} max_b={max_b}")
    return wire_in, src, slots, psi, xi, tables


def check_chain_tick(wire_in, src, slots, tables, l, t, chunks, lo, count, wire_rows,
                     errs, what) -> None:
    n, O, S = slots.shape[0], src.shape[0], wire_in.shape[-1]
    outs = []
    for fn in (kernel.chain_tick, ref.chain_tick_ref):
        out = torch.zeros((n, O, S * chunks), dtype=torch.int32, device=src.device)
        wire_out = torch.zeros((wire_rows, O, S), dtype=torch.int32, device=src.device)
        fn(wire_in, wire_out, src, slots, out, tables, l, t, chunks, lo, count)
        outs.append((out, wire_out))
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        check(torch.equal(got, want), f"chain_tick {what}")
        errs["chain_tick"] = max(errs["chain_tick"], max_abs_err(got, want))


def repair_case(rng, gen, l, rows, n, O, S, chunks, dev):
    """Operands of one repair tick: shards (n + 2, O, Bp) read through a row
    table that is not the identity; returns the bit-planes too."""
    wire_in = rand_i32(gen, (n, O, rows, S), dev)
    shards = rand_i32(gen, (n + 2, O, S * chunks), dev)
    shard_rows = rng.permutation(n + 2)[:n].astype(np.int32)
    if np.array_equal(shard_rows, np.arange(n)):
        shard_rows = shard_rows[::-1].copy()
    coeffs = rng.integers(1, 1 << l, size=(n, rows))
    planes = gf.bitplane_table(coeffs, l)
    tables = torch.from_numpy(kernel.repair_tables(planes, l).view(np.int32)).to(dev)
    got = ref.repair_table_planes(tables.cpu(), l, rows).numpy()
    check(np.array_equal(got, planes), f"repair tables' single-bit entries are the "
                                       f"bit-planes (l={l} rows={rows})")
    return wire_in, shards, shard_rows, tables, torch.from_numpy(planes.astype(np.int32)).to(dev)


def check_repair_tick(wire_in, shards, shard_rows, tables, l, chunks, errs, what,
                      ticks=((2, True), (4, False))) -> None:
    """The kernel == the plain version at each (tick, head_zero)."""
    n, O, rows, S = wire_in.shape
    for t, head_zero in ticks:
        lo, count = pipeline.active_nodes(t, n, chunks)
        outs = []
        for fn in (kernel.repair_tick, ref.repair_tick_ref):
            out = torch.zeros((O, rows, S * chunks), dtype=torch.int32, device=shards.device)
            wire_out = torch.zeros_like(wire_in)
            fn(wire_in, wire_out, shards, shard_rows, out, tables, l, t, chunks, lo, count,
               head_zero)
            outs.append((out, wire_out))
        torch.cuda.synchronize()
        for got, want in zip(*outs):
            check(torch.equal(got, want), f"repair_tick {what} t={t} head_zero={head_zero}")
            errs["repair_tick"] = max(errs["repair_tick"], max_abs_err(got, want))


def check_table_planes(tables: torch.Tensor, bp_psi, bp_xi, l: int, what: str) -> None:
    """The plain chain tick reads only the tables' single-bit entries, the
    bit-planes c * alpha^b: hold them against ``gf.bitplane_table`` of the
    coefficients, so the plain version does not rest on the table builder."""
    got_psi, got_xi = ref.table_planes(tables.cpu(), l)
    check(np.array_equal(got_psi.numpy(), bp_psi) and np.array_equal(got_xi.numpy(), bp_xi),
          f"product tables' single-bit entries are the coefficients' bit-planes ({what})")


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


def words_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact equality of two word tensors, compared as int32 (torch's CUDA
    build has no comparison kernels for uint16)."""
    return a.dtype == b.dtype and torch.equal(a.to(torch.int32), b.to(torch.int32))


def add_work(work: dict, name: str, launches: int, ms: float, plain_ms: float,
             nbytes: int, nops: int, int8_ops: int = 0) -> None:
    w = work[name]
    w["launches"] += launches
    w["ms"] += ms
    w["plain_ms"] += plain_ms
    w["bytes"] += nbytes
    w["ops"] += nops
    w["int8_ops"] += int8_ops


def report_work(name: str, w: dict, what: str) -> None:
    bytes_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = w["ops"] / INT32_OPS_PER_S * 1e3
    int8_ms = w["int8_ops"] / INT8_OPS_PER_S * 1e3
    print(f"{name} ({what}): {w['launches']} launches, {w['ms']:.3f} ms "
          f"(plain {w['plain_ms']:.3f} ms), bound {max(bytes_ms, ops_ms, int8_ms):.3f} ms "
          f"(bytes {bytes_ms:.3f}, int32 ops {ops_ms:.3f}, int8 ops {int8_ms:.3f})")


def chain_tick_work(code, Bp: int) -> tuple[int, int]:
    """(bytes, int32 ops) of one object's run of encode ticks: per node and
    lane the wire and each replica slot in, the codeword and, except for the
    last node (the encode's wire has n rows), the wire out; each slot with
    nonzero planes costs l masks (shift, and), an xi multiply + xor, and a
    psi multiply + xor where psi is nonzero."""
    valid = code.chain.block_valid
    psi_nz = code.chain.psi != 0
    nbytes = sum(2 + int(valid[i].sum()) + (i + 1 < code.n) for i in range(code.n)) * Bp * 4
    nops = sum(L * (4 + 2 * int(psi_nz[i, s]))
               for i in range(code.n) for s in range(code.chain.max_blocks)
               if valid[i, s]) * Bp
    return nbytes, nops


def repair_tick_work(h: int, rows: int, Bp: int, head_zero: bool) -> tuple[int, int]:
    """(bytes, int32 ops) of one run of repair ticks: per helper and lane,
    the shard lane and `rows` sums in, `rows` sums out, less the head
    node's sums in where the run says they are zero (``head_zero``: the
    kernel skips that read); l masks and rows * l multiply + xor."""
    units = h * (2 * rows + 1) - (rows if head_zero else 0)
    return units * Bp * 4, h * (2 * L + 2 * rows * L) * Bp


def check_repair_planes(tables: torch.Tensor, planes: np.ndarray, what: str) -> None:
    """The plain repair tick reads only the tables' single-bit entries: hold
    them against the bit-planes the tables were built from."""
    got = ref.repair_table_planes(tables.cpu(), L, planes.shape[1]).numpy()
    check(np.array_equal(got, planes),
          f"repair tables' single-bit entries are the bit-planes ({what})")


def encode_work(M: np.ndarray, O: int, Bp: int) -> tuple[int, int]:
    """(bytes, int32 ops) of one gf_encode launch: k lanes in and rows out per
    lane; the fewest operations the function needs with M's coefficients as
    constants: a mask per (input row, bit) that some row uses (an and, and a
    shift for bits above 0), a multiply per distinct (input row, bit, plane
    constant) other than 1 (rows that share a constant share the product,
    and m * 1 is m), and per row one 3-input xor per two of its terms."""
    planes = gf.bitplane_table(M, L)
    rows, k = M.shape
    used = np.any(planes != 0, axis=0)                     # (k, L)
    masks = 2 * int(used.sum()) - int(used[:, 0].sum())
    products = {(j, b, int(planes[r, j, b])) for r, j, b in zip(*np.nonzero(planes > 1))}
    terms = np.count_nonzero(planes, axis=(1, 2))          # per row
    xors = int(((terms + 1) // 2).sum())
    return O * (k + rows) * Bp * 4, O * Bp * (masks + len(products) + xors)


def mxu_work(M: np.ndarray, B: int, itemsize: int) -> tuple[int, int, int]:
    """(bytes, int32 ops, int8 ops) of one gf_encode_mxu launch: k words in and
    rows out per column; the unpack (shift, and per input bit) and the repack
    (and, shift, or per output bit) on the integer pipes, and the lifted
    (rows*l, k*l) int8 product, two operations per multiply-accumulate."""
    rows, k = M.shape
    return ((k + rows) * B * itemsize, B * (2 * k * L + 3 * rows * L),
            2 * rows * L * k * L * B)


def rand_words(rng: np.random.Generator, shape, l: int, dev) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 1 << l, size=shape).astype(gf.WORD_DTYPE[l])).to(dev)


def phase_static_kernels(dev, seed: int, errs: dict) -> None:
    """gf_encode and gf_encode_mxu against their plain versions, small shapes."""
    rng = np.random.default_rng(seed + 5)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    for l, (rows, k) in itertools.product((8, 16), ((5, 11), (16, 11), (3, 4))):
        M = rng.integers(0, 1 << l, size=(rows, k))
        M[0, 0] = 0                                   # a zero coefficient
        for O in (1, 3):
            x = rand_i32(gen, (O, k, 499), dev)       # a ragged lane count
            got = ops.encode_packed(M, x if O > 1 else x[0], l)
            want = ref.encode_packed_many_ref(M, x, l)
            torch.cuda.synchronize()
            check(torch.equal(got if O > 1 else got[None], want),
                  f"gf_encode l={l} ({rows},{k}) O={O}")
            errs["gf_encode"] = max(errs["gf_encode"],
                                    max_abs_err(got if O > 1 else got[None], want))
            for B in (998, 1000, 1002):
                xw = rand_words(rng, (O, k, B) if O > 1 else (k, B), l, dev)
                gotw = ops._encode_mxu_any(M, xw, l)
                wantw = (torch.stack([ref.bitlift_encode_ref(M, obj, l) for obj in xw])
                         if O > 1 else ref.bitlift_encode_ref(M, xw, l))
                torch.cuda.synchronize()
                check(words_equal(gotw, wantw), f"gf_encode_mxu l={l} ({rows},{k}) "
                                               f"O={O} B={B}")
                errs["gf_encode_mxu"] = max(errs["gf_encode_mxu"], max_abs_err(gotw, wantw))
        x = rand_i32(gen, (1, k, 499), dev)
        out = torch.empty((1, rows, 499), dtype=torch.int32, device=dev)
        enc_ms = median_ms(lambda: kernel.gf_encode(x, M, out, l), 20)
        xw = rand_words(rng, (k, 1002), l, dev)
        operand = torch.from_numpy(kernel.mxu_operand(M, l)).to(dev)
        outw = torch.empty((rows, 1002), dtype=xw.dtype, device=dev)
        mxu_ms = median_ms(lambda: kernel.gf_encode_mxu(xw, operand, outw, l), 20)
        print(f"gf_encode l={l:2d} ({rows:2d},{k:2d}) O=1,3 Bp=499: bit-exact, median "
              f"{enc_ms:.4f} ms; gf_encode_mxu B=998,1000,1002: bit-exact, median "
              f"{mxu_ms:.4f} ms at B=1002")
    # matrices past the limits of the PR 12 kernels: lifted past 256 x 256
    # bits (bit-lift), planes past 48 KB (bit-plane)
    for rows, k in PAST_CAPS_MXU:
        M = rng.integers(0, 1 << 16, size=(rows, k))
        for B in (998, 1000, 1002):
            xw = rand_words(rng, (k, B), 16, dev)
            gotw, wantw = ops.encode_mxu(M, xw, 16), ref.bitlift_encode_ref(M, xw, 16)
            torch.cuda.synchronize()
            check(words_equal(gotw, wantw), f"gf_encode_mxu past the old cap ({rows},{k}) B={B}")
            errs["gf_encode_mxu"] = max(errs["gf_encode_mxu"], max_abs_err(gotw, wantw))
    rows, k = PAST_CAPS_PACKED
    M = rng.integers(0, 1 << 16, size=(rows, k))
    for Bp in (499, 500):
        x = rand_i32(gen, (2, k, Bp), dev)
        got, want = ops.encode_packed(M, x, 16), ref.encode_packed_many_ref(M, x, 16)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"gf_encode past the old cap ({rows},{k}) Bp={Bp}")
        errs["gf_encode"] = max(errs["gf_encode"], max_abs_err(got, want))
    print(f"past the old caps: gf_encode_mxu {PAST_CAPS_MXU} at l=16, B=998,1000,1002, and "
          f"gf_encode {PAST_CAPS_PACKED} at l=16, O=2, Bp=499,500: bit-exact")


def ptxas_summary(log: str) -> list[str]:
    """'function: registers, spills' for each entry function in a -Xptxas -v log."""
    out, fn, spills = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
        elif "spill stores" in line:
            spills = line.split(":")[-1].strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}; {spills}")
            spills = ""
    return out


def print_compiles() -> None:
    """Each specialised gf_encode kernel built or loaded so far: its matrix,
    route, time and ptxas report."""
    for c in kernel.compile_log:
        took = (f"compiled in {c['compile_s']:.3f} s" if "compile_s" in c
                else "loaded from the disk cache")
        print(f"gf_encode kernel ({c['rows']},{c['k']}) l={c['l']} route={c['route']}: "
              f"{took}, first use {c['first_use_s']:.3f} s; "
              f"ptxas {' | '.join(ptxas_summary(c['log'])) or 'no report'}")


def first_call(name: str, fn, want_counts: dict):
    """Run an entry point once with the counters at 0; returns (result, ms)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernel.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts == want_counts, f"{name} launches {counts}, want {want_counts}")
    warm = wall_ms(fn)
    print(f"{name}: {ms:.3f} ms wall first call, {warm:.3f} ms median of 5 repeats, "
          f"launches {counts}, peak {peak / 2**30:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} GiB above the resident inputs)")
    return out


def window_starts(B: int, rng: np.random.Generator) -> list[int]:
    """Word offsets of 64-word, lane-aligned windows, some straddling chunks."""
    chunk = B // NUM_CHUNKS
    return [0, chunk - 32, 3 * chunk - 64, 5 * chunk - 2, B - 64,
            int(rng.integers(0, B // 2 - 64)) * 2]


def phase_slice(code, data_np, data_p, data, cw_p, lost, ids, shards, dev) -> dict:
    """Each entry point of the slice once at full size, checked; returns the
    inputs of its gf_encode and gf_encode_mxu launches for phase 7."""
    B = data_np.shape[1]
    ccode = classical.make_code(N, K, L)
    lost_t = torch.tensor(lost, device=dev)
    print(f"slice: classical ({N},{K}) Cauchy RS and the RapidRAID code over the "
          f"same object; repair of nodes {lost} from {len(ids)} survivors; "
          f"degraded read of blocks {READ_BLOCKS} over {READ_WORDS} words")

    ccw = first_call("classical_distributed_encode",
                     lambda: atomic.classical_distributed_encode(ccode, data),
                     only(gf_encode=1))
    ccw_p = gf.pack_u32(ccw, L)
    check(tuple(ccw.shape) == (N, B), f"classical codeword shape {tuple(ccw.shape)}")
    check(torch.equal(ccw_p[:K], data_p), "classical codeword: systematic rows == data")
    check(torch.equal(ccw_p[K:], gf.gf_matvec_packed(ccode.parity_matrix, data_p, L)),
          "classical parity == plain packed matvec on the card")
    starts = window_starts(B, np.random.default_rng(1))
    for s in starts:
        win = ccw_p[K:, s // 2:s // 2 + 32].cpu().numpy().view(np.uint16)
        want = classical.encode_np(ccode, data_np[:, s:s + 64])
        check(np.array_equal(win, want), f"classical parity window at word {s} vs host")

    loc = first_call("encode_local", lambda: atomic.encode_local(code, data_p),
                     only(gf_encode=1))
    check(torch.equal(loc, cw_p), "encode_local(G) == pipelined codeword")

    mx = first_call("encode_mxu", lambda: ops.encode_mxu(code.G, data, L),
                    only(gf_encode_mxu=1))
    check(torch.equal(gf.pack_u32(mx, L), cw_p), "encode_mxu(G) == pipelined codeword")

    helpers, R = fault_tolerance.repair_plan(code, lost, ids)
    ticks = pipeline.num_ticks(NUM_CHUNKS, len(helpers))
    rep = first_call("pipelined_repair",
                     lambda: repair.pipelined_repair(code, ids, shards, lost,
                                                     num_chunks=NUM_CHUNKS),
                     only(repair_tick=ticks))
    check(torch.equal(gf.pack_u32(rep, L), cw_p[lost_t]), "pipelined_repair == lost rows")
    star = first_call("star_repair", lambda: repair.star_repair(code, ids, shards, lost),
                      only(gf_encode=1))
    check(torch.equal(gf.pack_u32(star, L), cw_p[lost_t]), "star_repair == lost rows")

    w0 = (B // 2 - READ_WORDS // 2) // 2 * 2         # lane-aligned, mid-object
    lanes = slice(w0 // 2, (w0 + READ_WORDS) // 2)
    shards_p = gf.pack_u32(shards, L)
    slices = gf.unpack_u32(shards_p[:, lanes].contiguous(), L)
    read = first_call("degraded_read",
                      lambda: repair.degraded_read(code, ids, slices, READ_BLOCKS),
                      only(gf_encode=1))
    check(torch.equal(gf.pack_u32(read, L),
                      data_p[torch.tensor(READ_BLOCKS, device=dev)][:, lanes]),
          "degraded_read == the object's window")
    print(f"checks: classical parity == plain matvec and {len(starts)} host windows; "
          f"encode_local == encode_mxu == pipelined codeword; both repairs == rows "
          f"{lost}; degraded read == data[{READ_BLOCKS}, {w0}:{w0 + READ_WORDS}]")

    helper_lanes = shards_p[torch.tensor([ids.index(h) for h in helpers], device=dev)]
    D = code.decode_matrix(ids)[READ_BLOCKS]
    return {
        "gf_encode": [("classical parity", ccode.parity_matrix, data_p),
                      ("encode_local", code.G, data_p),
                      ("star_repair", R, helper_lanes),
                      ("degraded_read", D, shards_p[:, lanes].contiguous())],
        "gf_encode_mxu": [("encode_mxu", code.G, data)],
        "repair": (helpers, R, shards_p),
    }


def phase_replay(code, cw_p, lost, ids, launches: dict, work: dict, errs: dict,
                 dev) -> None:
    """The slice's launches of each new kernel, and its repair ticks, through
    the kernel and through its plain version: checked equal and timed."""
    for what, M, x in launches["gf_encode"]:
        x3 = x[None]
        rows, Bp = M.shape[0], x.shape[-1]
        out = torch.empty((1, rows, Bp), dtype=torch.int32, device=dev)
        ms = median_ms(lambda: kernel.gf_encode(x3, M, out, L), 5)
        plain = {}
        plain_ms = median_ms(lambda: plain.update(y=ref.encode_packed_many_ref(M, x3, L)), 3)
        check(torch.equal(out, plain["y"]), f"gf_encode == plain version ({what})")
        errs["gf_encode"] = max(errs["gf_encode"], max_abs_err(out, plain["y"]))
        add_work(work, "gf_encode", 1, ms, plain_ms, *encode_work(M, 1, Bp))
        print(f"gf_encode replay ({what}, {rows}x{x.shape[0]}, Bp={Bp}): {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms")

    for what, M, xw in launches["gf_encode_mxu"]:
        rows, B = M.shape[0], xw.shape[-1]
        operand = torch.from_numpy(kernel.mxu_operand(M, L)).to(dev)
        out = torch.empty((rows, B), dtype=xw.dtype, device=dev)
        ms = median_ms(lambda: kernel.gf_encode_mxu(xw, operand, out, L), 5)
        plain = {}
        plain_ms = median_ms(lambda: plain.update(y=ref.bitlift_encode_ref(M, xw, L)), 3)
        check(words_equal(out, plain["y"]), f"gf_encode_mxu == plain version ({what})")
        check(torch.equal(gf.pack_u32(out, L), cw_p), "replayed bit-lift codeword")
        errs["gf_encode_mxu"] = max(errs["gf_encode_mxu"], max_abs_err(out, plain["y"]))
        add_work(work, "gf_encode_mxu", 1, ms, plain_ms, *mxu_work(M, B, xw.element_size()))
        print(f"gf_encode_mxu replay ({what}, {rows}x{xw.shape[0]}, B={B}): {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms")

    helpers, R, shards_p = launches["repair"]
    h, Bp = len(helpers), shards_p.shape[-1]
    rows, S = R.shape[0], Bp // NUM_CHUNKS
    shard_rows, tables = repair.repair_operands(code, lost, ids, dev)
    order = pipeline.position_nodes(h, reverse=True)
    check_repair_planes(tables, chain.column_bitplanes(R, L)[order], "repair plan")
    check(list(shard_rows) == [ids.index(helpers[p]) for p in order],
          "repair row table: each chain position's helper")
    packed = shards_p[:, None]                   # the survivors' shards, read in place
    outs, timings = {}, {}

    def rep_tick(tick, wi, wo, t, lo, count):
        tick(wi, wo, packed, shard_rows, outs[tick], tables, L, t, NUM_CHUNKS, lo, count,
             True)

    for tick, reps in ((kernel.repair_tick, 5), (ref.repair_tick_ref, 3)):
        outs[tick] = torch.empty((1, rows, Bp), dtype=torch.int32, device=dev)
        timings[tick] = median_ms(replay(h, tick, (h, 1, rows, S), dev, rep_tick), reps)
    check(torch.equal(outs[kernel.repair_tick], outs[ref.repair_tick_ref]),
          "repair_tick == plain version over the repair's ticks")
    check(torch.equal(outs[kernel.repair_tick][0], cw_p[torch.tensor(lost, device=dev)]),
          "replayed repair")
    errs["repair_tick"] = max(errs["repair_tick"], max_abs_err(
        outs[kernel.repair_tick], outs[ref.repair_tick_ref]))
    repair_w = {"launches": pipeline.num_ticks(NUM_CHUNKS, h), "ms": timings[kernel.repair_tick],
                "plain_ms": timings[ref.repair_tick_ref], "int8_ops": 0}
    repair_w["bytes"], repair_w["ops"] = repair_tick_work(h, rows, Bp, head_zero=True)
    report_work("repair_tick", repair_w, "pipelined_repair, head row's read skipped")
    add_work(work, "repair_tick", repair_w["launches"], repair_w["ms"],
             repair_w["plain_ms"], repair_w["bytes"], repair_w["ops"])


# ---------------------------------------------------------------------------
# phases 8-10: staggered multi-object paths, their ticks, the code families
# ---------------------------------------------------------------------------


def many_paths(code, lost, ids, objects_p, shards_p, dev) -> dict:
    """The three staggered paths' tick operands, each read in place from the
    (B_obj, rows, Bp) batches: name -> chain length, wire slot shape, output
    rows, the kernel and its plain version, and ``tick(fn, out, stagger)``,
    the step of ``pipeline.staggered_pipeline`` through ``fn``."""
    Bp = (objects_p if objects_p is not None else shards_p).shape[-1]
    S = Bp // NUM_CHUNKS
    paths = {}
    if objects_p is not None:
        src, slots, tables = chain.encode_operands(code, objects_p)

        def enc(fn, out, stagger):
            return lambda wi, wo, t, lo, count: fn(wi, wo, src, slots, out.transpose(0, 1),
                                                   tables, L, t, NUM_CHUNKS, lo, count, stagger)
        paths["encode"] = dict(n=N, slot=(S,), rows=N, Bp=Bp, tick=enc,
                               fns=(kernel.chain_tick, ref.chain_tick_ref))
    if shards_p is not None:
        packed = shards_p.transpose(0, 1)             # (len(ids), B_obj, Bp), a view
        dec_tables = chain.decode_operands(code, ids, dev)
        dec_rows = np.arange(len(ids), dtype=np.int32)
        rep_rows, rep_tables = repair.repair_operands(code, lost, ids, dev)

        def dec(fn, out, stagger):
            return lambda wi, wo, t, lo, count: fn(wi, wo, packed, dec_rows, out, dec_tables, L,
                                                   t, NUM_CHUNKS, lo, count, True, stagger)

        def rep(fn, out, stagger):
            return lambda wi, wo, t, lo, count: fn(wi, wo, packed, rep_rows, out, rep_tables, L,
                                                   t, NUM_CHUNKS, lo, count, True, stagger)
        fns = (kernel.repair_tick, ref.repair_tick_ref)
        paths["decode"] = dict(n=len(ids), slot=(K, S), rows=K, Bp=Bp, tick=dec, fns=fns)
        paths["repair"] = dict(n=len(rep_rows), slot=(len(lost), S), rows=len(lost), Bp=Bp,
                               tick=rep, fns=fns)
    return paths


def staggered_run(path: dict, fn, n_obj: int, stagger: int, dev, out=None):
    """A fresh staggered run of ``path``'s ticks through ``fn`` (one launch a
    tick); returns (run, out)."""
    if out is None:
        out = torch.empty((n_obj, path["rows"], path["Bp"]), dtype=torch.int32, device=dev)
    W = pipeline.window_size(NUM_CHUNKS, n_obj, stagger)
    wires = [torch.zeros((path["n"], W) + path["slot"], dtype=torch.int32, device=dev)
             for _ in range(2)]
    tick = path["tick"](fn, out, stagger)

    def run():
        for t in range(pipeline.num_ticks_many(NUM_CHUNKS, path["n"], n_obj, stagger)):
            lo, count = pipeline.active_nodes_many(t, path["n"], NUM_CHUNKS, n_obj, stagger)
            tick(wires[(t + 1) % 2], wires[t % 2], t, lo, count)
    return run, out


def compare_ticks(path: dict, n_obj: int, stagger: int, dev, errs: dict, key: str,
                  what: str) -> torch.Tensor:
    """One staggered run through the kernel and through its plain version in
    turns, tick by tick: every tick's outgoing wire and the output are held
    equal. Returns the kernel's output."""
    routes = []
    for fn in path["fns"]:
        out = torch.zeros((n_obj, path["rows"], path["Bp"]), dtype=torch.int32, device=dev)
        W = pipeline.window_size(NUM_CHUNKS, n_obj, stagger)
        wires = [torch.zeros((path["n"], W) + path["slot"], dtype=torch.int32, device=dev)
                 for _ in range(2)]
        routes.append((out, wires, path["tick"](fn, out, stagger)))
    for t in range(pipeline.num_ticks_many(NUM_CHUNKS, path["n"], n_obj, stagger)):
        lo, count = pipeline.active_nodes_many(t, path["n"], NUM_CHUNKS, n_obj, stagger)
        for _, wires, tick in routes:
            tick(wires[(t + 1) % 2], wires[t % 2], t, lo, count)
        torch.cuda.synchronize()
        got, want = (wires[t % 2] for _, wires, _ in routes)
        check(torch.equal(got, want), f"{key} == plain version at tick {t} ({what})")
        errs[key] = max(errs[key], max_abs_err(got, want))
    check(torch.equal(routes[0][0], routes[1][0]), f"{key} == plain version, output ({what})")
    return routes[0][0]


def first_and_median(fn, check_fn=None) -> tuple[float, float]:
    """(first-call ms, median of 5 repeats in ms) of ``fn`` on the host clock,
    each synchronized; ``check_fn`` holds the first call's result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    if check_fn is not None:
        check_fn(out)
    del out
    return first, wall_ms(fn)


def phase_many(code, lost, ids, dev, seed: int, work: dict, errs: dict) -> None:
    """Phase 8: the staggered entry points at Fig. 4's concurrency and the
    paper's object size, checked, counted, timed against the loop."""
    n_obj, B = MANY_OBJECTS, MANY_BLOCK_WORDS
    Bp = B // 2
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    objects_p = torch.empty((n_obj, K, Bp), dtype=torch.int32, device=dev)
    for o in range(n_obj):                        # made on the card, one object at a time
        objects_p[o] = rand_i32(gen, (K, Bp), dev)
    objects = gf.unpack_u32(objects_p, L)         # (B_obj, k, B) words, a view
    lost_t, ids_t = (torch.tensor(x, device=dev) for x in (lost, ids))
    rng = np.random.default_rng(seed + 8)
    starts = window_starts(B, rng)
    print(f"multi-object: {n_obj} objects of {K * B * 2} bytes ({K * B * 2 / 2**20:.0f} MiB), "
          f"({N},{K}) GF(2^{L}), {NUM_CHUNKS} chunks, stagger 1 (and {MANY_STAGGERS} timed), "
          f"lost nodes {lost}; {n_obj * K * B * 2 / 2**30:.2f} GiB of objects resident")

    # -- encode ---------------------------------------------------------------
    enc_ticks = pipeline.num_ticks_many(NUM_CHUNKS, N, n_obj, 1)
    cw = first_call("pipelined_encode_many (stagger 1)",
                    lambda: multi.pipelined_encode_many(code, objects, NUM_CHUNKS, 1),
                    only(chain_tick=enc_ticks))
    cw_p = gf.pack_u32(cw, L)
    check(tuple(cw.shape) == (n_obj, N, B), f"codewords {tuple(cw.shape)}")
    for o in range(n_obj):
        check(torch.equal(cw_p[o], gf.gf_matvec_packed(code.G, objects_p[o], L)),
              f"object {o}'s codeword == plain packed matvec on the card")
    for o in (0, n_obj // 2, n_obj - 1):
        for w in starts:
            win = cw_p[o, :, w // 2:w // 2 + 32].cpu().numpy().view(np.uint16)
            obj = objects_p[o, :, w // 2:w // 2 + 32].cpu().numpy().view(np.uint16)
            check(np.array_equal(win, gf.gf_matmul_np(code.G, obj, L)),
                  f"object {o}'s codeword window at word {w} vs host field")
    print(f"checks: {n_obj} codewords == plain packed matvec; {3 * len(starts)} windows of "
          f"objects 0, {n_obj // 2}, {n_obj - 1} == host gf_matmul_np")
    many_timings("pipelined_encode_many",
                 lambda st: multi.pipelined_encode_many(code, objects, NUM_CHUNKS, st),
                 cw_p, N, n_obj,
                 lambda: [chain.pipelined_encode(code, objects[o], NUM_CHUNKS)
                          for o in range(n_obj)])
    path = many_paths(code, lost, ids, objects_p, None, dev)["encode"]
    run, out = staggered_run(path, kernel.chain_tick, n_obj, 1, dev)
    ms = median_ms(run, 3)
    check(torch.equal(out, cw_p.view(n_obj, N, Bp)), "replayed staggered encode")
    del run, out
    torch.cuda.empty_cache()
    run, out = staggered_run(path, ref.chain_tick_ref, n_obj, 1, dev)
    plain_ms = median_ms(run, 1)
    check(torch.equal(out, cw_p.view(n_obj, N, Bp)), "plain replay of the staggered encode")
    errs["chain_tick[many]"] = max(errs["chain_tick[many]"], max_abs_err(out, cw_p))
    del run, out, path
    nbytes, nops = chain_tick_work(code, Bp)
    add_work(work, "chain_tick[many]", enc_ticks, ms, plain_ms, n_obj * nbytes, n_obj * nops)
    report_work("chain_tick[many]", work["chain_tick[many]"], f"{n_obj} objects, stagger 1")

    # survivors and lost rows of every object; the codewords go
    shards_p = cw_p[:, ids_t]                     # (B_obj, 11, Bp): a copy
    lost_p = cw_p[:, lost_t]
    shards = gf.unpack_u32(shards_p, L)
    del cw, cw_p
    torch.cuda.empty_cache()
    paths = many_paths(code, lost, ids, None, shards_p, dev)

    # -- repair (before the decode: its wires are the smaller) -----------------
    h = paths["repair"]["n"]
    rep_ticks = pipeline.num_ticks_many(NUM_CHUNKS, h, n_obj, 1)
    rep = first_call("pipelined_repair_many (stagger 1)",
                     lambda: repair.pipelined_repair_many(code, ids, shards, lost, NUM_CHUNKS, 1),
                     only(repair_tick=rep_ticks))
    check(torch.equal(gf.pack_u32(rep, L), lost_p), "repaired rows == lost rows")
    del rep
    many_timings("pipelined_repair_many",
                 lambda st: repair.pipelined_repair_many(code, ids, shards, lost, NUM_CHUNKS, st),
                 lost_p, h, n_obj,
                 lambda: [repair.pipelined_repair(code, ids, shards[o], lost, NUM_CHUNKS)
                          for o in range(n_obj)])
    rep_ms, rep_plain_ms = replay_many(paths["repair"], n_obj, lost_p, errs, dev)
    del lost_p
    torch.cuda.empty_cache()

    # -- decode ---------------------------------------------------------------
    dec_ticks = pipeline.num_ticks_many(NUM_CHUNKS, len(ids), n_obj, 1)
    dec = first_call("pipelined_decode_many (stagger 1)",
                     lambda: multi.pipelined_decode_many(code, ids, shards, NUM_CHUNKS, 1),
                     only(repair_tick=dec_ticks))
    check(torch.equal(gf.pack_u32(dec, L), objects_p), "decoded objects == data")
    del dec
    many_timings("pipelined_decode_many",
                 lambda st: multi.pipelined_decode_many(code, ids, shards, NUM_CHUNKS, st),
                 objects_p, len(ids), n_obj,
                 lambda: [chain.pipelined_decode(code, ids, shards[o], NUM_CHUNKS)
                          for o in range(n_obj)])
    dec_ms, dec_plain_ms = replay_many(paths["decode"], n_obj, objects_p, errs, dev)
    dec_b, dec_o = repair_tick_work(len(ids), K, Bp, head_zero=True)
    rep_b, rep_o = repair_tick_work(h, len(lost), Bp, head_zero=True)
    add_work(work, "repair_tick[many]", dec_ticks + rep_ticks, dec_ms + rep_ms,
             dec_plain_ms + rep_plain_ms, n_obj * (dec_b + rep_b), n_obj * (dec_o + rep_o))
    print(f"repair_tick[many]: decode {dec_ms:.3f} ms (plain {dec_plain_ms:.3f}), repair "
          f"{rep_ms:.3f} ms (plain {rep_plain_ms:.3f}); bounds decode "
          f"{n_obj * dec_b / HBM_BYTES_PER_S * 1e3:.3f} ms, repair "
          f"{n_obj * rep_b / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes)")
    report_work("repair_tick[many]", work["repair_tick[many]"],
                f"{n_obj} objects, stagger 1, decode + repair")
    del paths, shards, shards_p, objects, objects_p
    torch.cuda.empty_cache()


def many_timings(name: str, call, want: torch.Tensor, n: int, n_obj: int, loop) -> None:
    """First call and median of 5 of a staggered entry point at each of
    ``MANY_STAGGERS`` past the first (``first_call`` timed stagger 1; each
    result held against ``want``), and of the loop of single-object calls
    beside them."""
    for stagger in MANY_STAGGERS[1:]:
        first, med = first_and_median(
            lambda: call(stagger),
            lambda got: check(torch.equal(gf.pack_u32(got, L), want),
                              f"{name} at stagger {stagger}"))
        print(f"{name} stagger={stagger}: {first:.3f} ms first call, {med:.3f} ms median of 5 "
              f"({pipeline.num_ticks_many(NUM_CHUNKS, n, n_obj, stagger)} launches)")
    first, med = first_and_median(
        loop, lambda got: check(all(torch.equal(gf.pack_u32(g, L), want[o])
                                    for o, g in enumerate(got)), f"{name}: the loop's results"))
    print(f"loop of {n_obj} single-object calls beside {name}: {first:.3f} ms first call, "
          f"{med:.3f} ms median of 5 ({n_obj * pipeline.num_ticks(NUM_CHUNKS, n)} launches)")


def replay_many(path: dict, n_obj: int, want: torch.Tensor, errs: dict,
                dev) -> tuple[float, float]:
    """The staggered run's ticks through the kernel and, after it, through the
    plain version, each held against ``want``; returns (ms, plain ms)."""
    times = []
    for fn, reps in zip(path["fns"], (3, 1)):
        torch.cuda.empty_cache()
        run, out = staggered_run(path, fn, n_obj, 1, dev)
        times.append(median_ms(run, reps))
        check(torch.equal(out, want), f"replayed staggered {fn.__name__}")
        errs["repair_tick[many]"] = max(errs["repair_tick[many]"], max_abs_err(out, want))
        del run, out
    return times[0], times[1]


def phase_many_ticks(code, lost, ids, dev, seed: int, errs: dict) -> None:
    """Phase 9: the staggered ticks against their plain versions tick by tick
    at two shapes and four staggers; both routes timed, and the batch
    against the loop at the launch-bound shape."""
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    ids_t = torch.tensor(ids, device=dev)
    for n_obj, B in TICK_SHAPES:
        Bp = B // 2
        objects_p = rand_i32(gen, (n_obj, K, Bp), dev)
        enc = many_paths(code, lost, ids, objects_p, None, dev)["encode"]
        for stagger in TICK_STAGGERS:
            cw_p = compare_ticks(enc, n_obj, stagger, dev, errs, "chain_tick[many]",
                                 f"{n_obj} objects of {B} words, stagger {stagger}")
            if stagger == TICK_STAGGERS[0]:
                want_cw = cw_p
            check(torch.equal(cw_p, want_cw), f"codewords at stagger {stagger}")
        shards_p = want_cw[:, ids_t]
        lost_p = want_cw[:, torch.tensor(lost, device=dev)]
        paths = many_paths(code, lost, ids, None, shards_p, dev)
        for name, want in (("decode", objects_p), ("repair", lost_p)):
            for stagger in TICK_STAGGERS:
                got = compare_ticks(paths[name], n_obj, stagger, dev, errs, "repair_tick[many]",
                                    f"{name}, {n_obj} objects of {B} words, stagger {stagger}")
                check(torch.equal(got, want), f"staggered {name} at stagger {stagger}")
        print(f"staggered ticks, {n_obj} objects of {B} words, staggers {TICK_STAGGERS}: "
              f"kernel == plain version at every tick of encode, decode and repair")
        for name, path in (("encode", enc), ("decode", paths["decode"]),
                           ("repair", paths["repair"])):
            times = [median_ms(staggered_run(path, fn, n_obj, 1, dev)[0], reps)
                     for fn, reps in zip(path["fns"], (5, 2))]
            print(f"staggered {name} ticks, {n_obj} objects of {B} words, stagger 1 "
                  f"({pipeline.num_ticks_many(NUM_CHUNKS, path['n'], n_obj, 1)} launches): "
                  f"kernel {times[0]:.3f} ms, plain {times[1]:.3f} ms")
        if n_obj == TICK_SHAPES[-1][0]:
            objects, shards = gf.unpack_u32(objects_p, L), gf.unpack_u32(shards_p, L)
            for name, batch, loop in (
                    ("encode", lambda: multi.pipelined_encode_many(code, objects, NUM_CHUNKS, 1),
                     lambda: [chain.pipelined_encode(code, objects[o], NUM_CHUNKS)
                              for o in range(n_obj)]),
                    ("decode", lambda: multi.pipelined_decode_many(code, ids, shards, NUM_CHUNKS, 1),
                     lambda: [chain.pipelined_decode(code, ids, shards[o], NUM_CHUNKS)
                              for o in range(n_obj)]),
                    ("repair", lambda: repair.pipelined_repair_many(code, ids, shards, lost,
                                                                    NUM_CHUNKS, 1),
                     lambda: [repair.pipelined_repair(code, ids, shards[o], lost, NUM_CHUNKS)
                              for o in range(n_obj)])):
                b_first, b_med = first_and_median(batch)
                l_first, l_med = first_and_median(loop)
                print(f"{name}, {n_obj} objects of {B} words: staggered batch {b_first:.3f} ms "
                      f"first call, {b_med:.3f} ms median of 5; loop of {n_obj} single-object "
                      f"calls {l_first:.3f} ms first call, {l_med:.3f} ms median of 5")
        del objects_p, enc, paths, shards_p, lost_p, want_cw, cw_p
        torch.cuda.empty_cache()


def phase_families(dev, seed: int) -> None:
    """Phase 10: the LRC and MBR codes through the static encode, and an LRC
    block repaired through its local group, checked against the host."""
    rng = np.random.default_rng(seed + 10)
    for family, n, k, l in FAMILY_CODES:
        code = codes.make(family, n, k, l=l, seed=seed)
        B = 4000
        data = rng.integers(0, 1 << l, size=(k, B)).astype(gf.WORD_DTYPE[l])
        msg = torch.from_numpy(np.ascontiguousarray(code.to_message(data))).to(dev)
        kernel.reset_launch_counts()
        out = atomic.encode_local(code, gf.pack_u32(msg, l))
        torch.cuda.synchronize()
        check(kernel.launch_counts() == only(gf_encode=1), f"{family} encode_local launches")
        got = gf.unpack_u32(out, l).reshape(n, -1).cpu().numpy()
        check(np.array_equal(got, code.encode_np(data)), f"{family} encode_local == encode_np")
        print(f"{family} ({n},{k}) GF(2^{l}): encode_local of its {code.G.shape} generator "
              f"over {B} words (shards of {code.shard_words(B)}) == encode_np")
        if family != "lrc":
            continue
        cw = code.encode_np(data)
        lost = [4]
        ids = [i for i in range(n) if i not in lost]
        helpers = code.repair_helpers(lost, ids)
        want = code.repair_np(lost, ids, cw[ids])
        check(np.array_equal(want, cw[lost]), "lrc repair_np == lost row")
        kernel.reset_launch_counts()
        rep = repair.pipelined_repair(code, ids, cw[ids], lost, NUM_CHUNKS)
        torch.cuda.synchronize()
        check(kernel.launch_counts() == only(repair_tick=pipeline.num_ticks(NUM_CHUNKS,
                                                                             len(helpers))),
              "lrc pipelined_repair launches: a chain of its local group")
        check(np.array_equal(rep.cpu().numpy(), want), "lrc pipelined_repair == repair_np")
        star = repair.star_repair(code, ids, cw[ids], lost)
        check(np.array_equal(star.cpu().numpy(), want), "lrc star_repair == repair_np")
        print(f"lrc: block {lost[0]} repaired from its local group {helpers} "
              f"(locality {code.locality}) by pipelined_repair "
              f"({pipeline.num_ticks(NUM_CHUNKS, len(helpers))} repair_tick launches) and "
              f"star_repair == repair_np")


# ---------------------------------------------------------------------------
# phases 11-12: streaming, the archive
# ---------------------------------------------------------------------------


class KernelTimer:
    """Device time of what an entry point runs on the card while ``active``:
    CUDA events around each tick launch, ``encode_packed`` call and graph
    replay (each span also holds any wait of the card for the launch), and
    the host seconds spent staging stripes into pinned memory. (The
    static kernels' spans are ``encode_packed`` and ``encode_mxu`` calls.)
    Nothing is
    recorded while a graph is being captured."""

    def __init__(self):
        self.spans: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.stage_s = 0.0

    def _timed(self, fn):
        def run(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.spans.append((start, end))
            return out
        return run

    def _staged(self, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            self.stage_s += time.perf_counter() - t0
        return run

    @contextlib.contextmanager
    def active(self):
        saved = {name: getattr(ops, name)
                 for name in ("chain_tick", "repair_tick", "encode_packed", "encode_mxu")}
        replay, stage = kernel.Graph.replay, streaming._Stripes._stage
        try:
            for name, fn in saved.items():
                setattr(ops, name, self._timed(fn))
            kernel.Graph.replay = self._timed(replay)
            streaming._Stripes._stage = self._staged(stage)
            yield self
        finally:
            for name, fn in saved.items():
                setattr(ops, name, fn)
            kernel.Graph.replay, streaming._Stripes._stage = replay, stage

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in self.spans)


class RowHasher:
    """A streaming sink: one incremental sha256 per output row, the rows of
    each stripe hashed in parallel (hashlib releases the interpreter lock);
    stripes must arrive in order. ``host_s`` is the time spent in it."""

    def __init__(self, pool: concurrent.futures.Executor, rows: int):
        self.pool, self.next, self.host_s = pool, 0, 0.0
        self.sha = [hashlib.sha256() for _ in range(rows)]

    def __call__(self, s: int, out: np.ndarray) -> None:
        check(s == self.next, f"stripe {s} retired out of order (want {self.next})")
        self.next += 1
        t0 = time.perf_counter()
        list(self.pool.map(lambda r: self.sha[r].update(out[r]), range(len(self.sha))))
        self.host_s += time.perf_counter() - t0

    def digests(self) -> list[str]:
        return [h.hexdigest() for h in self.sha]


def host_digests(pool, rows) -> list[str]:
    """sha256 of each host row (numpy), in parallel."""
    return list(pool.map(lambda r: hashlib.sha256(r).hexdigest(), rows))


def card_digests(pool, words: torch.Tensor) -> list[str]:
    """sha256 of each row of (rows, B) words on the card, each row copied to
    the host through its int32 lanes."""
    lanes = gf.pack_u32(words, L)
    futs = [pool.submit(lambda a: hashlib.sha256(a).hexdigest(), lanes[r].cpu().numpy())
            for r in range(lanes.shape[0])]
    return [f.result() for f in futs]


def copy_rates(dev) -> tuple[float, float]:
    """(h2d, d2h) bytes/s of a pinned ``COPY_RATE_BYTES`` buffer, medians of 5."""
    host = torch.empty(COPY_RATE_BYTES // 4, dtype=torch.int32, pin_memory=True)
    card = torch.empty_like(host, device=dev)
    h2d = median_ms(lambda: card.copy_(host, non_blocking=True), 5)
    d2h = median_ms(lambda: host.copy_(card, non_blocking=True), 5)
    return COPY_RATE_BYTES / h2d * 1e3, COPY_RATE_BYTES / d2h * 1e3


def phase_streaming(code, lost, ids, data_np, cw704_digests, dev, seed: int, pool) -> None:
    """Phase 11: encode, decode and repair of a 5.5 GiB host object streamed
    through a 1 GiB device budget, each digest against the monolithic call on
    the card; the stripe footprint; the 704 MiB object at two more widths."""
    nc, B, h = NUM_CHUNKS, STREAM_BLOCK_WORDS, len(ids)
    sc = streaming.superchunk_words_for(STREAM_BUDGET, code, nc)
    check(sc == 1 << 21, f"superchunk_words_for(1 GiB) = {sc}, the JAX package's 2^21")
    plan = streaming.plan_stream(B, sc, l=L, num_chunks=nc)
    S = plan.num_superchunks
    h2d_rate, d2h_rate = copy_rates(dev)
    print(f"streaming: object of {K} blocks of {B} words ({K * B * 2 / 2**30:.1f} GiB) in pinned "
          f"host memory, budget {STREAM_BUDGET / 2**30:.0f} GiB -> {sc} words a stripe "
          f"(modeled {streaming.estimate_stripe_bytes(code, sc) / 2**20:.1f} MiB), {S} stripes; "
          f"pinned copies of {COPY_RATE_BYTES >> 20} MiB: h2d {h2d_rate / 1e9:.2f} GB/s, "
          f"d2h {d2h_rate / 1e9:.2f} GB/s ({smi('name,power.limit')})")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    t0 = time.perf_counter()
    obj_host = torch.empty((K, B // 2), dtype=torch.int32, pin_memory=True)
    for j in range(K):                            # made on the card a block at a time
        obj_host[j].copy_(rand_i32(gen, (B // 2,), dev))
    obj_digests = host_digests(pool, obj_host.numpy())
    made_s = time.perf_counter() - t0

    # the monolithic calls on the card: the digests the streams must give
    data = obj_host.to(dev)
    cw_p = gf.pack_u32(chain.pipelined_encode(code, gf.unpack_u32(data, L), nc), L)
    del data
    enc_digests = card_digests(pool, gf.unpack_u32(cw_p, L))
    lost_digests = [enc_digests[i] for i in lost]
    shards_host = torch.empty((h, B // 2), dtype=torch.int32, pin_memory=True)
    for r, i in enumerate(ids):
        shards_host[r].copy_(cw_p[i])
    shards = gf.unpack_u32(cw_p[torch.tensor(ids, device=dev)], L)
    del cw_p
    torch.cuda.empty_cache()
    check(card_digests(pool, chain.pipelined_decode(code, ids, shards, nc)) == obj_digests,
          "monolithic decode on the card == the object")
    check(card_digests(pool, repair.pipelined_repair(code, ids, shards, lost, nc)) == lost_digests,
          "monolithic repair on the card == the lost rows")
    del shards
    torch.cuda.empty_cache()
    print(f"streaming: object made and hashed in {made_s:.1f} s; monolithic encode, decode and "
          f"repair on the card hashed row by row")

    obj_words, shard_words = obj_host.view(torch.uint16), shards_host.view(torch.uint16)
    helpers, _ = fault_tolerance.repair_plan(code, lost, ids)
    runs = (
        ("pipelined_encode", lambda sink: chain.pipelined_encode(
            code, obj_words, nc, superchunk_words=sc, sink=sink), K, N, enc_digests,
         "chain_tick", pipeline.num_ticks(nc, N)),
        ("pipelined_decode", lambda sink: chain.pipelined_decode(
            code, ids, shard_words, nc, superchunk_words=sc, sink=sink), h, K, obj_digests,
         "repair_tick", pipeline.num_ticks(nc, h)),
        ("pipelined_repair", lambda sink: repair.pipelined_repair(
            code, ids, shard_words, lost, nc, superchunk_words=sc, sink=sink), h, len(lost),
         lost_digests, "repair_tick", pipeline.num_ticks(nc, len(helpers))),
    )
    for name, run, rows_in, rows_out, want, kern, ticks in runs:
        misses = jitcache.stats()["misses"]
        sink = RowHasher(pool, rows_out)
        torch.cuda.synchronize()
        kernel.reset_launch_counts()
        t0 = time.perf_counter()
        check(run(sink) is None, f"streamed {name} with a sink returns None")
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = kernel.launch_counts()
        check(counts == only(**{kern: (S + 1) * ticks}),
              f"streamed {name} launches {counts}, want {S} stripes + 1 warm-up x {ticks}")
        check(jitcache.stats()["misses"] == misses + 1, f"streamed {name} builds one program")
        check(sink.digests() == want, f"streamed {name} == the monolithic call on the card")
        sink, timer = RowHasher(pool, rows_out), KernelTimer()
        kernel.reset_launch_counts()
        with timer.active():
            t0 = time.perf_counter()
            run(sink)
            torch.cuda.synchronize()
            wall_ms_ = (time.perf_counter() - t0) * 1e3
        ticks_ms = timer.ms()
        check(jitcache.stats()["misses"] == misses + 1, f"the second streamed {name} builds nothing")
        check(kernel.launch_counts() == only(**{kern: S * ticks}), f"warm streamed {name} launches")
        check(sink.digests() == want, f"second streamed {name} == the monolithic call")
        in_ms = rows_in * B * 2 / h2d_rate * 1e3
        out_ms = rows_out * B * 2 / d2h_rate * 1e3
        bound = max(in_ms, out_ms, ticks_ms)
        print(f"streamed {name}: {S} stripes, {S * ticks} {kern} launches in {S} graph replays; "
              f"first call {first_ms:.1f} ms (builds, warms, captures), warm {wall_ms_:.1f} ms "
              f"wall ({rows_in * B * 2 / wall_ms_ / 1e6:.2f} GB/s of input); ticks {ticks_ms:.1f} "
              f"ms, copies in {in_ms:.1f} / out {out_ms:.1f} ms at the measured rates; bound "
              f"{bound:.1f} ms ({100 * bound / wall_ms_:.0f}% of the wall); overlap "
              f"{(in_ms + out_ms + ticks_ms) / wall_ms_:.2f} (serial sum / wall); host staging "
              f"{timer.stage_s * 1e3:.1f} ms, sink hashing {sink.host_s * 1e3:.1f} ms; digests "
              f"== the monolithic call ({smi('name,power.limit')})")

    # the stripe's device footprint, from programs not yet built
    jitcache.clear()
    torch.cuda.empty_cache()
    def drop(s, out):
        pass

    feet = {
        "encode": streaming.measure_footprint(lambda: streaming.execute(
            streaming.plan_stream(sc, None, l=L, num_chunks=nc),
            chain.encode_program(code, sc, nc), lambda s: obj_words[:, :sc], drop)),
        "decode": streaming.measure_footprint(lambda: chain.pipelined_decode(
            code, ids, shard_words[:, :2 * sc], nc, superchunk_words=sc, sink=drop)),
        "repair": streaming.measure_footprint(lambda: repair.pipelined_repair(
            code, ids, shard_words[:, :2 * sc], lost, nc, superchunk_words=sc, sink=drop)),
    }
    for name, foot in feet.items():
        check(foot is not None and foot <= STREAM_BUDGET,
              f"streamed {name}'s stripe footprint {foot} within {STREAM_BUDGET}")
    print("streaming footprint above what was allocated before, program built in the "
          "measurement: " + ", ".join(f"{name} {foot / 2**20:.1f} MiB" for name, foot in
                                      feet.items()) + f" (budget {STREAM_BUDGET >> 20} MiB)")
    del obj_host, shards_host, obj_words, shard_words
    jitcache.clear()
    torch.cuda.empty_cache()

    # phase 3's object at two more stripe widths
    for width in STREAM_WIDTHS:
        sink = RowHasher(pool, N)
        t0 = time.perf_counter()
        chain.pipelined_encode(code, data_np, nc, superchunk_words=width, sink=sink)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(sink.digests() == cw704_digests, f"704 MiB streamed at {width} words == phase 3")
        print(f"704 MiB object streamed at {width} words a stripe "
              f"({data_np.shape[1] // width} stripes): {ms:.1f} ms first call, digests == "
              f"phase 3's monolithic codeword")


def timed_call(what: str, fn, want: dict | None = None, tally: dict | None = None):
    """Run ``fn`` once with the counters at 0 just before and read just after;
    print its wall, the kernels' time and share of it (``KernelTimer``), the
    launches and the peak device bytes above what was allocated before it.
    ``want``: the launches it must make; ``tally`` adds them up."""
    timer = KernelTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel.reset_launch_counts()
    with timer.active():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    k_ms, counts = timer.ms(), kernel.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    if want:
        check(counts == only(**want), f"{what} launches {counts}, want {want}")
    if tally is not None:
        for name, c in counts.items():
            tally[name] += c
    print(f"{what}: {wall:.1f} ms wall, kernels {k_ms:.3f} ms ({100 * k_ms / wall:.3f}% of "
          f"the wall), launches {({n: c for n, c in counts.items() if c})}, peak "
          f"{peak / 2**30:.3f} GiB above what was allocated before")
    return out


def phase_archive(code, data_np, lost, cw704_digests, dev, seed: int) -> None:
    """Phase 12: the store's lifecycle on phase 3's object, then a batch of
    8 objects; each step timed with the kernels' share of its wall."""
    acfg = archive.ArchiveConfig(n=N, k=K, l=L, seed=seed, num_chunks=NUM_CHUNKS)
    check(acfg.code().cache_key == code.cache_key, "the archive's code is phase 3's")
    blocks = data_np.view(np.uint8)                  # (11, 2^26) bytes
    block_bytes = blocks.shape[1]
    root = tempfile.mkdtemp(prefix="chip_smoke_store-")
    print(f"archive: {N}-node NodeStore under a temporary directory, object of {K} blocks of "
          f"{block_bytes} bytes ({blocks.nbytes / 2**20:.0f} MiB), lost nodes {lost} "
          f"({smi('name,power.limit')})")

    def timed(what: str, fn, **want_launches):
        return timed_call(what, fn, want_launches)

    def same_blobs(a, b, ma, mb, steps_):
        for step in steps_:
            for pos in range(N):
                rel = archive.ARC.format(step=step, i=pos)
                check(a.get(ma[step]["perm"][pos], rel) == b.get(mb[step]["perm"][pos], rel),
                      f"step {step} coded blob {pos} identical in both stores")

    def blobs_match_manifest(store, step):
        m = archive.get_manifest(store, step)
        for pos in range(N):
            raw = store.get(m["perm"][pos], archive.ARC.format(step=step, i=pos))
            check(object_store.digest(raw) == m["coded_digests"][pos],
                  f"step {step} blob {pos} digest == the manifest's")

    try:
        store = object_store.NodeStore(os.path.join(root, "a"), N)
        timed("hot_save", lambda: archive.hot_save(store, 1, blocks, acfg))
        m = timed("archive_step", lambda: archive.archive_step(store, 1, acfg),
                  chain_tick=pipeline.num_ticks(NUM_CHUNKS, N))
        check(m["coded_digests"] == [d[:16] for d in cw704_digests],
              "coded digests == phase 3's codeword rows")
        for i in lost:
            store.fail_node(m["perm"][i])
        res = timed("restore_blocks_ex (host decode)", lambda: archive.restore_blocks_ex(store, 1, acfg))
        check(res.served_from == "degraded" and np.array_equal(res.data, blocks),
              f"degraded restore ({res.served_from}) == the object")
        del res
        rows = timed("repair", lambda: archive.repair(store, 1, acfg),
                     repair_tick=pipeline.num_ticks(NUM_CHUNKS, K))
        check(rows == lost, f"repaired rows {rows}")
        blobs_match_manifest(store, 1)
        off = block_bytes - READ_RANGE_BYTES // 2
        rr = timed("read_range_ex 1 MiB across blocks 0|1",
                   lambda: archive.read_range_ex(store, 1, acfg, off, READ_RANGE_BYTES))
        check(rr.data == blocks.reshape(-1)[off:off + READ_RANGE_BYTES].tobytes(),
              "read_range_ex == the object's bytes")
        store2 = object_store.NodeStore(os.path.join(root, "b"), N)
        archive.hot_save(store2, 1, blocks, acfg)
        misses = jitcache.stats()["misses"]
        stripes = block_bytes // ARCHIVE_STRIPE_BYTES
        m2 = timed(f"archive_step streamed at {ARCHIVE_STRIPE_BYTES >> 20} MiB stripes",
                   lambda: archive.archive_step(store2, 1, acfg,
                                                superchunk_bytes=ARCHIVE_STRIPE_BYTES))
        built = jitcache.stats()["misses"] - misses
        check(kernel.launch_counts() == only(chain_tick=(stripes + built) *
                                             pipeline.num_ticks(NUM_CHUNKS, N)),
              f"streamed archive launches {kernel.launch_counts()}")
        check(m2["coded_digests"] == m["coded_digests"]
              and m2["streaming"]["num_superchunks"] == stripes,
              "streamed archive: coded digests == the monolithic ones")
        same_blobs(store, store2, {1: archive.get_manifest(store, 1)}, {1: m2}, [1])
        shutil.rmtree(os.path.join(root, "a"))
        shutil.rmtree(os.path.join(root, "b"))

        # a batch of 8 objects, against one archive_step / repair each
        gen = torch.Generator(device=dev).manual_seed(seed + 12)
        steps = list(range(1, ARCHIVE_OBJECTS + 1))
        objs = rand_i32(gen, (ARCHIVE_OBJECTS, K, ARCHIVE_BLOCK_BYTES // 4), dev).cpu().numpy()
        objs = objs.view(np.uint8)
        batch = object_store.NodeStore(os.path.join(root, "batch"), N)
        single = object_store.NodeStore(os.path.join(root, "single"), N)
        for step, obj in zip(steps, objs):
            archive.hot_save(batch, step, obj, acfg)
            archive.hot_save(single, step, obj, acfg)
        mb = timed(f"archive_many of {ARCHIVE_OBJECTS} objects of {K} x "
                   f"{ARCHIVE_BLOCK_BYTES >> 20} MiB, stagger 1",
                   lambda: archive.archive_many(batch, steps, acfg, stagger=1),
                   chain_tick=pipeline.num_ticks_many(NUM_CHUNKS, N, ARCHIVE_OBJECTS, 1))
        ms_ = timed(f"archive_step x {ARCHIVE_OBJECTS}",
                    lambda: [archive.archive_step(single, s, acfg) for s in steps],
                    chain_tick=ARCHIVE_OBJECTS * pipeline.num_ticks(NUM_CHUNKS, N))
        check([x["coded_digests"] for x in mb] == [x["coded_digests"] for x in ms_],
              "archive_many coded digests == one archive_step each")
        same_blobs(batch, single, dict(zip(steps, mb)), dict(zip(steps, ms_)), steps)
        for store_ in (batch, single):
            for i in lost:
                store_.fail_node(i)
        got = timed(f"repair_many of {ARCHIVE_OBJECTS} objects, stagger 1",
                    lambda: archive.repair_many(batch, steps, acfg, stagger=1),
                    repair_tick=pipeline.num_ticks_many(NUM_CHUNKS, K, ARCHIVE_OBJECTS, 1))
        want = timed(f"repair x {ARCHIVE_OBJECTS}",
                     lambda: [archive.repair(single, s, acfg) for s in steps],
                     repair_tick=ARCHIVE_OBJECTS * pipeline.num_ticks(NUM_CHUNKS, K))
        check(got == want == [lost] * ARCHIVE_OBJECTS, f"repaired rows {got} / {want}")
        for step in steps:
            blobs_match_manifest(batch, step)
        same_blobs(batch, single, {s: archive.get_manifest(batch, s) for s in steps},
                   {s: archive.get_manifest(single, s) for s in steps}, steps)
        print(f"checks: archive, degraded restore, repair, range read and the streamed "
              f"archive of the 704 MiB object; archive_many / repair_many of "
              f"{ARCHIVE_OBJECTS} objects == one call each, blob for blob")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def leaves_equal(got, want) -> bool:
    """Bit-for-bit equality of two states: the same tree, each tensor leaf of
    the same dtype and shape with the same bytes (compared on the want
    leaf's device), each numpy leaf equal with the same dtype."""
    g, gdef = object_store.tree_flatten(got)
    w, wdef = object_store.tree_flatten(want)
    if str(gdef) != str(wdef):
        return False
    for a, b in zip(g, w):
        if isinstance(b, torch.Tensor):
            if not (isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.to(b.device).reshape(-1).view(torch.uint8),
                                    b.reshape(-1).view(torch.uint8))):
                return False
        elif not (np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)):
            return False
    return True


def tree_bytes(root: str) -> int:
    """Bytes of every file under ``root``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def phase_checkpoint(code, dev, seed: int, pool) -> dict:
    """Phase 13: whisper-base's train state through the checkpoint manager on
    a 16-node store: device-direct saves and restores after 5 node losses,
    the static route, the host route with its migrations, a streamed save.
    Returns the kernels' launches over the phase's counted runs."""
    tally = dict.fromkeys(kernel.launch_counts(), 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 13)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev)
    like = whisper_state(lambda shape: torch.empty(shape, device="meta"))
    layout = devio.state_layout(like)
    check(len(layout.metas) == 83 and layout.blob_len == WHISPER_BLOB_BYTES,
          f"whisper-base state: {len(layout.metas)} leaves, {layout.blob_len} bytes")
    state1 = whisper_state(randn, count=1, step=1)
    state2 = whisper_state(randn, count=2, step=2)
    B = object_store.block_bytes_for(layout.blob_len, K, lane_bytes=devio.LANE_BYTES)
    nc = devio._chunk_count(B // 2, L, NUM_CHUNKS)
    enc_ticks, dec_ticks = pipeline.num_ticks(nc, N), pipeline.num_ticks(nc, K)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    print(f"checkpoint: whisper-base train state, {len(layout.metas)} leaves, blob "
          f"{layout.blob_len} bytes ({layout.blob_len / 2**30:.3f} GiB), {K} blocks of {B} "
          f"bytes, {nc} chunks; ({N},{K}) GF(2^{L}) seed={seed}, 16-node stores under a "
          f"temporary directory, lost nodes {CKPT_LOST} ({smi('name,power.limit')})")

    def timed(what, fn, **want):
        return timed_call(what, fn, want, tally)

    def manager_at(name: str) -> manager.CheckpointManager:
        return manager.CheckpointManager(manager.CheckpointConfig(
            root=os.path.join(root, name), n=N, k=K, l=L, seed=seed, hot_keep=1))

    def remove(mgr) -> None:
        written = tree_bytes(mgr.ccfg.root)
        shutil.rmtree(mgr.ccfg.root)
        print(f"store {os.path.basename(mgr.ccfg.root)}: {written} bytes on disk, removed")

    try:
        # 1-2: device-direct saves, the codeword against the plain matvec
        mgr = manager_at("device")
        m1 = timed("save_sharded step 1 (first: builds the program)",
                   lambda: mgr.save_sharded(1, state1), chain_tick=enc_ticks)
        blob = object_store.tree_to_bytes(state1)
        check(len(blob) == layout.blob_len and blob[:len(layout.prefix)] == layout.prefix,
              "host blob of the state == the layout")
        blocks = object_store.split_blocks(blob, K, lane_bytes=devio.LANE_BYTES)
        del blob
        check(m1["orig_digests"] == [d[:16] for d in host_digests(pool, blocks)],
              "save_sharded blocks == tree_to_bytes of the state, split")
        blocks_p = torch.from_numpy(blocks.view(np.int32)).to(dev)
        del blocks
        want_cw = gf.gf_matvec_packed(code.G, blocks_p, L)
        del blocks_p
        check(m1["coded_digests"] == [d[:16] for d in card_digests(pool,
                                                                  gf.unpack_u32(want_cw, L))],
              "save_sharded codeword == the plain packed matvec on the card")
        del want_cw
        torch.cuda.empty_cache()
        before = jitcache.compile_counts()
        timed("save_sharded step 2 (warm: new values)", lambda: mgr.save_sharded(2, state2),
              chain_tick=enc_ticks)
        check(jitcache.compile_counts() == before, "a repeated save builds no new program")

        # 3: five nodes lost, device-direct restore
        for i in CKPT_LOST:
            mgr.store.fail_node(i)
        got = timed("restore_sharded step 2 after 5 losses (first)",
                    lambda: mgr.restore_sharded(2, like), repair_tick=dec_ticks)
        check(leaves_equal(got, state2), "restore_sharded == the state, bit for bit")
        del got
        before = jitcache.compile_counts()
        got = timed("restore_sharded step 2 (warm)", lambda: mgr.restore_sharded(2, like),
                    repair_tick=dec_ticks)
        check(leaves_equal(got, state2) and jitcache.compile_counts() == before,
              "warm restore == the state, no new program")
        del got

        # 4: the static route: the same blobs as step 1's, one gf_encode launch
        m3 = timed("save_sharded step 3, use_devices=False (gf_encode)",
                   lambda: mgr.save_sharded(3, state1, use_devices=False), gf_encode=1)
        check(m3["coded_digests"] == m1["coded_digests"],
              "static route's coded digests == step 1's")
        for pos in range(N):
            if pos not in CKPT_LOST:
                check(mgr.store.get(pos, archive.ARC.format(step=1, i=pos)) ==
                      mgr.store.get(pos, archive.ARC.format(step=3, i=pos)),
                      f"static route's blob {pos} == step 1's, byte for byte")
        for i in CKPT_LOST:
            mgr.store.fail_node(i)
        got = timed("restore_sharded step 3 after 5 losses, use_devices=False",
                    lambda: mgr.restore_sharded(3, like, use_devices=False), gf_encode=1)
        check(leaves_equal(got, state1), "static restore == the state, bit for bit")
        del got
        remove(mgr)

        # 5: the host route: hot saves, migrations, restore and a range read
        mgr = manager_at("host")
        timed("save step 10 (host: hot replicas)", lambda: mgr.save(10, state1))
        timed("save step 11, archiving step 10", lambda: mgr.save(11, state2),
              chain_tick=enc_ticks)
        timed("save step 12, archiving step 11", lambda: mgr.save(12, state1),
              chain_tick=enc_ticks)
        check([mgr.tier(s) for s in mgr.steps()] == ["archive", "archive", "hot"],
              f"tiers {[mgr.tier(s) for s in mgr.steps()]}")
        for i in CKPT_LOST:
            mgr.store.fail_node(i)
        got = timed("restore step 12 after 5 losses (host route: hot replicas)",
                    lambda: mgr.restore(12, like))
        check(leaves_equal(got, state1), "host restore == the state, bit for bit")
        del got
        # the archived host-route step decodes on the card (the streamed
        # restore below takes the host decode)
        got = timed("restore_sharded step 10 after 5 losses (host-archived)",
                    lambda: mgr.restore_sharded(10, like), repair_tick=dec_ticks)
        check(leaves_equal(got, state1), "device restore of a host-archived step == the state")
        del got
        j = len(layout.metas) // 2
        off = len(layout.prefix) + layout.metas[j]["offset"] - CKPT_RANGE_BYTES // 2
        rr = timed(f"read_range step 11, {CKPT_RANGE_BYTES >> 20} MiB across leaves "
                   f"{j - 1}|{j} (degraded)", lambda: mgr.read_range(11, off, CKPT_RANGE_BYTES))
        check(rr == object_store.tree_to_bytes(state2)[off:off + CKPT_RANGE_BYTES],
              "read_range == the state's blob")
        remove(mgr)

        # 6: a streamed save under a 256 MiB footprint
        mgr = manager_at("stream")
        sc = streaming.superchunk_words_for(CKPT_STREAM_BUDGET, code, NUM_CHUNKS)
        plan = streaming.plan_stream(B // 2, sc, l=L, num_chunks=NUM_CHUNKS)
        misses = jitcache.stats()["misses"]
        m = timed(f"save_sharded step 20 streamed at a {CKPT_STREAM_BUDGET >> 20} MiB footprint",
                  lambda: mgr.save_sharded(20, state1, footprint_bytes=CKPT_STREAM_BUDGET))
        # a program built here runs its ticks once eagerly before it captures
        # the stripes' graphs (on the card)
        built = (jitcache.stats()["misses"] - misses) if dev.type == "cuda" else 0
        stripes_ = m["streaming"]["stripes"]
        check(kernel.launch_counts() == only(chain_tick=(plan.num_superchunks + built)
                                             * pipeline.num_ticks(NUM_CHUNKS, N)),
              f"streamed save launches {kernel.launch_counts()}")
        check(m["streaming"]["num_superchunks"] == plan.num_superchunks
              and m["streaming"]["superchunk_bytes"] == plan.sc_words * 2
              and m["streaming"]["num_chunks"] == NUM_CHUNKS
              and len(stripes_) == plan.num_superchunks
              and sum(s_["words"] for s_ in stripes_) == B // 2
              and all(len(s_["coded_digests"]) == N for s_ in stripes_),
              "the manifest's stripe record")
        check(m["coded_digests"] == m1["coded_digests"],
              "streamed save's coded digests == the device-direct save's")
        print(f"streamed save: {plan.num_superchunks} stripes of {plan.sc_words} words "
              f"(modeled {streaming.estimate_stripe_bytes(code, plan.sc_words) / 2**20:.1f} "
              f"MiB a stripe)")
        for i in CKPT_LOST:
            mgr.store.fail_node(i)
        got = timed("restore_sharded step 20 after 5 losses (streamed: host decode)",
                    lambda: mgr.restore_sharded(20, like))
        check(leaves_equal(got, state1), "streamed restore == the state, bit for bit")
        del got
        remove(mgr)
        print("checks: the codeword against the plain matvec, a warm save building nothing, "
              "restores bit for bit after 5 losses on the device-direct, static, host and "
              "streamed routes, the static and streamed blobs == the device-direct ones")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return tally


def phase_control_plane(code, dev, seed: int) -> dict:
    """Phase 14: the tuner in search mode on the paper's geometry, then a
    cached process; encode_auto on both dispatches; archive_step planned on a
    slowed topology; the CLI on the warm cache. Returns the kernels'
    launches over the phase's counted runs."""
    tally = dict.fromkeys(kernel.launch_counts(), 0)
    nw, b_obj = TUNE_BLOCK_WORDS, TUNE_OBJECTS
    print(f"control plane: ({N},{K}) GF(2^{L}) seed={seed}, {nw} words a block, b_obj={b_obj}, "
          f"tuning cache {autotune.cache_path()} ({smi('name,power.limit')})")

    def timed(what, fn, **want):
        return timed_call(what, fn, want, tally)

    os.environ[autotune.TUNE_ENV] = "search"
    autotune.reset()
    rep = timed("prewarm (search)", lambda: autotune.prewarm(code, nwords=nw, b_obj=b_obj))
    check(rep["backend"] == autotune.backend(dev) and rep["stats"]["probes"] >= 6,
          f"prewarm: backend {rep['backend']}, stats {rep['stats']}")
    cal = rep["calibration"]
    samples = [(x["num_chunks"], x["measured_s"], x["model_s"], x["hlo_pred_s"])
               for x in cal["samples"]]
    print(f"calibration: compute_rate {cal['compute_rate']:.6g} B/s, tick_overhead "
          f"{cal['tick_overhead']:.6g} s, tick_quad {cal['tick_quad']:.6g}, max_rel_err "
          f"{cal['max_rel_err']}; samples (num_chunks, measured s, model s, bytes-model s): "
          f"{samples}")
    dispatch = autotune.cache().get(autotune._key("dispatch", f"l={L}", f"rows={N}",
                                                  f"k={K}", f"B={nw}", device=dev))
    threads = autotune.cache().get(autotune._key("encode_packed", f"l={L}", f"Bp={nw // 2}",
                                                 device=dev))
    print(f"dispatch: timings {dispatch['timings_s']} s, winner {dispatch['value']}; "
          f"gf_encode threads a block: timings {threads['timings_s']} s, winner "
          f"{threads['value']}")
    print(f"tuned: num_chunks encode {rep['num_chunks_encode']}, encode_many "
          f"{rep['num_chunks_encode_many']} (b_obj {b_obj}), stagger {rep['stagger']}; "
          f"probes {rep['stats']['probes']}")

    # a cached process: the entry points resolve without a probe
    os.environ[autotune.TUNE_ENV] = "cached"
    autotune.reset()
    data = autotune.random_words((K, nw), L, dev)
    nc, nc_many, stg = rep["num_chunks_encode"], rep["num_chunks_encode_many"], rep["stagger"]
    cw = timed("pipelined_encode, num_chunks=None (tuned)",
               lambda: chain.pipelined_encode(code, data), chain_tick=pipeline.num_ticks(nc, N))
    check(words_equal(cw, chain.pipelined_encode(code, data, num_chunks=nc))
          and words_equal(cw, chain.pipelined_encode(code, data, num_chunks=NUM_CHUNKS)),
          "the tuned encode == the explicit calls")
    del cw
    objs = autotune.random_words((b_obj, K, nw), L, dev)
    many = timed("pipelined_encode_many, num_chunks=None, stagger=None (tuned)",
                 lambda: multi.pipelined_encode_many(code, objs),
                 chain_tick=pipeline.num_ticks_many(nc_many, N, b_obj, stg))
    check(words_equal(many, multi.pipelined_encode_many(code, objs, num_chunks=nc_many,
                                                        stagger=stg))
          and words_equal(many, multi.pipelined_encode_many(code, objs, num_chunks=NUM_CHUNKS,
                                                            stagger=1)),
          "the tuned encode_many == the explicit calls")
    del many, objs
    torch.cuda.empty_cache()
    check(autotune.stats()["probes"] == 0, f"a cached process probes: {autotune.stats()}")

    # encode_auto on each dispatch, against the plain versions
    key = autotune._key("dispatch", f"l={L}", f"rows={N}", f"k={K}", f"B={nw}", device=dev)
    def plain_packed(M, words, l):
        return gf.unpack_u32(ref.encode_packed_ref(M, gf.pack_u32(words, l), l), l)
    for choice, name, plain in (("vpu", "gf_encode", plain_packed),
                                ("mxu", "gf_encode_mxu", ref.bitlift_encode_ref)):
        autotune.cache().put(key, {"value": choice})      # in memory only
        out = timed(f"encode_auto with dispatch {choice!r}",
                    lambda: ops.encode_auto(code.G, data, L), **{name: 1})
        check(words_equal(out, plain(code.G, data, L)), f"encode_auto ({choice}) == plain")
        del out
    autotune.reset()                                      # back to the file's entries

    # a kernel failure in a probe is raised, not skipped
    os.environ[autotune.TUNE_ENV] = "search"
    autotune.reset()
    real = kernel.gf_encode_mxu

    def broken(*args, **kwargs):
        raise RuntimeError("gf_encode_mxu: launch failed (injected by chip_smoke)")
    half = gf.unpack_u32(gf.pack_u32(data, L)[:, :nw // 4].contiguous(), L)   # a new geometry
    kernel.gf_encode_mxu = broken
    try:
        ops.dispatch_for_data(code.G, half, L)
        raised = False
    except RuntimeError:
        raised = True
    finally:
        kernel.gf_encode_mxu = real
    check(raised and autotune.cache().get(autotune._key(
        "dispatch", f"l={L}", f"rows={N}", f"k={K}", f"B={nw // 2}", device=dev)) is None,
        "a failing kernel in a dispatch probe raises and persists nothing")
    del half
    os.environ[autotune.TUNE_ENV] = "cached"
    autotune.reset()
    del data
    torch.cuda.empty_cache()

    # archive_step planned by the scheduler on a topology with two slow nodes
    topo = topology.Topology.uniform(N)
    for i in SLOW_NODES:
        topo = topo.with_slow(i, 4.0)
    plan = scheduler.plan_chain(topo, K, float(ARCHIVE_BLOCK_BYTES))
    plan_nc = plan.num_chunks
    while plan_nc > 1 and (ARCHIVE_BLOCK_BYTES // 2) % (gf.LANES[L] * plan_nc):
        plan_nc //= 2
    acfg = archive.ArchiveConfig(n=N, k=K, l=L, seed=seed, num_chunks=NUM_CHUNKS)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    blocks = rand_i32(gen, (K, ARCHIVE_BLOCK_BYTES // 4), dev).cpu().numpy().view(np.uint8)
    root = tempfile.mkdtemp(prefix="chip_smoke_topo-")
    try:
        store = object_store.NodeStore(root, N)
        archive.hot_save(store, 1, blocks, acfg)
        m = timed(f"archive_step with topology (nodes {list(SLOW_NODES)} slowed 4x), "
                  f"{K} x {ARCHIVE_BLOCK_BYTES >> 20} MiB",
                  lambda: archive.archive_step(store, 1, acfg, topology=topo),
                  chain_tick=pipeline.num_ticks(plan_nc, N))
        check(m["sched"] == {**plan.to_manifest(), "topology": topo.to_dict(),
                             "num_chunks": plan_nc} and m["perm"] == list(plan.order),
              "the manifest records the scheduler's plan")
        print(f"sched: order {m['sched']['order']}, num_chunks {m['sched']['num_chunks']} "
              f"(planned {plan.num_chunks}), makespan_s {m['sched']['makespan_s']}")
        for i in CKPT_LOST:
            store.fail_node(i)
        res = timed("restore_blocks_ex after 5 losses (host decode)",
                    lambda: archive.restore_blocks_ex(store, 1, acfg))
        check(np.array_equal(res.data, blocks), "the scheduled archive restores bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the CLI on the warm cache: zero probes
    src = str(Path(__file__).resolve().parent / "src")
    env = {**os.environ, autotune.TUNE_ENV: "search",
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.autotune", "--n", str(N),
                           "--k", str(K), "--l", str(L), "--seed", str(seed), "--nwords",
                           str(nw), "--b-obj", str(b_obj), "--device", str(dev), "--json"],
                          env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"autotune CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout)
    check(cli["stats"]["probes"] == 0 and all(cli[k_] == rep[k_] for k_ in (
        "num_chunks_encode", "num_chunks_encode_many", "stagger", "dispatch")),
        f"CLI on the warm cache: {cli['stats']}")
    print(f"python -m repro_torch.autotune --n {N} --k {K} --nwords {nw} --json: exit 0 in "
          f"{cli_s:.1f} s, probes {cli['stats']['probes']}, hits {cli['stats']['hits']}")
    print("checks: prewarm on the card, zero probes in a cached process and in the CLI, tuned "
          "codewords == explicit calls, encode_auto == plain on both dispatches, a failing "
          "probe raises, the scheduled archive restores")
    return tally


# ---------------------------------------------------------------------------
# phase 15: the live cluster
# ---------------------------------------------------------------------------


def live_engine(root: str, dev, seed: int, block_bytes: int) -> serving.ServingEngine:
    """Phase 15's cluster: the (16,11) GF(2^16) code on a 16-node
    ``ChurnNodeStore``, one arrival a tick archived at age 3 in batches of up
    to 4 under the bounded churn trace, behind ``fig_serving``'s admission
    controller, served through ``ServingEngine`` on ``dev``."""
    acfg = archive.ArchiveConfig(n=N, k=K, l=L, seed=seed, num_chunks=NUM_CHUNKS)
    lcfg = lifecycle.LifecycleConfig(arrival_rate=1.0, block_bytes=block_bytes,
                                     archive_age=3, batch_max=4, seed=seed)
    trace = churn.bounded_trace(N, K, LIVE_TICKS, fail_rate=LIVE_FAIL_RATE, seed=seed)
    ctrl = AdmissionController(AdmissionConfig(rate=2.0, burst=4.0, read_capacity=8,
                                               max_inflight=2))
    lc = lifecycle.ClusterLifecycle(root, acfg, lcfg, trace, admission=ctrl, device=dev)
    return serving.ServingEngine(lc)


def tree_files(root: str) -> dict[str, bytes]:
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def phase_live(dev, seed: int) -> dict:
    """Phase 15: the live cluster at a real size — churn, arrivals, admission-
    throttled migration and scrub, and served reads — then the same run at
    4 KiB blocks on the card and with the plain versions. Returns the
    kernels' launches over the soak."""
    wtrace = workload.synthetic_workload(workload.WorkloadConfig(seed=seed), LIVE_TICKS)
    by_tick = wtrace.by_tick()
    obj_bytes = K * LIVE_BLOCK_BYTES
    print(f"live cluster: ({N},{K}) GF(2^{L}) seed={seed}, {N}-node ChurnNodeStore under a "
          f"temporary directory, blocks of {LIVE_BLOCK_BYTES} bytes (objects of "
          f"{obj_bytes >> 20} MiB), LifecycleConfig(arrival_rate=1.0, archive_age=3, "
          f"batch_max=4), bounded_trace({N}, {K}, {LIVE_TICKS}, fail_rate={LIVE_FAIL_RATE}), "
          f"{len(wtrace.requests)} requests (WorkloadConfig defaults), AdmissionConfig(rate=2.0, "
          f"burst=4.0, read_capacity=8, max_inflight=2) ({smi('name,power.limit')})")
    root = tempfile.mkdtemp(prefix="chip_smoke_live-")
    try:
        eng = live_engine(root, dev, seed, LIVE_BLOCK_BYTES)
        timer, peak_disk, walls, k_total = KernelTimer(), 0, [], 0.0
        torch.cuda.synchronize()
        kernel.reset_launch_counts()
        with timer.active():
            for t in range(LIVE_TICKS):
                spans = len(timer.spans)
                t0 = time.perf_counter()
                row = eng.tick(by_tick.get(t, []))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k_ms = sum(a.elapsed_time(b) for a, b in timer.spans[spans:])
                k_total += k_ms
                walls.append(wall)
                disk = tree_bytes(root)
                peak_disk = max(peak_disk, disk)
                print(f"tick {t}: {wall * 1e3:.1f} ms wall, kernels {k_ms:.3f} ms "
                      f"({100 * k_ms / (wall * 1e3):.3f}%), fails {row['fails']} joins "
                      f"{row['joins']} down {row['down_nodes']}, reads {len(by_tick.get(t, []))}, "
                      f"archived {row['archived']} sealed {row['sealed']} repaired "
                      f"{row['repaired_shards']} re-replicated {row['re_replicated']}, objects hot "
                      f"{row['objects_hot']} archived {row['objects_archived']} sealed "
                      f"{row['objects_sealed']}, bg granted {row['bg_granted']} urgent "
                      f"{row['bg_urgent']} denied {row['bg_denied']}, {disk} bytes on disk")
        counts = kernel.launch_counts()
        rep = eng.report()
        life = rep["lifecycle"]
        check(counts["chain_tick"] > 0 and counts["repair_tick"] > 0,
              f"the soak launched chain_tick and repair_tick: {counts}")
        check(life["lost_objects"] == 0, f"lost objects {life['lost_objects']}")
        check(rep["wrong_bytes"] == 0, f"wrong bytes {rep['wrong_bytes']}")
        check(life["total_repaired_shards"] > 0,
              f"the scrub healed shards: {life['total_repaired_shards']}")
        check(life["scrub_errors"] == 0 and not eng.lc.scrub_errors,
              f"scrub errors {eng.lc.scrub_errors}")
        t0 = time.perf_counter()
        restored = eng.lc.verify_all()
        verify_s = time.perf_counter() - t0
        check(restored == life["objects"] == len(eng.lc.objects),
              f"verify_all restored {restored} of {life['objects']} objects")
        soak_s = sum(walls)
        print(f"soak: {LIVE_TICKS} ticks in {soak_s:.3f} s (ticks {min(walls):.3f}-"
              f"{max(walls):.3f} s), kernels {k_total:.3f} ms ({100 * k_total / soak_s / 1e3:.3f}% "
              f"of the walls), launches {({n: c for n, c in counts.items() if c})}, peak "
              f"{peak_disk} bytes on disk ({peak_disk / 2**30:.3f} GiB)")
        print(f"serving: {rep['count']} reads served ({rep['served']}), {rep['unresolved']} "
              f"unresolved, wrong bytes {rep['wrong_bytes']}; modelled latency p50 "
              f"{rep['p50'] * 1e3:.3f} ms, p99 {rep['p99'] * 1e3:.3f} ms, p999 "
              f"{rep['p999'] * 1e3:.3f} ms; admission {rep['admission']}")
        print(f"lifecycle: {life}; verify_all restored {restored} objects digest-verified in "
              f"{verify_s:.3f} s (host decode)")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the same trace and workload at 4 KiB blocks: the card and the plain versions
    runs = {}
    for where in (dev, torch.device("cpu")):
        root = tempfile.mkdtemp(prefix="chip_smoke_live_small-")
        try:
            eng = live_engine(root, where, seed, LIVE_PARITY_BLOCK_BYTES)
            kernel.reset_launch_counts()
            rep = eng.run(wtrace, LIVE_TICKS)
            runs[where.type] = (eng.lc.metrics, rep, eng.requests, tree_files(root),
                                kernel.launch_counts(), eng.lc.verify_all())
        finally:
            shutil.rmtree(root, ignore_errors=True)
    card, plain = runs["cuda"], runs["cpu"]
    check(card[4]["chain_tick"] > 0 and plain[4] == dict.fromkeys(plain[4], 0),
          f"the 4 KiB run's launches: card {card[4]}, plain {plain[4]}")
    check(card[0] == plain[0], "4 KiB: per-tick rows on the card == plain versions")
    check(card[1] == plain[1] and card[2] == plain[2],
          "4 KiB: serving reports on the card == plain versions")
    check(sorted(card[3]) == sorted(plain[3]) and card[3] == plain[3] and card[5] == plain[5],
          "4 KiB: store trees on the card == plain versions, file by file")
    print(f"checks: zero lost objects, zero wrong bytes, verify_all restores every object, "
          f"{life['total_repaired_shards']} shards healed, chain_tick and repair_tick launched; "
          f"at {LIVE_PARITY_BLOCK_BYTES} bytes a block the card's run == the plain versions' "
          f"(rows, reports, {len(card[3])} files)")
    return counts


# ---------------------------------------------------------------------------
# phase 16: LM serving
# ---------------------------------------------------------------------------


def phase_lm_serve(dev, seed: int) -> None:
    """Phase 16: qwen3-1.7b at full width and depth, random weights from the
    seed, served through ``launch.serve.generate`` in bfloat16; then prefill
    plus decode against one longer prefill, and a 2-layer full-width copy in
    float32 on the card against the host."""
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab) == (28, 2048, 151936),
          f"{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    params = lm.init(seed, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in lm._leaves(params))
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=dev,
                            dtype=torch.int32)
    print(f"LM serving: {LM_ARCH}, {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {n_params} parameters ({cfg.param_dtype}, made on the card in "
          f"{init_s:.3f} s), compute {cfg.compute_dtype}; batch {LM_BATCH}, prompts of "
          f"{LM_PROMPT} tokens (q_chunk {cfg.q_chunk}), {LM_NEW} greedy new tokens "
          f"({smi('name,power.limit')})")
    out, stats = serve.generate(cfg, params, prompts, LM_NEW)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counts = kernel.launch_counts()
    check(out.shape == (LM_BATCH, LM_PROMPT + LM_NEW), f"generated {out.shape}")
    check(np.array_equal(out[:, :LM_PROMPT], prompts.cpu().numpy())
          and out.min() >= 0 and out.max() < cfg.vocab, "generated tokens")
    check(counts == dict.fromkeys(counts, 0), f"LM serving launched GF kernels: {counts}")
    print(f"generate: prefill {stats['prefill_s'] * 1e3:.1f} ms wall ({LM_BATCH * LM_PROMPT} "
          f"tokens, {LM_BATCH * LM_PROMPT / stats['prefill_s']:.1f} tokens/s), decode "
          f"{stats['decode_s'] * 1e3:.1f} ms for {LM_NEW - 1} steps "
          f"({stats['decode_tok_per_s']:.1f} tokens/s, "
          f"{stats['decode_s'] / (LM_NEW - 1) * 1e3:.2f} ms a step), peak "
          f"{peak / 2**30:.3f} GiB above what was allocated before (params included); "
          f"GF kernel launches {counts}")

    # prefill then decode == one prefill over the longer prompt, in float32
    # (TF32 off) at the reference's rtol = atol, and in the served bfloat16
    seq = torch.from_numpy(out).to(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            cast = lm.cast_params(params, c)
            _, cache = lm.prefill(cast, c, seq[:, :LM_PROMPT])
            cache = lm.extend_cache(cache, LM_PROMPT + LM_CHECK_STEPS)
            rows = []
            for i in range(LM_CHECK_STEPS):
                pos = LM_PROMPT + i
                dec, cache = lm.decode_step(cast, c, cache, seq[:, pos:pos + 1], pos)
                want, _ = lm.prefill(cast, c, seq[:, :pos + 1])
                check(bool(torch.isfinite(dec).all()), f"{dtype} decode logits finite at {pos}")
                err, scale = (dec - want).abs().max().item(), want.abs().max().item()
                outside = ((dec - want).abs() > LM_TOL * (1 + want.abs())).float().mean().item()
                if dtype == "float32":
                    check(torch.allclose(dec, want, rtol=LM_TOL, atol=LM_TOL),
                          f"float32 decode at {pos} vs one prefill: max |diff| {err}")
                else:
                    check(err <= LM_TOL * scale, f"bfloat16 decode at {pos} vs one prefill: "
                          f"max |diff| {err} over the logits' scale {scale}")
                rows.append((pos, round(err, 6), round(scale, 4), round(outside, 4),
                             bool(torch.equal(dec.argmax(-1), want.argmax(-1)))))
            print(f"consistency ({dtype}): {LM_CHECK_STEPS} decode steps after a {LM_PROMPT}-"
                  f"token prefill against one prefill over the longer prompt; (position, max "
                  f"|diff|, max |logit|, share outside rtol = atol = {LM_TOL}, same argmax): "
                  f"{rows}")
            del cast, cache
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del params, seq
    torch.cuda.empty_cache()

    # a 2-layer full-width copy in float32: the card (TF32 off) against the host
    small = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS, compute_dtype="float32")
    on_card = lm.init(seed, small, device=dev)
    on_host = lm._map(lambda t: t.cpu(), on_card)
    toks = torch.randint(0, cfg.vocab, (LM_CPU_BATCH, LM_CPU_PROMPT), generator=gen,
                         device=dev, dtype=torch.int32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for where, params_ in (("card", on_card), ("host", on_host)):
            t = toks.to(params_["embed"].device)
            logits, cache = lm.prefill(params_, small, t)
            cache = lm.extend_cache(cache, LM_CPU_PROMPT + LM_CPU_NEW)
            steps_ = [logits.cpu()]
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            for i in range(LM_CPU_NEW - 1):
                logits, cache = lm.decode_step(params_, small, cache, nxt, LM_CPU_PROMPT + i)
                steps_.append(logits.cpu())
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            gen_out, _ = serve.generate(small, params_, t, LM_CPU_NEW)
            runs[where] = (torch.stack(steps_), gen_out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (card_logits, card_tokens), (host_logits, host_tokens) = runs["card"], runs["host"]
    err = (card_logits - host_logits).abs().max().item()
    check(np.array_equal(card_tokens, host_tokens),
          f"greedy tokens card vs host: {card_tokens[:, LM_CPU_PROMPT:]} / "
          f"{host_tokens[:, LM_CPU_PROMPT:]}")
    check(torch.allclose(card_logits, host_logits, rtol=LM_CPU_TOL, atol=LM_CPU_TOL),
          f"float32 logits card vs host: max |diff| {err}")
    print(f"card vs host: {LM_CPU_LAYERS}-layer full-width copy in float32 (TF32 off), batch "
          f"{LM_CPU_BATCH}, {LM_CPU_PROMPT}-token prompt, {LM_CPU_NEW} greedy tokens: same "
          f"tokens, logits (prefill and {LM_CPU_NEW - 1} decode steps) within rtol = atol = "
          f"{LM_CPU_TOL}, max |diff| {err:.3g}")
    del on_card, on_host
    torch.cuda.empty_cache()


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
    # a tuning cache of the run's own: a user's cache must not change a result
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune-")
    os.environ[autotune.CACHE_ENV] = os.path.join(tune_dir, "autotune.json")
    os.environ[autotune.TUNE_ENV] = "cached"
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
            return run_phases(dev, seed, pool)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run_phases(dev, seed: int, pool) -> int:
    """Phases 1-16, then the kernels line and the device line."""
    t_start = time.perf_counter()

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    kernel.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({kernel.library_path().name})")
    print("ptxas:", " | ".join(ptxas_summary(kernel.build_log())))
    print(smi("name,power.limit"))  # the card's name and power limit

    # -- phase 2: kernels vs plain versions, small ragged shapes -------------
    errs = dict.fromkeys(REPLACES, 0)
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
    resident = torch.cuda.memory_allocated()
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
    dec_resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rec = chain.pipelined_decode(code, ids, shards, num_chunks=NUM_CHUNKS)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3
    counts = kernel.launch_counts()
    dec_peak = torch.cuda.max_memory_allocated()

    enc_ticks = pipeline.num_ticks(NUM_CHUNKS, N)
    dec_ticks = pipeline.num_ticks(NUM_CHUNKS, len(ids))
    check(enc_counts == only(chain_tick=enc_ticks),
          f"encode launches {enc_counts}, want {enc_ticks} chain_tick")
    check(counts == only(chain_tick=enc_ticks, repair_tick=dec_ticks),
          f"decode launches {counts}, want {dec_ticks} repair_tick")
    check(tuple(cw.shape) == (N, B), f"codeword shape {tuple(cw.shape)}")
    check(torch.equal(gf.pack_u32(rec, L), data_p), "decoded object == data")
    check(torch.equal(cw_p, gf.gf_matvec_packed(code.G, data_p, L)),
          "codeword == plain packed matvec on the card")
    starts = window_starts(B, rng)
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
          f"launches {enc_counts['chain_tick']}, peak {enc_peak / 2**30:.2f} GiB "
          f"({(enc_peak - resident) / 2**30:.3f} GiB above the resident object)")
    print(f"decode: {dec_ms:.3f} ms wall first call, {dec_warm:.3f} ms median of "
          f"5 repeats ({mib / dec_warm * 1e3:.1f} MiB/s of object), repair_tick "
          f"launches {counts['repair_tick']}, peak {dec_peak / 2**30:.2f} GiB "
          f"({(dec_peak - dec_resident) / 2**30:.3f} GiB above the resident inputs)")
    print(f"checks: decode == data, codeword == plain matvec, "
          f"{len(starts)} windows == host gf_matmul_np")
    cw704_digests = card_digests(pool, cw)        # held by phases 11 and 12

    # -- phase 4: the main path's ticks, kernel vs plain version --------------
    Bp, S = B // 2, B // 2 // NUM_CHUNKS
    chain.product_tables.cache_clear()
    t0 = time.perf_counter()
    chain.product_tables(code)
    table_first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    chain.product_tables(code)
    table_cached_ms = (time.perf_counter() - t0) * 1e3
    src, slots, tables = chain.encode_operands(code, data_p)
    check_table_planes(tables, *chain.bitplane_coeff_planes(code), L, "main path")
    enc_outs, timings = {}, {}

    def enc_tick(tick, wi, wo, t, lo, count):
        tick(wi, wo, src, slots, enc_outs[tick], tables, L, t, NUM_CHUNKS, lo, count)

    clocks = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    for tick, reps in ((kernel.chain_tick, 5), (ref.chain_tick_ref, 3)):
        enc_outs[tick] = torch.empty((N, 1, Bp), dtype=torch.int32, device=dev)
        timings[tick] = median_ms(replay(N, tick, (N, 1, S), dev, enc_tick), reps)
    check(torch.equal(enc_outs[kernel.chain_tick], enc_outs[ref.chain_tick_ref]),
          "chain_tick == plain version over the main path's ticks")
    check(torch.equal(enc_outs[kernel.chain_tick][:, 0], cw_p), "replayed codeword")
    errs["chain_tick"] = max(errs["chain_tick"], max_abs_err(
        enc_outs[kernel.chain_tick], enc_outs[ref.chain_tick_ref]))
    print(f"chain_tick main path (23 ticks): {timings[kernel.chain_tick]:.3f} ms; sm MHz, "
          f"mem MHz, W, C before the replay: {clocks}")
    enc_outs.clear()

    chain.decode_tables.cache_clear()
    t0 = time.perf_counter()
    chain.decode_tables(code, tuple(ids))
    dec_table_first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    chain.decode_tables(code, tuple(ids))
    dec_table_cached_ms = (time.perf_counter() - t0) * 1e3
    dec_shards = gf.pack_u32(shards, L)[:, None]    # the survivors' shards, read in place
    dec_tables = chain.decode_operands(code, ids, dev)
    check_repair_planes(dec_tables, chain.column_bitplanes(code.decode_matrix(ids), L),
                        "decode")
    n_alive = len(ids)
    dec_rows = np.arange(n_alive, dtype=np.int32)
    dec_outs = {}

    def dec_tick(tick, wi, wo, t, lo, count):
        tick(wi, wo, dec_shards, dec_rows, dec_outs[tick], dec_tables, L, t, NUM_CHUNKS, lo,
             count, True)

    for tick, reps in ((kernel.repair_tick, 5), (ref.repair_tick_ref, 3)):
        dec_outs[tick] = torch.empty((1, K, Bp), dtype=torch.int32, device=dev)
        timings[tick] = median_ms(
            replay(n_alive, tick, (n_alive, 1, K, S), dev, dec_tick), reps)
    check(torch.equal(dec_outs[kernel.repair_tick], dec_outs[ref.repair_tick_ref]),
          "repair_tick == plain version over the main path's ticks")
    check(torch.equal(dec_outs[kernel.repair_tick][0], data_p), "replayed decode")
    errs["repair_tick"] = max(errs["repair_tick"], max_abs_err(
        dec_outs[kernel.repair_tick], dec_outs[ref.repair_tick_ref]))

    # Work over all of a run's ticks (chain_tick_work, repair_tick_work).
    work = {name: {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0,
                   "ops": 0, "int8_ops": 0} for name in REPLACES}
    add_work(work, "chain_tick", counts["chain_tick"], timings[kernel.chain_tick],
             timings[ref.chain_tick_ref], *chain_tick_work(code, Bp))
    add_work(work, "repair_tick", counts["repair_tick"], timings[kernel.repair_tick],
             timings[ref.repair_tick_ref], *repair_tick_work(n_alive, K, Bp, head_zero=True))
    print(f"encode operands: product tables {tuple(tables.shape)} built on the host in "
          f"{table_first_ms:.3f} ms at the code's first encode, {table_cached_ms:.4f} ms "
          f"cached; no placement copy: encode peak {enc_peak / 2**30:.3f} GiB, "
          f"{(enc_peak - resident) / 2**30:.3f} GiB above the resident object")
    print(f"decode operands: product tables {tuple(dec_tables.shape)} built on the host in "
          f"{dec_table_first_ms:.3f} ms at a survivor set's first decode, "
          f"{dec_table_cached_ms:.4f} ms cached; the shards are read in place")
    report_work("chain_tick", work["chain_tick"], "main path")
    report_work("repair_tick", work["repair_tick"], "main path, head row's read skipped")

    # -- phase 5: static-coefficient kernels vs plain versions, small shapes --
    phase_static_kernels(dev, seed, errs)

    # -- phase 6: atomic encode, bit-lift encode, repair, degraded read -------
    launches = phase_slice(code, data_np, data_p, data, cw_p, lost, ids, shards, dev)

    print_compiles()
    print(f"gf_encode_mxu at ({N},{K}) over GF(2^{L}): tiling (NT, n-tiles, K_pad) "
          f"{kernel.mxu_tiling(N, K, L)}, {kernel.mxu_smem_bytes(N, K, L)} bytes of "
          f"dynamic shared memory per block")

    # -- phase 7: the slice's launches, kernel vs plain version ---------------
    phase_replay(code, cw_p, lost, ids, launches, work, errs, dev)
    del launches, data_p, data, cw, cw_p, shards, rec, src, tables, dec_shards, dec_tables
    torch.cuda.empty_cache()

    # -- phase 8: staggered multi-object encode, decode, repair at full size --
    phase_many(code, lost, ids, dev, seed, work, errs)

    # -- phase 9: the staggered ticks against their plain versions ------------
    phase_many_ticks(code, lost, ids, dev, seed, errs)

    # -- phase 10: the LRC and MBR code families at small shapes --------------
    phase_families(dev, seed)

    # -- phase 11: streaming a 5.5 GiB object through a 1 GiB budget ----------
    phase_streaming(code, lost, ids, data_np, cw704_digests, dev, seed, pool)

    # -- phase 12: the archive lifecycle at the paper's size ------------------
    phase_archive(code, data_np, lost, cw704_digests, dev, seed)
    del data_np

    # -- phase 13: checkpointing whisper-base's train state --------------------
    slice_launches = phase_checkpoint(code, dev, seed, pool)
    torch.cuda.empty_cache()

    # -- phase 14: the control plane -------------------------------------------
    for name, c in phase_control_plane(code, dev, seed).items():
        slice_launches[name] += c
    check(all(c > 0 for c in slice_launches.values()),
          f"every kernel launched on phases 13-14's paths: {slice_launches}")
    print(f"launches on phases 13-14's paths: {slice_launches}")
    torch.cuda.empty_cache()

    # -- phase 15: the live cluster ---------------------------------------------
    live_launches = phase_live(dev, seed)

    # -- phase 16: qwen3-1.7b served at full width and depth ---------------------
    phase_lm_serve(dev, seed)

    rows = []
    for name, w in work.items():
        bytes_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = max(w["ops"] / INT32_OPS_PER_S, w["int8_ops"] / INT8_OPS_PER_S) * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": w["launches"],
            "max_abs_err": errs[name], "ms": w["ms"], "plain_ms": w["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "library_why": LIBRARY_WHY[name],
            "slice_launches": {"phases 13-14": slice_launches.get(name),
                               "phase 15": live_launches.get(name)},
            "bytes": w["bytes"], "ops": w["ops"], "int8_ops": w["int8_ops"],
        })
        report_work(name, w, "all paths")
    print(f"script wall: {time.perf_counter() - t_start:.1f} s after the imports "
          f"({smi('name,power.limit')})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
