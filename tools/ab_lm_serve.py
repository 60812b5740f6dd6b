#!/usr/bin/env python3
"""Prefill and decode walls of one checkout's LM serving path.

    python3 tools/ab_lm_serve.py [--src DIR] [--arch qwen3-1.7b] [--batch 4]
        [--prompt 2048] [--new 64] [--reps 3] [--seed 0]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
makes ``--arch`` at full width and depth with random weights from the seed
on the card, and runs ``launch.serve.generate`` in the config's compute
dtype on random prompts ``--reps`` times after one warm call: the prefill
wall (host clock around the synchronized prefill) and the decode loop's
wall per step, as ``generate`` reports them. Prints one JSON line with
each rep's numbers, their medians, and the card's name and power limit.
To compare two checkouts on one card, run it for each in turns in one
command (parent, change, change, parent), e.g. with the parent unpacked by
``git archive`` under the gitignored ``build/``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_lm_serve: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    params = model.init(args.seed, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    enc = None
    if cfg.family == "encdec":
        enc = torch.randn((args.batch, cfg.enc_ctx, cfg.d_model), generator=gen, device=dev,
                          dtype=torch.bfloat16)
    rows = []
    for rep in range(args.reps + 1):
        prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt), generator=gen,
                                device=dev, dtype=torch.int32)
        _, stats = serve.generate(cfg, params, prompts, args.new, enc_frames=enc)
        if rep:                                  # the first call warms up
            rows.append({"prefill_ms": stats["prefill_s"] * 1e3,
                         "decode_ms_a_step": stats["decode_s"] / (args.new - 1) * 1e3})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "src": args.src, "arch": args.arch, "batch": args.batch, "prompt": args.prompt,
        "new": args.new, "reps": rows,
        "median_prefill_ms": statistics.median(r["prefill_ms"] for r in rows),
        "median_decode_ms_a_step": statistics.median(r["decode_ms_a_step"] for r in rows),
        "card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
