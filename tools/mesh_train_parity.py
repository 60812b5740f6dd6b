#!/usr/bin/env python3
"""Sharded training against one-device training on one card.

    PYTHONPATH=src python3 tools/mesh_train_parity.py [--arch qwen3-1.7b]
        [--steps 3] [--mesh 2x2] [--layout 2d] [--layers 0] [--device cuda]

Runs ``launch.train.run_training`` twice from the same seed and data — on
one device, then over a (data, model) mesh of the device repeated — first in
float32 compute with TF32 off, then in the config's own compute dtype, and
prints each step's loss and gradient norm from both runs with their
relative differences, the largest parameter difference after the last step
(float32), and each run's median step wall. The float32 difference is the
partitioning's own (reduction order); the bfloat16 one adds the rounding of
tensor-parallel partial sums, which is what ``chip_smoke.py`` phase 20's
loss tolerance must cover. ``--layers N`` cuts the depth (0: the config's).
The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def _run(cfg, ocfg, dcfg, steps: int, **where) -> dict:
    return run_training(cfg, ocfg, dcfg, steps, log_every=1, log=lambda *_: None, **where)


def compare(cfg, steps: int, mesh, layout: str, dev) -> dict:
    ocfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=5, total_steps=6,
                           state_dtype=cfg.param_dtype)
    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq=128, global_batch=8, seed=0)
    one = _run(cfg, ocfg, dcfg, steps, device=dev)
    one_params = one.pop("params")
    del one["opt"]
    sharded = _run(cfg, ocfg, dcfg, steps, mesh=mesh, layout=layout)
    rows = []
    for a, b in zip(one["history"], sharded["history"]):
        rows.append({"step": a["step"], "loss": [a["loss"], b["loss"]],
                     "loss_rel": abs(a["loss"] - b["loss"]) / abs(a["loss"]),
                     "grad_norm": [a["grad_norm"], b["grad_norm"]],
                     "grad_norm_rel": abs(a["grad_norm"] - b["grad_norm"]) / abs(a["grad_norm"])})
    err = 0.0
    for (p,), (st,) in zip(adamw._zip(one_params), adamw._zip(sharded["params"])):
        err = max(err, float((p.detach() - st.full(p.device)).abs().max()))
    return {"compute_dtype": cfg.compute_dtype, "steps": rows, "param_max_abs_diff": err,
            "one_step_s": statistics.median(one["step_s"][1:] or one["step_s"]),
            "sharded_step_s": statistics.median(sharded["step_s"][1:] or sharded["step_s"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--layout", default="2d", choices=("2d", "fsdp"))
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    data, model = (int(x) for x in args.mesh.split("x"))
    mesh = mesh_lib.make_local_mesh(data, model, devices=[dev] * (data * model))
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    card = ""
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    results = []
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    for dtype in ("float32", cfg.compute_dtype):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            r = compare(dataclasses.replace(cfg, compute_dtype=dtype), args.steps, mesh,
                        args.layout, dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        results.append(r)
        worst = max(s["loss_rel"] for s in r["steps"])
        print(f"{args.arch} ({cfg.n_layers} layers) {dtype}: one device vs {args.mesh} "
              f"{args.layout}, losses {[s['loss'] for s in r['steps']]}, largest relative "
              f"loss difference {worst:.3g}, grad norms relative "
              f"{[round(s['grad_norm_rel'], 8) for s in r['steps']]}, params max |diff| "
              f"{r['param_max_abs_diff']:.3g}; median step {r['one_step_s']:.3f} s one device, "
              f"{r['sharded_step_s']:.3f} s sharded ({card})")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"arch": args.arch, "layers": cfg.n_layers, "mesh": args.mesh,
                      "layout": args.layout, "card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
