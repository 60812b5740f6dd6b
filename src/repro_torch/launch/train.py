"""Training driver: data -> train_step -> erasure-coded checkpoints, on one card.

    python -m repro_torch.launch.train --arch qwen3-1.7b [--smoke] [--steps 100]
        [--global-batch 8] [--seq 128] [--lr 3e-4] [--save-every 0]
        [--ckpt-root DIR] [--device-direct] [--data CORPUS] [--compress-grads]
        [--device cuda]

The JAX package's ``repro.launch.train`` on the port, with no mesh: the
whole state lives on one device. What it exercises:

* deterministic step-indexed data (O(1) resume, no iterator state)
* AdamW + warmup/cosine + grad clipping (+ optional int8 grad compression)
* crash recovery: ``restore_latest`` from the hot or the RapidRAID-coded tier
  (a device-direct run decodes its coded steps on the card)
* periodic saves, device-direct (``save_sharded``: the state is packed and
  erasure-coded from its tensors) or through the host (``save``: hot
  replicas, older steps migrating to the coded tier)
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager, place
from repro_torch.configs import get_config
from repro_torch.data import pipeline as data_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import steps


def run_training(cfg, ocfg: adamw.OptConfig, dcfg: data_lib.DataConfig, n_steps: int, *,
                 ckpt: CheckpointManager | None = None, save_every: int = 0,
                 log_every: int = 10, log=print, device=None) -> dict:
    """Train for ``n_steps`` (resuming if a checkpoint exists) on ``device``
    (the card unless the caller says otherwise); returns the logged history,
    the final parameters and optimizer state, and ``step_s``: each step's
    wall on the host clock (a logged step's ends at its metrics' read, which
    waits for the device)."""
    dev = model_lib.resolve_device(device)
    source = data_lib.make_source(dcfg, dev)
    params = model_lib.init(dcfg.seed, cfg, device=dev)
    opt_state = adamw.init_opt(params, ocfg)

    start = 0
    if ckpt is not None:
        like = {"params": params, "opt": opt_state, "step": np.int64(0)}
        step_found, restored = ckpt.restore_latest(like, sharded=ckpt.ccfg.device_direct)
        if step_found is not None:
            log(f"resuming from checkpoint step {step_found} (tier={ckpt.tier(step_found)})")
            params, opt_state = place(restored["params"], dev), place(restored["opt"], dev)
            start = int(restored["step"])

    step_fn = steps.build_train_step(cfg, ocfg)
    history, walls = [], []
    t0 = time.time()
    for step in range(start, n_steps):
        t_step = time.perf_counter()
        batch = data_lib.batch_for(cfg, source, step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            log(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e} ({time.time() - t0:.1f}s)")
        walls.append(time.perf_counter() - t_step)
        if ckpt is not None and save_every and (step + 1) % save_every == 0:
            state = {"params": params, "opt": opt_state, "step": np.int64(step + 1)}
            if ckpt.ccfg.device_direct:
                # pack + erasure-code straight from the tensors: no host blob,
                # no hot replicas
                ckpt.save_sharded(step + 1, state)
            else:
                ckpt.save(step + 1, state)
            log(f"checkpoint saved at step {step + 1} "
                f"(tiers: {[ckpt.tier(s) for s in ckpt.steps()]})")
    return {"history": history, "final_loss": history[-1]["loss"] if history else None,
            "params": params, "opt": opt_state, "step_s": walls}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--ckpt-root", default="")
    ap.add_argument("--device-direct", action="store_true",
                    help="erasure-code checkpoints straight from the state's tensors "
                         "(no host blob, no hot replicas)")
    ap.add_argument("--data", default="", help="binary token corpus path")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    ocfg = adamw.OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                           total_steps=args.steps, state_dtype=cfg.param_dtype,
                           compress_grads=args.compress_grads)
    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq=args.seq,
                               global_batch=args.global_batch, path=args.data or None)
    dev = model_lib.resolve_device(args.device)
    ckpt = None
    if args.ckpt_root:
        ckpt = CheckpointManager(CheckpointConfig(root=args.ckpt_root,
                                                  device_direct=args.device_direct),
                                 device=dev)
    out = run_training(cfg, ocfg, dcfg, args.steps, ckpt=ckpt, save_every=args.save_every,
                       device=dev)
    print(f"done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
