"""Training driver: data -> train_step -> erasure-coded checkpoints.

    python -m repro_torch.launch.train --arch qwen3-1.7b [--smoke] [--steps 100]
        [--global-batch 8] [--seq 128] [--lr 3e-4] [--save-every 0]
        [--ckpt-root DIR] [--device-direct] [--data CORPUS] [--compress-grads]
        [--device cuda] [--mesh DATAxMODEL] [--layout 2d|fsdp]

The JAX package's ``repro.launch.train`` on the port. With no mesh the
whole state lives on one device. With ``mesh=`` (a ``DeviceMesh``; on the
command line ``--mesh 2x2`` over ``--device``'s card, or ``cpu``, repeated)
the state is laid out by ``sharding.state_shardings`` as
``ShardedTensor``s, the activation hints are installed for the run, and
each step is ``spmd.build_sharded_train_step``'s: FSDP over the data axes
and tensor parallelism over ``model``, with explicit collectives. What it
exercises:

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
import torch

from repro_torch import hints
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager, place
from repro_torch.configs import get_config
from repro_torch.data import pipeline as data_lib
from repro_torch.launch.mesh import DeviceMesh, make_local_mesh
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import sharding, spmd, steps


def run_training(cfg, ocfg: adamw.OptConfig, dcfg: data_lib.DataConfig, n_steps: int, *,
                 mesh: DeviceMesh | None = None, layout: str = "2d",
                 ckpt: CheckpointManager | None = None, save_every: int = 0,
                 log_every: int = 10, log=print, device=None) -> dict:
    """Train for ``n_steps`` (resuming if a checkpoint exists) on ``device``
    (the card unless the caller says otherwise), or over ``mesh`` in
    ``layout`` (``"2d"``: FSDP over the data axes, tensor parallelism over
    ``model``; ``"fsdp"``: FSDP over every axis). Returns the logged
    history, the final parameters and optimizer state (``ShardedTensor``s
    over a mesh), ``step_s``: each step's wall on the host clock (a logged
    step's ends at its metrics' read, which waits for the device), and over
    a mesh ``collectives``: the ledger of the last step
    (``spmd.Collective`` records)."""
    if mesh is not None:
        if device is not None:
            raise ValueError("run_training: pass either mesh or device, not both")
        with hints.hints_installed({}):     # the run's hints, the caller's after it
            sharding.set_activation_hints(mesh, batch=dcfg.global_batch, layout=layout)
            return _run(cfg, ocfg, dcfg, n_steps, mesh, layout, ckpt, save_every, log_every,
                        log, None)
    return _run(cfg, ocfg, dcfg, n_steps, None, layout, ckpt, save_every, log_every, log,
                device)


def _run(cfg, ocfg, dcfg, n_steps, mesh, layout, ckpt, save_every, log_every, log, device):
    dev = model_lib.resolve_device(device if mesh is None else mesh.flat[0])
    if mesh is not None:
        for d in mesh.flat:   # every position on a device that exists
            model_lib.resolve_device(d)
    source = data_lib.make_source(dcfg, dev)
    params = model_lib.init(dcfg.seed, cfg, device=dev)
    opt_state = adamw.init_opt(params, ocfg)
    like = {"params": params, "opt": opt_state, "step": np.int64(0)}
    target = dev if mesh is None else \
        sharding.state_shardings(cfg, mesh, like, ocfg, layout)

    start = 0
    if ckpt is not None:
        direct = ckpt.ccfg.device_direct
        kw = {"mesh": mesh} if direct and mesh is not None else {}
        step_found, restored = ckpt.restore_latest(like, sharded=direct, **kw)
        if step_found is not None:
            log(f"resuming from checkpoint step {step_found} (tier={ckpt.tier(step_found)})")
            params = place(restored["params"], _sub(target, "params"))
            opt_state = place(restored["opt"], _sub(target, "opt"))
            start = int(restored["step"])
    if mesh is not None and start == 0:
        params = place(params, target["params"])
        opt_state = place(opt_state, target["opt"])
    del like

    step_fn = steps.build_train_step(cfg, ocfg) if mesh is None else \
        spmd.build_sharded_train_step(cfg, ocfg, mesh, layout)
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
                # pack + erasure-code straight from the tensors (each block
                # read where it lives): no host blob, no hot replicas
                ckpt.save_sharded(step + 1, state, **({} if mesh is None else {"mesh": mesh}))
            else:
                ckpt.save(step + 1, _whole(state))
            log(f"checkpoint saved at step {step + 1} "
                f"(tiers: {[ckpt.tier(s) for s in ckpt.steps()]})")
    out = {"history": history, "final_loss": history[-1]["loss"] if history else None,
           "params": params, "opt": opt_state, "step_s": walls}
    if mesh is not None:
        out["collectives"] = list(step_fn.ledger.records)
    return out


def _sub(target, key: str):
    """The placement of one part of the state: the device, or its subtree."""
    return target if isinstance(target, torch.device) else target[key]


def _whole(tree):
    """A state with each ``ShardedTensor`` assembled (the host save's input)."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return tree.full() if isinstance(tree, sharding.ShardedTensor) else tree


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
    ap.add_argument("--mesh", default="",
                    help="DATAxMODEL positions on --device (e.g. 2x2); empty: no mesh")
    ap.add_argument("--layout", default="2d", choices=("2d", "fsdp"))
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
    where = {"device": dev}
    if args.mesh:
        data, model = (int(x) for x in args.mesh.split("x"))
        where = {"mesh": make_local_mesh(data, model, devices=[dev] * (data * model)),
                 "layout": args.layout}
    out = run_training(cfg, ocfg, dcfg, args.steps, ckpt=ckpt, save_every=args.save_every,
                       **where)
    print(f"done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
