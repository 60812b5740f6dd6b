"""Multi-pod dry-run on meta devices: every (architecture x input shape x mesh)
cell's train / prefill / serve step run once over the production mesh, with
its production layouts, to show it fits and to take the roofline's inputs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape decode_32k --mesh pod1 [--out runs/dryrun_torch] [--layout 2d]

The JAX package's ``repro.launch.dryrun`` on the port. The JAX dry-run lowers
and compiles each step over 512 placeholder host devices and reads XLA's
memory and cost analyses. The port has no compiler; its mesh is
``make_production_mesh(devices=["meta"] * 256 | 512)``, so no card is
needed (as the JAX dry-run needs no TPU), and the step runs once on it in
place of a compile:

* memory, per device: ``argument_bytes`` / ``output_bytes`` are one
  position's blocks of the step's inputs and outputs (the same layout on
  every position); ``alias_bytes`` the inputs updated in place (parameters
  and optimizer state in training, the cache in decode); ``peak_bytes`` the
  run's peak of live bytes over the whole mesh (``cost_model.OpCounter``,
  the arguments included) divided by the positions; ``temp_bytes`` that
  peak less the arguments and the outputs that are not aliased;
* ``cost_raw_whole_program`` and ``collectives_raw``: the full-depth run's
  counts (``cost_model.measure``: FLOPs of the matrix products, bytes
  accessed, the ledger's collectives). XLA undercounts its loops; eager torch
  does not, so these are not undercounted, only slow (a train cell runs for
  minutes on 256 meta positions);
* ``cost_corrected``: ``cost_model.corrected_costs`` (a one-layer program
  and standalone layers, a few programs a cell);
* ``hbm_traffic_model``: ``traffic_model.traffic``, the fused lower bound
  the roofline's memory term uses, as in the JAX package;
* ``roofline``: ``launch.roofline`` with the H100 SXM's constants.

An artifact has the JAX artifacts' keys. The default ``--out`` is
``runs/dryrun_torch``: the committed ``runs/dryrun/*.json`` are the JAX
package's, with TPU v5e constants, and are never written here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config, shapes as shapes_lib
from repro_torch.launch import cost_model
from repro_torch.launch import roofline as rl
from repro_torch.launch import traffic_model
from repro_torch.launch.mesh import make_production_mesh, mesh_tag
from repro_torch.train import sharding


def production_mesh(multi_pod: bool):
    """The (16, 16) or (2, 16, 16) production mesh over meta devices."""
    return make_production_mesh(multi_pod, devices=["meta"] * (512 if multi_pod else 256))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, sharding.Spec):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def held_bytes(tree) -> int:
    """Position 0's bytes of a tree of ``ShardedTensor``s (and tensors,
    which position 0 holds whole): every position's blocks have the same
    shapes."""
    total = 0
    for x in _leaves(tree):
        if isinstance(x, sharding.ShardedTensor):
            total += x.shards[0].numel() * x.shards[0].element_size()
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               correct: bool = True, layout: str = "2d",
               remat: bool | None = None, moe_chunk: int | None = None):
    """Run one (arch, shape, mesh) cell's step once on meta devices; returns
    the artifact dict.

    ``correct=False`` skips the corrected-cost programs (the multi-pod
    pass only needs the run; the roofline table is single-pod).
    """
    cfg = get_config(arch)
    if remat is not None or moe_chunk is not None:
        kw = {}
        if remat is not None:
            kw["remat"] = remat
        if moe_chunk is not None:
            kw["moe_seq_chunk"] = moe_chunk
        cfg = dataclasses.replace(cfg, **kw)
    sh = shapes_lib.SHAPES[shape_name]
    mesh = production_mesh(multi_pod)
    n_chips = mesh.size

    t0 = time.time()
    prog = cost_model.program(cfg, mesh, shape_name, layout)
    arg_bytes = held_bytes(prog.args)
    alias_bytes = held_bytes({k: prog.args[k] for k in prog.donated})
    start = arg_bytes * n_chips        # every position holds blocks of the same shapes
    t_lower = time.time() - t0

    t0 = time.time()
    run = cost_model.measure(prog.run, mesh, start=start)
    t_run = time.time() - t0
    del prog
    out_bytes = held_bytes(run.out)
    peak = run.counter.peak // n_chips
    temp = max(peak - arg_bytes - (out_bytes - alias_bytes), 0)
    raw = run.cost

    t0 = time.time()
    if correct:
        corrected = cost_model.corrected_costs(cfg, mesh, shape_name, layout=layout)
    else:
        corrected = {"total": raw.to_dict(),
                     "note": "raw whole-program numbers (the full-depth run's)"}
    t_correct = time.time() - t0

    tokens_global = sh.batch * (sh.seq if sh.kind != "decode" else 1)
    n_params = cfg.active_param_count()
    model_flops = rl.model_flops_per_chip(sh.kind, n_params, tokens_global, n_chips)
    mesh_axes = {a: mesh.shape[a] for a in mesh.axis_names}
    if layout == "fsdp":  # model axis acts as extra data parallelism
        mesh_axes = {"data": mesh.size, "model": 1}
    tm = traffic_model.traffic(cfg, shape_name, mesh_axes)
    roof = rl.make_roofline(
        flops=corrected["total"]["flops"],
        hbm_bytes=tm["total"],
        coll_bytes=corrected["total"]["coll_bytes"],
        model_flops=model_flops)

    return {
        "arch": arch, "shape": shape_name, "kind": sh.kind,
        "layout": layout,
        "mesh": mesh_tag(mesh), "n_chips": n_chips,
        "seq": sh.seq, "global_batch": sh.batch,
        "params": cfg.param_count(), "active_params": n_params,
        "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "correct_s": round(t_correct, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias_bytes,
            "peak_bytes": peak,
            "total_per_device": arg_bytes + out_bytes + temp - alias_bytes,
        },
        "cost_raw_whole_program": {"flops": raw.flops, "bytes accessed": raw.hbm_bytes,
                                   "transcendentals": run.counter.transcendentals / n_chips},
        "collectives_raw": run.coll.summary(),
        "cost_corrected": corrected,
        "hbm_traffic_model": {k: (float(v) if not isinstance(v, int) else v)
                              for k, v in tm.items()},
        "roofline": roof.to_dict(),
    }


def cells(arch_filter: str, shape_filter: str):
    for arch in ARCHS:
        if arch_filter not in ("all", arch):
            continue
        cfg = get_config(arch)
        for shape_name in shapes_lib.shape_cells(cfg):
            if shape_filter in ("all", shape_name):
                yield arch, shape_name


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-correct", action="store_true",
                    help="skip the corrected-cost programs (multi-pod pass)")
    ap.add_argument("--layout", default="2d", choices=["2d", "fsdp", "serve"])
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation rematerialization")
    ap.add_argument("--moe-chunk", type=int, default=0,
                    help="MoE dispatch window (0 = whole sequence)")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]
    failures = []
    for arch, shape_name in cells(args.arch, args.shape):
        for multi_pod in meshes:
            tag = "2x16x16" if multi_pod else "16x16"
            if args.layout != "2d":
                tag += f"__{args.layout}"
            if args.no_remat:
                tag += "__noremat"
            if args.moe_chunk:
                tag += f"__moechunk{args.moe_chunk}"
            path = os.path.join(args.out, f"{arch}__{shape_name}__{tag}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"skip {path}")
                continue
            print(f"=== {arch} x {shape_name} x {tag}", flush=True)
            try:
                art = lower_cell(arch, shape_name, multi_pod,
                                 correct=not args.no_correct,
                                 layout=args.layout,
                                 remat=False if args.no_remat else None,
                                 moe_chunk=args.moe_chunk or None)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((arch, shape_name, tag, repr(e)))
                print(f"FAILED: {e}\n{traceback.format_exc()}", flush=True)
                continue
            with open(path, "w") as f:
                json.dump(art, f, indent=1)
            m = art["memory"]
            r = art["roofline"]
            print(f"  bytes/dev: args={m['argument_bytes']/2**30:.2f}GiB "
                  f"temp={m['temp_bytes']/2**30:.2f}GiB "
                  f"total={m['total_per_device']/2**30:.2f}GiB", flush=True)
            print(f"  flops/dev={r['flops']:.3e} hbm={r['hbm_bytes']:.3e} "
                  f"coll={r['coll_bytes']:.3e}", flush=True)
            print(f"  roofline: compute={r['compute_s']*1e3:.2f}ms "
                  f"memory={r['memory_s']*1e3:.2f}ms "
                  f"collective={r['collective_s']*1e3:.2f}ms "
                  f"-> {r['bound']}-bound, MFU={r['mfu']*100:.1f}%", flush=True)
            print(f"  walls: placement {art['lower_s']} s, run {art['compile_s']} s, "
                  f"corrected {art['correct_s']} s", flush=True)
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall cells ran OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
