"""Pre-warm the RapidRAID tuning cache: ``python -m repro_torch.autotune``.

Runs the full ``repro_torch.core.autotune.prewarm`` search for one code
geometry — ``gf_encode``'s threads a block, the bit-plane / bit-lift
dispatch, the tick kernels' widths, the chain calibration sweep (fitting
the makespan model's compute_rate and tick_overhead), and the pipeline plan
parameters (num_chunks, stagger) — and persists everything to the JSON
tuning cache under ``torch-cuda`` (or ``torch-cpu``) keys, so production
runs under ``RAPIDRAID_TUNE=cached`` (the default) start warm and never
probe. One card holds the whole chain, so every probe runs on the one
device. A cache already warm for the geometry makes zero probes.

Examples::

    python -m repro_torch.autotune                      # (8,5) l=16 defaults
    python -m repro_torch.autotune --n 16 --k 11 --nwords 131072
    RAPIDRAID_TUNE_CACHE=/tmp/t.json python -m repro_torch.autotune --json
    python -m repro_torch.autotune --device cpu         # the plain versions
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.autotune",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="rapidraid",
                    help="code family (default rapidraid)")
    ap.add_argument("--n", type=int, default=8, help="codeword blocks")
    ap.add_argument("--k", type=int, default=5, help="data blocks")
    ap.add_argument("--l", type=int, default=16, choices=(8, 16),
                    help="GF field size")
    ap.add_argument("--seed", type=int, default=0, help="code seed")
    ap.add_argument("--nwords", type=int, default=1 << 14,
                    help="object words per block for the probes")
    ap.add_argument("--b-obj", type=int, default=4,
                    help="batch size for the multi-object probes")
    ap.add_argument("--chunk-counts", default="1,2,4,8,16",
                    help="comma-separated calibration sweep chunk counts")
    ap.add_argument("--device", default="cuda",
                    help="device the probes run on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--json", action="store_true",
                    help="print the full tuning report as JSON")
    return ap


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    # search is the point of the CLI: force it on unless the user pinned a
    # mode explicitly (off would make the whole run a no-op — reject it)
    from repro_torch.core import autotune
    mode = os.environ.get(autotune.TUNE_ENV)
    if mode is None:
        os.environ[autotune.TUNE_ENV] = "search"
    elif autotune.mode() != "search":
        print(f"repro_torch.autotune: {autotune.TUNE_ENV}={mode!r} disables "
              f"searching; unset it or set it to 'search'", file=sys.stderr)
        return 2

    from repro_torch.core import codes

    code = codes.make(args.family, n=args.n, k=args.k, l=args.l, seed=args.seed)
    chunk_counts = tuple(int(c) for c in args.chunk_counts.split(","))
    report = autotune.prewarm(code, nwords=args.nwords, b_obj=args.b_obj,
                              chunk_counts=chunk_counts, device=args.device)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(f"tuning cache: {report['cache']}")
        print(f"backend: {report['backend']}  spec: {report['spec']}")
        print(f"encode_packed block: {report['encode_packed_block']}  "
              f"encode_mxu block: {report['encode_mxu_block']}  "
              f"dispatch: {report['dispatch']}")
        print(f"tick blocks: {report['tick_blocks']}")
        cal = report["calibration"]
        print(f"calibrated compute_rate {cal['compute_rate']:.3g} B/s, "
              f"tick_overhead {cal['tick_overhead']:.3g} s "
              f"(max fit error {cal['max_rel_err']:.1%})")
        print(f"num_chunks: encode={report['num_chunks_encode']} "
              f"encode_many={report['num_chunks_encode_many']} "
              f"stagger={report['stagger']}")
        print(f"probes run: {report['stats']['probes']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
