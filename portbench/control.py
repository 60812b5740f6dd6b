"""The control of ``correct``, and the program's readings beside it.

    python3 portbench/control.py --workload <cell> --seconds <s> --mode control --seeds <n> ...

runs the cell once per seed in one process, at the cell's own size, and
prints one JSON line per run: the mode, the seed, ``correct`` and each
number compared with its limit. ``--mode control`` puts the plain reference
in the program's place, computed in GF(2^8) byte by byte with each
coefficient cut to its low byte, the field below the configuration's
GF(2^16); it has to come out not correct. ``--mode program`` reads the
program on more seeds in one process. The benchmark's own runs never run
the control. Needs a CUDA card, as ``run.py`` does.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--mode", choices=("control", "program"), default="control")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    t = T_START
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t,
                             device=torch.device("cuda", 0), mode=args.mode)
        for line in r["notes"]:
            print(line, file=sys.stderr)
        print(json.dumps({"mode": args.mode, "workload": args.workload, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"]}), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
