"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``src/repro_torch``).
It needs a CUDA card and exits with 2, printing no result, without one. The
last line of standard output is the result, a JSON object; the last lines of
standard error are the numbers that decide ``correct``, each beside its
limit.
"""
import time

T_START = time.perf_counter()   # set-up is timed from here, before torch loads

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
