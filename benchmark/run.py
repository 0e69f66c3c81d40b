"""The benchmark's entry: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Prints one JSON line last on standard output (the contract's `correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and `checks`: each number compared with its limit, also printed last on
standard error). Fails without printing a result where there is no
CUDA device.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T0))
