#!/usr/bin/env python3
"""Benchmark of the PyTorch port on CUDA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2 without a result when the machine lacks the cards the cell asks
for, and 3 when the process has loaded JAX or the JAX package. See
`harness.py`.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
