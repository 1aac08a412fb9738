#!/usr/bin/env python3
"""Run one cell of the benchmark from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

See benchmark/README.md.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# one CPU thread for PyTorch's host ops: the program's host work is
# Python and single-threaded numpy, and idle OpenMP workers that spin
# beside the export slow it and spread the runs
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
