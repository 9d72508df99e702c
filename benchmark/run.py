"""Runs one cell of the benchmark once (see harness.py):

    python3 benchmark/run.py --workload teapot_256.hard_train_b4 \
        --seed 1 --seconds 10 --trace 0
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root: the program and the benchmark are imported from it.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(started=STARTED))
