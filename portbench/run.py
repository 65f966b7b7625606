"""Benchmark of galileo_sdr_sim_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload e1_os.file_b8 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout, on a machine with the cell's CUDA
devices; see portbench/harness/main.py and PERF.md.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, leads the import path
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
