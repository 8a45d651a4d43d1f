"""The benchmark's command: one run of one cell on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It prints one JSON object as the last line
of its standard output, and the numbers its check compared, each beside its
limit, as the last lines of its standard error. It exits with a code other
than 0, and prints no result, without enough CUDA devices for the cell, and
when the run loaded JAX, Flax or the JAX package.
"""

import time

T0 = time.perf_counter()  # set-up time counts from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
