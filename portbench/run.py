"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints the check's numbers beside their limits as the last lines of
standard error, and one JSON line (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``) as the last
line of standard output. Exits non-zero, printing no result, without the
cards, without the port beside the benchmark, or where a module of JAX or
of the JAX package was loaded.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, leads the import path
sys.path[0] = ROOT
from portbench import use_checkout_caches  # noqa: E402

use_checkout_caches()

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
