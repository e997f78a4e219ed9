"""Run one cell of the port's benchmark on this machine's card(s):

    python3 hmvbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (the port's package beside ``hmvbench/``).
Prints the card's name and power limit, then, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; last the ``checks``,
each compared number beside its limit, which also close standard error.
Exits non-zero without a result when the card is missing, or when the run
loaded JAX or the JAX package.
"""

import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
# kernel caches at fixed places inside the checkout, so that only a cell's
# first run there builds (the port's own nvcc builds go to build/kernels)
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
os.environ["OMP_NUM_THREADS"] = "1"  # the host's work is launches: no thread pool spinning
sys.path.insert(0, str(CHECKOUT))

from hmvbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
