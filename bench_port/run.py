"""Run one cell of the port's benchmark once and print its result line.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from one profiler session over a stretch of the window.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit). It needs a CUDA device and exits non-zero,
printing no result, without one.
"""

import time

T0 = time.perf_counter()     # the process's start, as set-up counts it

import sys                   # noqa: E402
from pathlib import Path     # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
