"""The benchmark's tests import ``bench_port`` and the port from the
checkout's root."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
