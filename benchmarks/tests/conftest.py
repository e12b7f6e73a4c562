"""The benchmark's own tests (run with ``python -m pytest benchmarks/tests``
from the root of a checkout): the harness's modules import from the
benchmark's folder and the port from the root."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for path in (BENCH_DIR, BENCH_DIR.parent):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
