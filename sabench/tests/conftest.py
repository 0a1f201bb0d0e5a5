"""Tests of the benchmark, on the CPU at small sizes. Tests marked `cuda`
need a card and skip without one (decided inside each test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
