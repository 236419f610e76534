"""The CPU tests of the benchmark harness. Run from the repository root:

    python -m pytest -q lingambench/tests

Tests that need the card are marked ``gpu`` and skip without one."""

import os
import sys

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
