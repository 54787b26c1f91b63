"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
root of the checkout (``tests/`` does not collect them)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
