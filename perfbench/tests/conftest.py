"""The benchmark's tests: run from the root of the repository with
``python -m pytest -q perfbench/tests`` (CPU; the ``gpu`` case skips
without a card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
