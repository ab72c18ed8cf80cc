"""The benchmark's CPU tests: `python -m pytest -q portbench/tests` from the
repository's root (``src`` and the root on the import path)."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
