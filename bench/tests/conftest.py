"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
repository's root.  The port is imported from ``src``, the benchmark as
the package ``bench``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
