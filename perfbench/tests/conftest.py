"""The benchmark's own tests: they import ``perfbench`` from the checkout's
root and never JAX. Run them with ``python -m pytest perfbench/tests -q``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
