"""The benchmark's own tests: run them from the checkout's root with
``python -m pytest perfbench/tests`` (the repository's suite, under
``tests/``, does not collect them).  Tests marked ``cuda`` run the
benchmark on a card and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
