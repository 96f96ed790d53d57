"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the repository.  Tests marked ``cuda`` need the card and skip
without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
