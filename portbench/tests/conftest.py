"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository (the repository's ``testpaths`` leave them out of
the default run). Tests marked ``cuda`` need the card."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
