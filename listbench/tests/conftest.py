"""Puts the repository's root and ``src`` on the path of the listbench
tests, which run from the repository's root:

    python -m pytest listbench/tests
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
