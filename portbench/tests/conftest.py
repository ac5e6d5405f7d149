"""The harness's tests: ``python -m pytest portbench/tests`` from the root
of a checkout.  They run on the CPU at reduced widths; the ones that need
the card carry the ``cuda`` marker and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
