"""The port benchmark's own tests: the harness and the program on the path."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (HERE.parent / "src", HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
