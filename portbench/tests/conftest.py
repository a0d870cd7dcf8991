"""Puts the checkout's root on the path, so that ``portbench`` and the
program import as a run imports them."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
