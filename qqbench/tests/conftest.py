"""The benchmark's tests: the checkout's root on the path (run from anywhere)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
