"""Fixed paths of the benchmark inside its checkout."""

from __future__ import annotations

from pathlib import Path

#: the qqbench package
PKG = Path(__file__).resolve().parent
#: the checkout that holds BENCHMARK.json, qqbench/ and the port
ROOT = PKG.parent


def cache_dir() -> Path:
    """The one directory in which the benchmark keeps what it generates and
    builds: inputs keyed by configuration, seed and generator hash, the
    reference's answers, and the reference's C++ libraries. A fixed path
    inside the checkout (listed in .gitignore), so that only a cell's first
    run in a checkout pays for them."""
    return ROOT / ".qqbench_cache"
