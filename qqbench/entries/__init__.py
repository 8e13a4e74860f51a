"""The entries that a cell's window drives: the system under test.

Each entry is one file, ``qqbench/entries/<entry name>.py``, found by its
name as ``spec.reader`` finds ``qqbench/metrics/<metric>.py``: a mix file's
``entry`` names the file, and the file's ``Entry`` is the entry's class.
Adding an entry is adding a file; nothing here lists them. (A file whose
name starts with ``_`` is no entry.)

An entry class holds, besides ``kind`` (the word its metric readers look
for in ``run.Run.kind``):

- ``inputs(config, mix, seed) -> (inputs, seconds spent making them)``: a
  static method that makes the cell's inputs from the seed with the frozen
  reference, on ``gen.py``'s pool, cache and ``seed_tag``;
- ``install_spans(spans)``: a static method that puts the benchmark's own
  spans and idle-gap labels (``probes.Spans``) around the port's layers in
  a ``--trace 1`` run;
- made as ``Entry(config, mix, inputs, seed, device)``: ``items()`` (the
  loop's items, in order, endlessly), ``call(item, out)`` (one call of the
  port), ``settle(call)`` (what a call keeps for the judge),
  ``judge(calls, config, mix, seed) -> {name: (value, limit)}`` once the
  window has closed, and ``close()``.

Only the entries import the port (``quisquis_tpu_torch``), and only when
they are made or called.
"""

from __future__ import annotations

import importlib

from ..paths import PKG

DIR = PKG / "entries"


def names() -> list:
    """The entries there are: every ``<name>.py`` here but those starting
    with ``_``."""
    return sorted(p.stem for p in DIR.glob("*.py") if not p.stem.startswith("_"))


def load(name: str):
    """The ``Entry`` class of ``qqbench/entries/<name>.py``."""
    if name.startswith("_") or not (DIR / f"{name}.py").exists():
        raise KeyError(f"no entry {name!r} (there are {names()})")
    return importlib.import_module(f"{__name__}.{name}").Entry


def __getattr__(attr: str):
    """An entry's class by its class name (``from qqbench.entries import
    VerifyWire``)."""
    for name in names():
        cls = load(name)
        if cls.__name__ == attr:
            return cls
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")
