"""Spans and counters: the port's one tracing system.

The reference has no observability (stray println! only, SURVEY §5). Here a
**span** marks one step of a program on the host's clock::

    from quisquis_tpu_torch.utils.metrics import metrics, span

    with span("dev.range_verify"):        # as a context manager
        ...

    @span("ops.msm")                      # or as a decorator
    def msm(...): ...

    metrics.count("ops.msm.terms", 4096)
    print(metrics.report())

A span records, under its name, its inclusive duration (``time.perf_counter``)
in ``metrics.timers[name]`` and adds its self time (the duration less that
of the spans nested directly inside it on the same thread) to the counter
``metrics.counters[name + ".self_s"]``. So the self times of every span
under one outer span add up to the outer span's duration. Each thread keeps
its own stack of open spans.

A span never waits for the device: where the host blocks on the card, the
blocking is a span of its own (by convention ``<program>.wait``). While a
torch profiler runs, each span is also a ``record_function`` range, so the
steps sit on the profiler's timeline beside the kernels they launch; with no
profiler it opens none, and costs two clock reads, a stack push and pop and
two dictionary updates under a lock.

Memory stays bounded whatever the uptime: ``timers[name]`` keeps the last
:data:`MAX_OBSERVATIONS` durations of a name, while the ``.self_s`` sums and
the other counters are exact over everything recorded since ``reset()``.
"""

from __future__ import annotations

import functools
import json
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Dict

#: the durations kept per span name (the newest): over 4x the most that a
#: 51 s window of the benchmark records of one name on the H100 (~9,300 of
#: "ops.strobe", 380-423 a block; PERF.md §3); at most ~2 MiB a name
MAX_OBSERVATIONS = 1 << 16

#: the suffix of a span's self-time counter
SELF = ".self_s"


def _profiler():
    """torch's autograd profiler module while a profiler runs, else None
    (none runs where torch is not loaded; this module never loads it)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


def _observations() -> deque:
    return deque(maxlen=MAX_OBSERVATIONS)


class Metrics:
    """A registry of counters and span timings."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timers: Dict[str, deque] = defaultdict(_observations)
        self._local = threading.local()
        self._lock = threading.Lock()   # the sums are read-modify-writes

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def span(self, name: str) -> "Span":
        """A span named `name`: ``with metrics.span(name):`` or
        ``@metrics.span(name)``."""
        return Span(self, name)

    def _stack(self) -> list:
        local = self._local
        try:
            return local.stack
        except AttributeError:
            local.stack = []
            return local.stack

    def report(self) -> str:
        out = {"counters": dict(self.counters), "timers": {}}
        for name, vals in self.timers.items():
            if vals:
                out["timers"][name] = {
                    "count": len(vals),
                    "total_s": round(sum(vals), 6),
                    "mean_s": round(sum(vals) / len(vals), 6),
                    "min_s": round(min(vals), 6),
                }
        return json.dumps(out, indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timers.clear()


class Span:
    """One use of a span (see the module's docstring). As a decorator it
    opens a fresh span on every call of the function it wraps."""

    __slots__ = ("metrics", "name", "stack", "child", "t0", "range")

    def __init__(self, metrics: Metrics, name: str):
        self.metrics, self.name = metrics, name

    def __enter__(self) -> "Span":
        self.child = 0.0
        prof = _profiler()
        self.range = None if prof is None else prof.record_function(self.name)
        if self.range is not None:
            self.range.__enter__()
        self.stack = self.metrics._stack()
        self.stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        seconds = time.perf_counter() - self.t0
        m, stack = self.metrics, self.stack
        stack.pop()
        if stack:
            stack[-1].child += seconds
        with m._lock:
            m.timers[self.name].append(seconds)
            m.counters[self.name + SELF] += seconds - self.child
        if self.range is not None:
            self.range.__exit__(*exc)
        return False

    def __call__(self, fn):
        m, name = self.metrics, self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with Span(m, name):
                return fn(*args, **kwargs)

        return spanned


#: process-global metrics registry
metrics = Metrics()
span = metrics.span
