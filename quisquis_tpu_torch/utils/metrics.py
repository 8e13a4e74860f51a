"""Lightweight metrics/tracing for the framework.

The reference has no observability (stray println! only, SURVEY §5); this
module provides structured counters and timers: per-kernel wall-clock,
op throughput (scalar-muls/s, MSM points/s), and proof sizes.

Usage:
    from quisquis_tpu_torch.utils.metrics import metrics, timed

    with timed("shuffle.prove"):
        ...
    metrics.count("scalar_muls", 8192)
    print(metrics.report())
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timers: Dict[str, list] = defaultdict(list)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        self.timers[name].append(seconds)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def rate(self, counter: str, timer: str) -> float:
        total_t = sum(self.timers.get(timer, [])) or float("nan")
        return self.counters.get(counter, 0.0) / total_t

    def report(self) -> str:
        out = {"counters": dict(self.counters), "timers": {}}
        for name, vals in self.timers.items():
            out["timers"][name] = {
                "count": len(vals),
                "total_s": round(sum(vals), 6),
                "mean_s": round(sum(vals) / len(vals), 6),
                "min_s": round(min(vals), 6),
            }
        return json.dumps(out, indent=2, sort_keys=True)

    def reset(self) -> None:
        self.counters.clear()
        self.timers.clear()


#: process-global metrics registry
metrics = Metrics()


def timed(name: str):
    return metrics.timer(name)


def instrument(name: str, size_counter: str = "", size_of=None):
    """Decorator: record wall-clock under `name` (and optionally a result
    size via `size_of(result)` into `size_counter`) per call."""

    def wrap(fn):
        import functools

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with metrics.timer(name):
                out = fn(*args, **kwargs)
            if size_counter and size_of is not None:
                try:
                    metrics.count(size_counter, size_of(out))
                except Exception:
                    pass
            return out

        return inner

    return wrap
