"""The arithmetic of a run: calls in the window, rates, percentiles, spreads.

A cell is a closed loop with one client: it sends its next call when the
last one has returned. The window opens when the first measured call is
sent and closes at the end of the first call that completes at or after
``--seconds``, so every call of the window is counted whole and a call
that stalls is inside it.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Call:
    """One call of the loop: host-clock start and end (seconds), the group
    or request set it sent, how many transactions it carried, and what
    came back: ``verdict`` True (accepted), False (rejected with
    ValueError) or None (an error that is no verdict, in ``error``);
    ``done`` is the count the entry returned."""
    start: float
    end: float
    item: int
    size: int
    verdict: Optional[bool] = None
    done: int = 0
    error: str = ""
    output: object = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    """The measured calls, in order, and the span they cover."""
    calls: List[Call] = field(default_factory=list)

    @property
    def start(self) -> float:
        return self.calls[0].start

    @property
    def end(self) -> float:
        return self.calls[-1].end

    @property
    def seconds(self) -> float:
        return self.end - self.start if self.calls else 0.0

    def closed(self, seconds: float) -> bool:
        """Whether the last call completed at or after `seconds` from the
        window's start (then the window closes with it)."""
        return bool(self.calls) and self.end - self.start >= seconds

    def answered(self) -> List[Call]:
        """The calls that came back with a verdict or a result."""
        return [c for c in self.calls if c.verdict is not None]


def rate(window: Window) -> float:
    """Transactions per second over the whole window: every transaction of
    every call that was accepted (a build that returned, a group that
    verified), over the window's span. A rejected group's time is in the
    span and its transactions are not counted: they were not verified."""
    if window.seconds <= 0:
        return float("nan")
    return sum(c.size for c in window.calls if c.verdict is True) / window.seconds


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it."""
    vals = sorted(values)
    if not vals:
        return float("nan")
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


def spread(values) -> float:
    """The distance between the first and third quartiles, as Python's
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
