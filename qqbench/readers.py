"""Shared arithmetic of the metric readers in ``metrics/``.

A reader is ``read(run) -> float | None`` (``run.Run``); it returns None
where its run has nothing for it to read, and the metric is then left out
of the result line. None of them returns 0 for a share of a roofline.
"""

from __future__ import annotations

from . import stats
from .roofline import msm_bound_s


def rate(run, kind: str):
    """Transactions answered per second over the window, in cells of the
    given kind."""
    if run.kind != kind or not run.window.answered():
        return None
    return stats.rate(run.window)


def launches_per_tx(run, kind: str):
    """The traced segment's host launches per transaction answered."""
    if run.kind != kind or run.trace is None:
        return None
    txs = sum(c.size for c in run.traced.answered())
    return run.trace.launches / txs if txs else None


def msm_roofline(run, kind: str):
    """Percent: the sum of each profiled MSM's bound (``roofline.py``,
    row by row) over the device time of the MSM kernels (every kernel
    whose name holds "msm") in the traced segment."""
    if run.kind != kind or run.trace is None or run.peaks is None:
        return None
    device_s = sum(s for name, s in run.trace.kernel_s.items() if "msm" in name.lower())
    if device_s <= 0 or not run.msm_rows:
        return None
    bound_s = sum(msm_bound_s(n, run.peaks) for rows in run.msm_rows for n in rows)
    return 100.0 * bound_s / device_s


def device_idle(run, kind: str):
    """Percent of the traced segment in which no kernel, copy or memset
    ran on the device."""
    if run.kind != kind or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def span_ms(run, name: str):
    return None if run.spans is None else run.spans.mean_ms(name)


def timer_ms(run, name: str):
    """The mean of one of the port's own timers (utils.metrics) per call
    of the window, in ms."""
    vals = run.program.get("timers", {}).get(name)
    return 1e3 * sum(vals) / len(vals) if vals else None
