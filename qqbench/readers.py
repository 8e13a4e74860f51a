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


def device_ms_per_tx(run, kind: str):
    """The device's busy milliseconds per transaction (or proof) over the
    accepted calls profiled one by one after the window (``run.device``):
    every kernel, copy and memset of those calls, over every transaction
    they carried."""
    if run.kind != kind or run.device is None or len(run.device_busy) != len(run.device.calls):
        return None
    accepted = [(b, c.size) for b, c in zip(run.device_busy, run.device.calls) if c.verdict]
    items = sum(size for _, size in accepted)
    busy = sum(b for b, _ in accepted)
    return 1e3 * busy / items if items and busy > 0 else None


def launches_per_tx(run, kind: str):
    """The host launches of the traced segment's accepted calls per
    transaction (or proof) they carried. A rejected call is left out: it
    may stop at its first failed check, so its launches depend on where
    its tampering sits, not on the program alone."""
    if run.kind != kind or run.trace is None or run.traced is None:
        return None
    calls = run.traced.calls
    if len(run.trace.call_launches) != len(calls):
        return None
    accepted = [(n, c.size) for n, c in zip(run.trace.call_launches, calls) if c.verdict is True]
    items = sum(size for _, size in accepted)
    return sum(n for n, _ in accepted) / items if items else None


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
