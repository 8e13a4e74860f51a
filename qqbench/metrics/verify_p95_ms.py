"""verify_p95_ms: the nearest-rank 95th percentile of every group's latency
in the window (host clock, from send to verdict). A per-layer metric of the
services: read in the traced run's window, where the spans are on."""

from qqbench.stats import percentile


def read(run):
    calls = run.window.answered()
    if run.kind != "verify" or not calls:
        return None
    return 1e3 * percentile([c.seconds for c in calls], 95)
