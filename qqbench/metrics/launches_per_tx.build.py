"""launches_per_tx.build: the host's kernel and graph launches in the traced
segment per transaction answered (profiler runtime events)."""

from qqbench.readers import launches_per_tx


def read(run):
    return launches_per_tx(run, "build")
