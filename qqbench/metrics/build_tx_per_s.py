"""build_tx_per_s: transactions built per second over the window."""

from qqbench.readers import rate


def read(run):
    return rate(run, "build")
