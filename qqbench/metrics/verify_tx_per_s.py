"""verify_tx_per_s: transactions of accepted groups per second over the window
(a rejected group's time counts, its transactions do not)."""

from qqbench.readers import rate


def read(run):
    return rate(run, "verify")
