"""tx_per_s.verify: transactions of accepted groups per second over the
window of the traced run (a rejected group's time counts, its transactions
do not); the block cell's throughput, read per layer since its run-to-run
spread on the card's shared host is wider than any end-to-end bound allows."""

from qqbench.readers import rate


def read(run):
    return rate(run, "verify")
