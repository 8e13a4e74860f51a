"""sigs_per_s.schnorr: signatures of accepted calls per second over the
window of the traced run (a rejected group's time counts, its signatures do
not); the signature cell's host throughput."""

from qqbench.readers import rate


def read(run):
    return rate(run, "verify")   # a signature call's items are signatures
