"""verify_proofs_per_s: shuffle proofs of accepted calls per second over the
window (a rejected group's time counts, its proofs do not)."""

from qqbench.readers import rate


def read(run):
    return rate(run, "shuffle")
