"""msm.terms_per_sig.schnorr: terms the port's MSMs handed the kernels,
padding included (counter "ops.msm.terms"), per signature of the window's
answered calls."""

from qqbench.program import terms_per_tx


def read(run):
    return terms_per_tx(run, "verify")   # a signature call's items are signatures
