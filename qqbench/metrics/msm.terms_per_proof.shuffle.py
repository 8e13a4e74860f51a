"""msm.terms_per_proof.shuffle: terms the port's MSMs handed the kernels,
padding included (counter "ops.msm.terms"), per proof of the window's
answered calls."""

from qqbench.program import terms_per_tx


def read(run):
    return terms_per_tx(run, "shuffle")   # a shuffle call's items are proofs
