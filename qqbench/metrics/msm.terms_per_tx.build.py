"""msm.terms_per_tx.build: terms the port's MSMs handed the kernels,
padding included (counter "ops.msm.terms"), per transaction."""

from qqbench.program import terms_per_tx


def read(run):
    return terms_per_tx(run, "build")
