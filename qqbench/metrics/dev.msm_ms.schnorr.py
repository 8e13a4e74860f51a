"""dev.msm_ms.schnorr: self time of the port's multiscalar multiplication
(span "ops.msm", one row of three terms a signature), ms a call."""

from qqbench.program import self_ms


def read(run):
    return self_ms(run, "verify", ("ops.msm",))
