"""dev.msm_ms.build: self time of the port's multiscalar multiplications
(span "ops.msm": msm, msm_rows, msm_shared_rows), ms a call."""

from qqbench.program import self_ms


def read(run):
    return self_ms(run, "build", ("ops.msm",))
