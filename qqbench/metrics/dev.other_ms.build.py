"""dev.other_ms.build: self time of the device range prover ("dev.range_prove"
and any other "dev.*" program, less their waits): scalar and field
arithmetic, packing, glue; ms a call."""

from qqbench.program import is_program, self_ms


def read(run):
    return self_ms(run, "build", ("dev.range_prove",), is_program)
