"""dev.other_ms.verify: self time of the device layer ("tx.verify.device")
and of the device programs ("dev.*" less their waits): scalar and field
arithmetic, packing, glue; ms a call."""

from qqbench.program import is_program, self_ms


def read(run):
    return self_ms(run, "verify", ("tx.verify.device",), is_program)
