"""dev.other_ms.shuffle: self time of the device shuffle verifier
("dev.shuffle_verify", "dev.shuffle_verify.pack" and any other "dev.*"
program, less their waits): scalar and field arithmetic, packing, glue; ms a
call."""

from qqbench.program import is_program, self_ms


def read(run):
    return self_ms(run, "shuffle", ("dev.shuffle_verify",), is_program)
