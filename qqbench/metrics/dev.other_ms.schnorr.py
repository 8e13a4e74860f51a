"""dev.other_ms.schnorr: self time of the device signature program
("dev.schnorr_verify", "dev.schnorr_verify.pack" and any other "dev.*"
program, less their waits): the upload, scalar arithmetic, glue; ms a
call."""

from qqbench.program import is_program, self_ms


def read(run):
    return self_ms(run, "verify", ("dev.schnorr_verify",), is_program)
