"""host_ms.schnorr: self time of the service's host steps around the device
program, ms a call: the records joined and cut by numpy (span
"serving.schnorr.decode") and the service's own remainder (span
"serving.schnorr.verify_wire": the call's buffers released)."""

from qqbench.program import self_ms


def read(run):
    return self_ms(run, "verify", ("serving.schnorr.decode",),
                   lambda name: name == "serving.schnorr.verify_wire")
