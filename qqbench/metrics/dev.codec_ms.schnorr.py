"""dev.codec_ms.schnorr: self time of the port's point decoder (span
"ops.point.decode", one launch over a call's [B, 3] points), ms a call."""

from qqbench.program import self_ms


def read(run):
    return self_ms(run, "verify", ("ops.point.decode",))
