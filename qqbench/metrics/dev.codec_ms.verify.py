"""dev.codec_ms.verify: self time of the port's point codecs (spans
"ops.point.decode" and "ops.point.encode"), ms a call."""

from qqbench.program import self_ms


def read(run):
    return self_ms(run, "verify", ("ops.point.decode", "ops.point.encode"))
