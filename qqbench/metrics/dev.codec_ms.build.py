"""dev.codec_ms.build: self time of the port's point codecs (spans
"ops.point.decode" and "ops.point.encode"), ms a call."""

from qqbench.program import self_ms


def read(run):
    return self_ms(run, "build", ("ops.point.encode",), lambda n: n == "ops.point.decode")
