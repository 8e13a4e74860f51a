"""dev.transcript_ms.schnorr: self time of the device STROBE transcripts and
their Keccak permutations (span "ops.strobe"), ms a call."""

from qqbench.program import self_ms


def read(run):
    return self_ms(run, "verify", ("ops.strobe",))
