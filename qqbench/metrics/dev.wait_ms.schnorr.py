"""dev.wait_ms.schnorr: self time of every "<program>.wait" span, where the
host blocks on the card for a verdict, ms a call."""

from qqbench.program import is_wait, self_ms


def read(run):
    return self_ms(run, "verify", (), is_wait)
