"""dev.wait_ms.build: self time of every "<program>.wait" span, where the
host blocks on the card for a verdict or a proof's bytes, ms a call."""

from qqbench.program import is_wait, self_ms


def read(run):
    return self_ms(run, "build", (), is_wait)
