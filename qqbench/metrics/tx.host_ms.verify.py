"""tx.host_ms.verify: self time of the host steps of a block: wire decoding
("serving.decode") and the sigma replay on the C++ curve
("tx.verify.replay"), ms a call."""

from qqbench.program import self_ms


def read(run):
    return self_ms(run, "verify", ("serving.decode", "tx.verify.replay"))
