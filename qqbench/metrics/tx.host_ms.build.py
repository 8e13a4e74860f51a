"""tx.host_ms.build: self time of the host steps of a build: sigma and shuffle
proving ("tx.build.pre_range", "shuffle.prove"), the range step's own work
("tx.build.range"), replaying the proofs into the host transcripts
("tx.build.advance") and steps 10-11 ("tx.build.post_range"), ms a call."""

from qqbench.program import self_ms

STEPS = ("tx.build.pre_range", "tx.build.range", "tx.build.advance", "tx.build.post_range",
         "shuffle.prove")


def read(run):
    return self_ms(run, "build", STEPS)
