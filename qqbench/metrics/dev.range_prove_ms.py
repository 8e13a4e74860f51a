"""dev.range_prove_ms: the span of RangeProof.prove_batch, mean per build."""

from qqbench.readers import span_ms


def read(run):
    return span_ms(run, "prove_batch") if run.kind == "build" else None
