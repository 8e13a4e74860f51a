"""tx.host_steps_ms.build: a build call less the span of
RangeProof.prove_batch, mean per call."""

from qqbench.readers import span_ms


def read(run):
    call, prove = span_ms(run, "call"), span_ms(run, "prove_batch")
    if run.kind != "build" or call is None or prove is None:
        return None
    return call - prove
