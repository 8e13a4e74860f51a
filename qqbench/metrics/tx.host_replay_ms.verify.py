"""tx.host_replay_ms.verify: a block's call less the spans of
DeviceBatchCollector.verify and the deferred device MSM, mean per call."""

from qqbench.readers import span_ms


def read(run):
    call, dev = span_ms(run, "call"), span_ms(run, "device_verify")
    if run.kind != "verify" or call is None or dev is None:
        return None
    return call - dev - (span_ms(run, "device_msm") or 0.0)
