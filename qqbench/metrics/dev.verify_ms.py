"""dev.verify_ms: the spans of DeviceBatchCollector.verify and the deferred
device MSM, mean per block."""

from qqbench.readers import span_ms


def read(run):
    dev = span_ms(run, "device_verify")
    if run.kind != "verify" or dev is None:
        return None
    return dev + (span_ms(run, "device_msm") or 0.0)
