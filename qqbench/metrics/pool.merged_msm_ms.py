"""pool.merged_msm_ms: the merged MSM of a service call on the card (the
port's timer "serving.merged_msm.device"), mean per call."""

from qqbench.readers import timer_ms


def read(run):
    return timer_ms(run, "serving.merged_msm.device")
