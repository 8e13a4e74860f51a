"""msm_roofline.shuffle: percent of the MSM kernels' device time that the
bucket-method bound of every profiled MSM accounts for (roofline.py)."""

from qqbench.readers import msm_roofline


def read(run):
    return msm_roofline(run, "shuffle")
