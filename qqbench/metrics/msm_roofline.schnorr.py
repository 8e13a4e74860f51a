"""msm_roofline.schnorr: percent of the MSM kernels' device time that the
bucket-method bound of every profiled MSM accounts for (roofline.py): here
one row of 65,535 terms a call."""

from qqbench.readers import msm_roofline


def read(run):
    return msm_roofline(run, "verify")
