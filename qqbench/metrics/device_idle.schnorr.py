"""device_idle.schnorr: percent of the traced segment with nothing running on
the device."""

from qqbench.readers import device_idle


def read(run):
    return device_idle(run, "verify")
