"""verify_device_ms_per_tx: the device's busy milliseconds per transaction of
the accepted blocks that a --trace 0 run profiles after its window, each
call alone (the card time a verified transaction takes)."""

from qqbench.readers import device_ms_per_tx


def read(run):
    return device_ms_per_tx(run, "verify")
