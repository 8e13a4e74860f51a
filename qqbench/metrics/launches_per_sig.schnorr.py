"""launches_per_sig.schnorr: the host's kernel and graph launches of the
traced segment's accepted calls per signature they carried (profiler
runtime events, custom kernels checked against the port's counter)."""

from qqbench.readers import launches_per_tx


def read(run):
    return launches_per_tx(run, "verify")
