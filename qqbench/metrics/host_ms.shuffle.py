"""host_ms.shuffle: the service's host steps before the device verifier, ms a
call: the benchmark's spans around the wire decoding ("wire_decode") and the
transcripts set up for the verifier ("transcript_setup"), each taken only
outside the port's own spans, so the six ``*_ms.shuffle`` split the call
without overlap."""

from qqbench.readers import span_ms


def read(run):
    parts = [span_ms(run, name) for name in ("wire_decode", "transcript_setup")]
    return None if None in parts else sum(parts)
