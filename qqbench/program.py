"""The port's own spans (``quisquis_tpu_torch.utils.metrics``) over a run's
window, for the readers of the per-step metrics in ``metrics/``.

``run.program`` holds the port's registry as it stood when the window
closed (``run.py`` resets it when the window opens): ``timers`` (the kept
durations of each span) and ``counters``, among them ``<span>.self_s``,
the exact sum of a span's self time (its duration less that of the spans
nested directly inside it). The self times of the spans under one call add
up to the call's time in the port, so summing them by kind of step splits
the call without overlap. The readers use only these exact sums and the
port's counters, never the bounded ``timers`` sequences, so a sequence that
reached its bound cannot bias them.

A step's time is the sum of its spans' self times over the window divided
by the window's answered calls: ms a call, averaged as ``probes.Spans``
averages the benchmark's own spans.
"""

from __future__ import annotations

SELF = ".self_s"


def self_seconds(run) -> dict:
    """{span name: self seconds summed over the window}."""
    counters = run.program.get("counters", {})
    return {k[:-len(SELF)]: v for k, v in counters.items() if k.endswith(SELF)}


def is_wait(name: str) -> bool:
    """The host blocked on the card: ``<program>.wait``."""
    return name.endswith(".wait")


def is_program(name: str) -> bool:
    """A device program's own span, its waits left out."""
    return name.startswith("dev.") and not is_wait(name)


def self_ms(run, kind: str, required=(), match=None):
    """ms a call of the self times of the spans `required` and of those
    whose name `match` accepts; None in a run of another kind, with no
    answered call, where a required span has no observation, or where no
    span is selected at all."""
    calls = len(run.window.answered())
    if run.kind != kind or not calls:
        return None
    spans = self_seconds(run)
    if any(name not in spans for name in required):
        return None
    chosen = set(required) | {n for n in spans if match is not None and match(n)}
    if not chosen:
        return None
    return 1e3 * sum(spans[n] for n in chosen) / calls


def terms_per_tx(run, kind: str):
    """The terms that the port's MSMs handed the kernels, padding included
    (counter ``ops.msm.terms``), per transaction of the window's answered
    calls."""
    terms = run.program.get("counters", {}).get("ops.msm.terms")
    txs = sum(c.size for c in run.window.answered())
    if run.kind != kind or terms is None or not txs:
        return None
    return terms / txs
