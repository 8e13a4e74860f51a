"""The reader of ``dev.graph_share.shuffle`` on synthetic runs: the share of
the window's device shuffle-verifier runs that replayed captured graphs,
nothing on a port that counts no runs (a parent without graphs) and
nothing in a cell of another kind; and the shuffle cell's traced metrics
are its earlier ten and this one."""

import pytest

from qqbench.spec import Spec, reader
from qqbench.tests.test_qqbench_program import SHUFFLE, run_of

NAME = "dev.graph_share.shuffle"


def test_the_share_of_replayed_runs():
    run = run_of("shuffle", SHUFFLE)
    run.program["counters"].update({"dev.shuffle_verify.runs": 40.0,
                                    "dev.shuffle_verify.graph_captures": 1.0,
                                    "dev.shuffle_verify.graph_replays": 39.0})
    assert reader(NAME)(run) == pytest.approx(97.5)
    run.program["counters"].pop("dev.shuffle_verify.graph_replays")
    assert reader(NAME)(run) == 0.0          # runs counted, none replayed: eager all along


def test_nothing_to_read():
    assert reader(NAME)(run_of("shuffle", SHUFFLE)) is None      # no runs counted
    verify = run_of("verify", SHUFFLE)
    verify.program["counters"].update({"dev.shuffle_verify.runs": 8.0,
                                       "dev.shuffle_verify.graph_replays": 6.0})
    assert reader(NAME)(verify) is None                          # the block's calls


def test_the_shuffle_cell_reports_it_when_traced():
    spec = Spec.load()
    cell = spec.workloads["n64-shuffle64-batched"]
    traced = {m["name"] for m in spec.metrics_of(cell, True)}
    assert traced == {f"{s}.shuffle" for s in (
        "host_ms", "dev.codec_ms", "dev.transcript_ms", "dev.msm_ms", "dev.wait_ms",
        "dev.other_ms", "msm.terms_per_proof", "launches_per_proof", "msm_roofline",
        "device_idle", "dev.graph_share")}
    assert all(NAME not in {m["name"] for m in spec.metrics_of(c, True)}
               for name, c in spec.workloads.items() if name != cell["name"])
