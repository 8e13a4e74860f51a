"""The readers of the port's own spans (``program.py`` and the per-step
metrics) on synthetic runs: the arithmetic, the cases that read nothing,
and that a trace run of each cell lists all seven of its own."""

import pytest

from qqbench.run import Run
from qqbench.spec import Spec, reader
from qqbench.stats import Call, Window

STEPS = ("tx.host_ms", "dev.codec_ms", "dev.transcript_ms", "dev.msm_ms", "dev.wait_ms",
         "dev.other_ms")
CELLS = {"verify": "n9-block32-batched", "build": "n9-4x4-build16-batched"}

#: self seconds over a window of the verify cell's spans, and of the build's
VERIFY = {"serving.verify_wire": 0.01, "serving.decode": 0.2, "tx.verify.replay": 1.0,
          "tx.verify.device": 0.05, "dev.shuffle_verify": 0.4, "dev.range_verify": 0.3,
          "dev.shuffle_verify.pack": 0.1,
          "dev.shuffle_verify.wait": 0.25, "dev.range_verify.wait": 0.15,
          "ops.point.decode": 0.6, "ops.point.encode": 0.1, "ops.strobe": 0.7, "ops.msm": 0.3}
BUILD = {"tx.build.pre_range": 2.0, "shuffle.prove": 1.0, "tx.build.range": 0.01,
         "tx.build.advance": 0.3, "tx.build.post_range": 1.5, "dev.range_prove": 0.9,
         "dev.range_prove.wait": 0.4, "ops.point.encode": 0.2, "ops.strobe": 0.5,
         "ops.msm": 0.6}
#: ms a call: the sums above over 4 answered calls
WANT = {
    "verify": {"tx.host_ms": 300.0, "dev.codec_ms": 175.0, "dev.transcript_ms": 175.0,
               "dev.msm_ms": 75.0, "dev.wait_ms": 100.0, "dev.other_ms": 212.5},
    "build": {"tx.host_ms": 1202.5, "dev.codec_ms": 50.0, "dev.transcript_ms": 125.0,
              "dev.msm_ms": 150.0, "dev.wait_ms": 100.0, "dev.other_ms": 225.0},
}


def run_of(kind, selfs, terms=None, verdicts=(True, False, True, True, None), size=8):
    calls = [Call(start=float(i), end=i + 0.5, item=i, size=size, verdict=v)
             for i, v in enumerate(verdicts)]
    counters = {k + ".self_s": v for k, v in selfs.items()}
    if terms is not None:
        counters["ops.msm.terms"] = terms
    timers = {k: [v] for k, v in selfs.items()}
    return Run(kind=kind, window=Window(calls), setup_s=1.0,
               program={"timers": timers, "counters": counters})


@pytest.mark.parametrize("kind", ["verify", "build"])
def test_the_arithmetic(kind):
    selfs = VERIFY if kind == "verify" else BUILD
    run = run_of(kind, selfs, terms=4096.0)
    got = {s: reader(f"{s}.{kind}")(run) for s in STEPS}
    assert got == pytest.approx(WANT[kind])
    # 4 answered calls of 8 transactions
    assert reader(f"msm.terms_per_tx.{kind}")(run) == pytest.approx(4096 / 32)
    # the six steps cover every span but the service call's own
    outer = selfs.get("serving.verify_wire", 0.0)
    assert sum(got.values()) == pytest.approx(1e3 * (sum(selfs.values()) - outer) / 4)
    # the other kind's readers read nothing here
    other = "build" if kind == "verify" else "verify"
    assert all(reader(f"{s}.{other}")(run) is None for s in STEPS + ("msm.terms_per_tx",))


@pytest.mark.parametrize("kind", ["verify", "build"])
def test_nothing_to_read(kind):
    selfs = VERIFY if kind == "verify" else BUILD
    names = STEPS + ("msm.terms_per_tx",)
    # a program without the spans (the parent of this metric): nothing, and no error
    bare = run_of(kind, {"serving.verify_wire": 1.0})
    bare.program["timers"]["rangeproof.prove"] = [0.1]
    assert all(reader(f"{s}.{kind}")(bare) is None for s in names)
    assert all(reader(f"{s}.{kind}")(Run(kind=kind, window=Window(), setup_s=1.0)) is None
               for s in names)
    # no answered call
    none = run_of(kind, selfs, terms=1.0, verdicts=(None,))
    assert all(reader(f"{s}.{kind}")(none) is None for s in names)
    # a span that a step reads has no observation
    missing = {"tx.host_ms": "tx.verify.replay" if kind == "verify" else "tx.build.advance",
               "dev.codec_ms": "ops.point.encode", "dev.transcript_ms": "ops.strobe",
               "dev.msm_ms": "ops.msm",
               "dev.other_ms": "tx.verify.device" if kind == "verify" else "dev.range_prove"}
    for step, name in missing.items():
        run = run_of(kind, {k: v for k, v in selfs.items() if k != name}, terms=1.0)
        assert reader(f"{step}.{kind}")(run) is None, step
    run = run_of(kind, {k: v for k, v in selfs.items() if not k.endswith(".wait")})
    assert reader(f"dev.wait_ms.{kind}")(run) is None
    assert reader(f"msm.terms_per_tx.{kind}")(run) is None


def test_kept_durations_are_not_read():
    """The readers take the exact self-time sums, not the bounded timers."""
    run = run_of("verify", VERIFY, terms=8.0)
    full = run_of("verify", VERIFY, terms=8.0)
    full.program["timers"] = {k: [0.0] * 8192 for k in VERIFY}
    for s in STEPS + ("msm.terms_per_tx",):
        assert reader(f"{s}.verify")(full) == reader(f"{s}.verify")(run)


def test_a_trace_run_of_each_cell_lists_its_seven():
    spec = Spec.load()
    for kind, cell in CELLS.items():
        traced = {m["name"] for m in spec.metrics_of(spec.workloads[cell], True)}
        mine = {f"{s}.{kind}" for s in STEPS + ("msm.terms_per_tx",)}
        assert mine <= traced
        assert not mine & {m["name"] for m in spec.metrics_of(spec.workloads[cell], False)}
        for other, c in CELLS.items():
            if other != kind:
                assert not mine & {m["name"] for m in spec.metrics_of(spec.workloads[c], True)}


#: self seconds over a window of the shuffle cell's spans, all inside "dev.shuffle_verify"
SHUFFLE = {"dev.shuffle_verify": 0.4, "dev.shuffle_verify.pack": 0.1,
           "dev.shuffle_verify.wait": 0.25, "ops.point.decode": 0.06, "ops.point.encode": 0.02,
           "ops.strobe": 0.7, "ops.msm": 0.3}
SHUFFLE_STEPS = ("host_ms", "dev.codec_ms", "dev.transcript_ms", "dev.msm_ms", "dev.wait_ms",
                 "dev.other_ms")


def shuffle_run(selfs, call_s=0.6, terms=None, host=(0.1, 0.0425)):
    """4 answered calls of 16 proofs, each 0.6 s in the benchmark's call
    span, of which `host` (wire decoding, transcript set-up) in its spans
    of the service's host steps."""
    from qqbench.probes import Spans

    run = run_of("shuffle", selfs, terms=terms, size=16)
    run.spans = Spans(None)
    run.spans.per_call = [{"call": call_s, "wire_decode": host[0],
                           "transcript_setup": host[1]}] * 4
    return run


def test_the_shuffle_steps_split_the_call():
    run = shuffle_run(SHUFFLE, terms=6400.0)
    got = {s: reader(f"{s}.shuffle")(run) for s in SHUFFLE_STEPS}
    assert got == pytest.approx({"host_ms": 600.0 - 457.5, "dev.codec_ms": 20.0,
                                 "dev.transcript_ms": 175.0, "dev.msm_ms": 75.0,
                                 "dev.wait_ms": 62.5, "dev.other_ms": 125.0})
    assert sum(got.values()) == pytest.approx(600.0)   # the call, no overlap and no gap
    assert reader("msm.terms_per_proof.shuffle")(run) == pytest.approx(6400 / 64)
    assert all(reader(f"{s}.verify")(run) is None for s in STEPS)
    # no benchmark span of a host step: the host share reads nothing
    bare = shuffle_run(SHUFFLE)
    bare.spans = None
    assert reader("host_ms.shuffle")(bare) is None
    half = shuffle_run(SHUFFLE)
    half.spans.per_call = [{"call": 0.6, "wire_decode": 0.1}] * 4
    assert reader("host_ms.shuffle")(half) is None
    assert reader("verify_proofs_per_s")(run) == pytest.approx(3 * 16 / 4.5)


def test_a_trace_run_of_the_shuffle_cell_lists_its_own():
    spec = Spec.load()
    cell = spec.workloads["n64-shuffle64-batched"]
    traced = {m["name"] for m in spec.metrics_of(cell, True)}
    mine = {f"{s}.shuffle" for s in SHUFFLE_STEPS} | {
        "msm.terms_per_proof.shuffle", "launches_per_proof.shuffle", "msm_roofline.shuffle",
        "device_idle.shuffle"}
    assert traced == mine
    assert {m["name"] for m in spec.metrics_of(cell, False)} == {"verify_proofs_per_s",
                                                                  "setup_s"}
    for other in CELLS.values():
        assert not mine & {m["name"] for m in spec.metrics_of(spec.workloads[other], True)}


def test_device_ms_per_tx_counts_the_accepted_profiled_calls():
    run = run_of("verify", {})
    run.device = Window([Call(start=0.0, end=1.0, item=0, size=8, verdict=True),
                         Call(start=1.0, end=2.0, item=1, size=8, verdict=False),
                         Call(start=2.0, end=3.0, item=2, size=8, verdict=True)])
    run.device_busy = [0.2, 0.1, 0.3]
    got = reader("verify_device_ms_per_tx")(run)
    assert got == pytest.approx(1e3 * 0.5 / 16)   # the rejected call's busy time is not read
    assert reader("tx_per_s.verify")(run) == pytest.approx(3 * 8 / 4.5)   # the window's rate
    run.kind = "build"                            # another kind of cell reads nothing
    assert reader("verify_device_ms_per_tx")(run) is None
    run.kind = "verify"
    run.device_busy = run.device_busy[:2]        # the busy times and the calls do not pair
    assert reader("verify_device_ms_per_tx")(run) is None
    run.device = None                            # a run with no device segment (--trace 1)
    assert reader("verify_device_ms_per_tx")(run) is None


def test_the_block_cell_bounds_the_device_time_and_traces_its_rate():
    spec = Spec.load()
    cell = spec.workloads["n9-block32-batched"]
    e2e = {m["name"]: m for m in spec.metrics_of(cell, False)}
    assert set(e2e) == {"verify_device_ms_per_tx", "setup_s"}
    assert e2e["verify_device_ms_per_tx"]["source"] == "device_trace"
    assert "tx_per_s.verify" in {m["name"] for m in spec.metrics_of(cell, True)}
    build = spec.workloads["n9-4x4-build16-batched"]
    assert {m["name"] for m in spec.metrics_of(build, False)} == {"build_tx_per_s", "setup_s"}
