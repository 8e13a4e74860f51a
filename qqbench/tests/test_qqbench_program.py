"""The readers of the port's own spans (``program.py`` and the fourteen
per-step metrics) on synthetic runs: the arithmetic, the cases that read
nothing, and that a trace run of each cell lists all seven of its own."""

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
