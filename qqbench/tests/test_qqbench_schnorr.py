"""The signature cell (``schnorr-65535-device``) on the CPU at a small size:
its inputs and the reference's verdicts repeat by seed; a sound run is
correct on the cell's own backend (the device program's plain versions);
and the comparison that decides ``correct`` fails the stand-ins, a verifier
that accepts everything and the reference without its point identity (the
control of this cell: ``control.py`` keys its controls by kind, and this
cell's kind, "verify", is the block's). The card's test (marked ``cuda``):
one call at the cell's size, whose six ``*_ms.schnorr`` steps split the
call within 1%."""

import argparse
import copy
import time

import pytest

from qqbench import gen, procs
from qqbench.entries import verify_schnorr_wire as vs
from qqbench.run import Run, forbidden_modules, run_cell
from qqbench.spec import Spec, reader
from qqbench.stats import Call, Window

SEED = 2 ** 32 + 4099
CELL = "schnorr-65535-device"
SMALL = {"entry": "verify_schnorr_wire", "backend": "device-batched", "signatures": 8,
         "group_size": 4, "tampered": list(vs.TAMPER_KINDS), "tamper_every": 2}
STEPS = ("host_ms", "dev.other_ms", "dev.transcript_ms", "dev.codec_ms", "dev.msm_ms",
         "dev.wait_ms")


@pytest.fixture(scope="module")
def spec():
    s = Spec.load()
    s.traffic = lambda cell: dict(SMALL, name=cell["traffic"])
    return s


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "cache_dir", lambda: tmp_path)
    return tmp_path


def run(spec, factory, seconds):
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=seconds, trace=0)
    try:
        return run_cell(args, spec, spec.workload(CELL), require_card=False,
                        entry_factory=factory)
    finally:
        procs.stop_children()


def test_the_inputs_and_verdicts_repeat_by_seed(spec, fresh_cache, tmp_path_factory):
    config = spec.config(spec.workload(CELL))
    data, made_s = vs.schnorr_inputs(config, SMALL, SEED, workers=2)
    assert made_s > 0 and len(data["records"]) == 8
    assert all(len(r) == 160 for r in data["records"]) and all(data["verdicts"])
    assert sorted(data["tampered"]) == sorted(vs.TAMPER_KINDS)
    assert not any(data["tampered_verdicts"].values())
    gen.cache_dir = lambda: tmp_path_factory.mktemp("other")   # undone by monkeypatch
    again, made_again = vs.schnorr_inputs(config, SMALL, SEED, workers=2)
    assert made_again > 0 and again == data
    other, _ = vs.schnorr_inputs(config, SMALL, SEED + 1, workers=2)
    assert not set(other["records"]) & set(data["records"])
    # the keys are distinct: no term of the MSM coalesces
    assert len({r[:64] for r in data["records"]}) == 8


def test_a_sound_run_is_correct(spec):
    result, compared = run(spec, lambda cls, *a: cls(*a, "cpu"), seconds=2.0)
    assert result["correct"], compared
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert compared["wrong_verdicts"] == (0, 0) and compared["wrong_counts"] == (0, 0)
    assert forbidden_modules() == []


class _Verdicts:
    """``verify_wire`` on a verdict a record, in the service's place."""

    def __init__(self, verdict):
        self.verdict = verdict

    def verify_wire(self, records) -> int:
        if not all(self.verdict(r) for r in records):
            raise ValueError("rejected")
        return len(records)

    def close(self) -> None:
        pass


def accept_all(entry):
    entry.svc = _Verdicts(lambda record: True)


def no_point_check(entry):
    """The reference with the identity s g == R + c h never evaluated: the
    decodes and transcripts run, the MSM's check does not."""
    entry.svc = _Verdicts(lambda record: vs.ref_verify(record, entry.config, point_check=False))


@pytest.mark.parametrize("stand_in", [accept_all, no_point_check])
def test_a_stand_in_is_not_correct(spec, stand_in):
    host = copy.copy(spec)
    host.traffic = lambda cell: dict(spec.traffic(cell), backend="host")

    def factory(cls, *a):
        entry = cls(*a, "cpu")
        entry.svc.close()
        stand_in(entry)
        return entry
    result, compared = run(host, factory, seconds=1.0)
    assert not result["correct"] and compared["wrong_verdicts"][0] > 0, compared


@pytest.mark.cuda
def test_one_call_at_the_cells_size_splits_into_its_six_steps():
    """The six ``*_ms.schnorr`` steps sum to within 1% of the call."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from quisquis_tpu_torch.ops import cuda_build
    from quisquis_tpu_torch.utils.metrics import metrics

    real = Spec.load()
    cell = real.workload(CELL)
    config, mix = real.config(cell), real.traffic(cell)
    mix = dict(mix, signatures=mix["group_size"])       # one group
    inputs, _ = vs.schnorr_inputs(config, mix, SEED)
    cuda_build.load_library()
    entry = vs.Entry(config, mix, inputs, SEED, "cuda")
    try:
        item = (0, None)
        entry.call(item, Call(start=0.0, end=0.0, item=item, size=0))   # warm
        torch.cuda.synchronize()
        metrics.reset()
        call = Call(start=time.perf_counter(), end=0.0, item=item, size=0)
        entry.call(item, call)
        torch.cuda.synchronize()
        call.end = time.perf_counter()
    finally:
        entry.close()
    assert call.verdict is True and call.done == mix["group_size"]
    run_ = Run(kind="verify", window=Window(calls=[call]), setup_s=0.0,
               program={"timers": {}, "counters": dict(metrics.counters)})
    steps = {s: reader(f"{s}.schnorr")(run_) for s in STEPS}
    assert None not in steps.values(), steps
    call_ms = 1e3 * call.seconds
    assert abs(sum(steps.values()) - call_ms) <= 0.01 * call_ms, (steps, call_ms)
    assert metrics.counters["dev.schnorr_verify.lanes"] == mix["group_size"]
    assert reader("msm.terms_per_sig.schnorr")(run_) >= 3
