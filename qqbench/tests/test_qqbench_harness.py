"""The harness's run on the CPU, with the port's host backends in the
card's place and the look for a card skipped, at a small size: a sound run
is correct; with the timed path broken underneath, ``correct`` comes out
false for each fault the cells can have; the controls (the reference with
one stated guarantee broken, in the program's place) come out not correct.

One chip: no exchange between chips to leave out. A verify call keeps no
state from call to call, so "a step that returns its state unchanged" is
a build's (the last call's transactions handed back again)."""

import argparse
import copy
import dataclasses

import pytest

from qqbench import procs
from qqbench.control import control_factory
from qqbench.run import forbidden_modules, run_cell
from qqbench.spec import Spec

SEED = 2 ** 32 + 4099
KINDS = ["output_shuffle_E_k_0", "range_proof_ipp_a", "sigma_delta_dleq_zv_0"]
SHUFFLE_KINDS = ["ddh_z", "multiexpo_commit_E_k_0", "product_svp_r_twildle"]
SMALL = {
    "block32": {"entry": "verify_wire", "backend": "host", "workers": 2, "transactions": 4,
                "group_size": 2, "tampered": KINDS, "tamper_every": 2},
    "mempool16": {"entry": "verify_wire", "backend": "merged-host", "workers": 2,
                  "transactions": 4, "group_size": 2, "tampered": KINDS, "tamper_every": 2,
                  "warm_calls": 2},
    "build16": {"entry": "build", "range_backend": "host", "requests_per_call": 2,
                "request_sets": 2},
    "shuffle64": {"entry": "verify_shuffle_wire", "backend": "merged-host", "workers": 2,
                  "proofs": 4, "group_size": 2, "tampered": SHUFFLE_KINDS, "tamper_every": 2},
}
#: the shuffle cell at a small square size: 2 proofs a call over 9 accounts
SMALL_CONFIGS = {"qq-shuffle-8x8-n64": {"anonymity_set_size": 9, "shuffle_rows": 3,
                                        "shuffle_columns": 3}}
VERIFY_CELLS = ["n9-block32-batched", "n9-mempool16-pool", "n64-shuffle64-batched"]
#: the mempool mix on the host pool, kept for a later cell (not in BENCHMARK.json: its
#: host-bound rate spread beyond any bound on the card's shared host, PERF.md section 6)
POOL_CELL = {"name": "n9-mempool16-pool", "config": "qq-tx-1x1-n9", "traffic": "mempool16",
             "chips": 1}


@pytest.fixture(scope="module")
def spec():
    s = Spec.load()
    s.workloads.setdefault(POOL_CELL["name"], POOL_CELL)
    s.traffic = lambda cell: dict(SMALL[cell["traffic"]], name=cell["traffic"])
    config = s.config
    s.config = lambda cell: dict(config(cell), **SMALL_CONFIGS.get(cell["config"], {}))
    return s


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(spec, name, factory, seconds=2.5, trace=0):
    args = argparse.Namespace(workload=name, seed=SEED, seconds=seconds, trace=trace)
    try:
        return run_cell(args, spec, spec.workload(name), require_card=False,
                        entry_factory=factory)
    finally:
        procs.stop_children()


def on_cpu(fault=None):
    """The port's entry on the CPU, with `fault(entry)` breaking it."""
    def factory(cls, config, mix, inputs, seed):
        entry = cls(config, mix, inputs, seed, "cpu")
        if fault is not None:
            fault(entry)
        return entry
    return factory


# ---- faults of a verify call

def accept_all(entry):
    """An answer altered where it is produced: every group accepted."""
    entry.svc.verify_wire = lambda pairs: len(pairs)


def half_the_group(entry):
    """Half of the batch left out: the first half verified, its count returned."""
    real = entry.svc.verify_wire
    entry.svc.verify_wire = lambda pairs: real(pairs[:len(pairs) // 2])


# ---- faults of a build call

def altered_transaction(entry):
    """An answer altered where it is produced: one response of the first
    transaction's delta proof moved by one."""
    real = entry.create

    def create(reqs, **k):
        out = real(reqs, **k)
        tx, proof = out[0]
        zv, zr1, zr2, x = proof.delta_dleq
        out[0] = (tx, dataclasses.replace(proof, delta_dleq=([zv[0] + 1] + zv[1:], zr1, zr2, x)))
        return out
    entry.create = create


def half_the_requests(entry):
    real = entry.create
    entry.create = lambda reqs, **k: real(reqs[:len(reqs) // 2], **k)


def state_unchanged(entry):
    """A step that returns its state unchanged: the first call's
    transactions handed back for every later call."""
    real, first = entry.create, []

    def create(reqs, **k):
        if not first:
            first.append(real(reqs, **k))
        return list(first[0])
    entry.create = create


@pytest.mark.parametrize("name", VERIFY_CELLS + ["n9-4x4-build16-batched"])
def test_a_sound_run_is_correct(spec, name):
    result, compared = run(spec, name, on_cpu())
    assert result["correct"], compared
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(v == 0 for v, _ in compared.values())
    assert "setup_s" in result["metrics"]
    assert forbidden_modules() == []


@pytest.mark.parametrize("fault", [accept_all, half_the_group])
@pytest.mark.parametrize("name", VERIFY_CELLS)
def test_a_broken_verify_is_not_correct(spec, name, fault):
    result, compared = run(spec, name, on_cpu(fault))
    assert not result["correct"], (fault.__name__, compared)


@pytest.mark.parametrize("fault", [altered_transaction, half_the_requests, state_unchanged])
def test_a_broken_build_is_not_correct(spec, fault):
    result, compared = run(spec, "n9-4x4-build16-batched", on_cpu(fault), seconds=4.0)
    assert not result["correct"], (fault.__name__, compared)
    assert compared["wrong_transactions"][0] > 0


def test_a_shuffle_verifier_without_point_checks_is_not_correct(spec, monkeypatch):
    """The cell's own backend, device-batched, on the CPU, with the device
    verifier's one MSM over every point identity read as passed: the
    transcripts and scalar checks run, no point identity is checked. The
    window's first call is the tampering that only a point identity
    catches (a DDH response also fails its challenge, a scalar check)."""
    import torch

    from quisquis_tpu_torch.shuffle import device_verify

    monkeypatch.setattr(device_verify._LaneChecks, "verify_msm",
                        lambda self: torch.tensor(True))
    batched = copy.copy(spec)
    batched.traffic = lambda cell: dict(spec.traffic(cell), backend="device-batched")

    def point_tampering_first(entry):
        entry.kinds = ["multiexpo_commit_E_k_0"]
    result, compared = run(batched, "n64-shuffle64-batched", on_cpu(point_tampering_first),
                           seconds=1.0)
    assert not result["correct"] and compared["wrong_verdicts"][0] > 0, compared


def test_the_port_rejects_each_shuffle_tampering_on_the_device_path(spec):
    """The cell's own backend, device-batched, on the CPU: the honest group
    of two proofs is accepted and each tampered group rejected."""
    from qqbench.entries import VerifyShuffleWire
    from qqbench.stats import Call

    cell = spec.workload("n64-shuffle64-batched")
    config, mix = spec.config(cell), dict(spec.traffic(cell), backend="device-batched")
    inputs, _ = VerifyShuffleWire.inputs(config, mix, SEED)
    entry = VerifyShuffleWire(config, mix, inputs, SEED, "cpu")
    try:
        bad = entry.bad_group
        for kind in [None] + SHUFFLE_KINDS:
            out = Call(start=0.0, end=0.0, item=(bad, kind), size=0)
            entry.call(out.item, out)
            assert out.verdict is (kind is None) and entry.expected(out.item) is (kind is None)
            assert out.done == (2 if kind is None else 0), kind
    finally:
        entry.close()
        procs.stop_children()


def test_an_error_in_a_call_ends_the_window_and_is_not_correct(spec):
    def broken(entry):
        def fail(pairs):
            raise RuntimeError("a worker died")
        entry.svc.verify_wire = fail
    result, compared = run(spec, "n9-block32-batched", on_cpu(broken))
    assert not result["correct"] and compared["errors"][0] == 1


@pytest.mark.parametrize("name,control", [(c, k) for c in VERIFY_CELLS[:2]
                                          for k in ("no-point-checks", "no-sigma-checks")]
                         + [("n64-shuffle64-batched", "no-point-checks"),
                            ("n9-4x4-build16-batched", "range-32")])
def test_the_control_is_not_correct(spec, name, control):
    # long enough for every tampered kind to be sent (the sixth call is the third kind)
    result, compared = run(spec, name, control_factory(control), seconds=6.0)
    assert not result["correct"], compared


def test_each_tampered_kind_comes_in_turn_at_a_fixed_place(spec):
    from qqbench import gen
    from qqbench.entries import VerifyWire

    cell = spec.workload("n9-block32-batched")
    mix = dict(spec.traffic(cell), tamper_every=3)
    inputs, _ = gen.verify_inputs(spec.config(cell), spec.traffic(cell), SEED, workers=2)
    entry = VerifyWire.__new__(VerifyWire)   # no service: only the order is read
    entry.mix, entry.inputs, entry.seed, entry.every = mix, inputs, SEED, 3
    entry.groups = [[0, 1], [2, 3]]
    entry.bad_group, entry.kinds = inputs["tampered_index"] // 2, sorted(inputs["tampered"])
    items = entry.items()
    first = [next(items) for _ in range(12)]
    assert [k for _, k in first[1::3]] == KINDS + KINDS[:1]
    assert all(k is None for i, (_, k) in enumerate(first) if i % 3 != 1)
    honest = [g for g, k in first if k is None]
    assert sorted(honest[:2]) == [0, 1] and sorted(honest[2:4]) == [0, 1]


def test_a_sigma_tampering_is_rejected_even_with_the_sigma_verdicts_ignored(spec):
    """Why the sigma control skips the sigma verifiers whole: with only
    their final challenge comparisons dropped, the tampered response still
    moves the transcript (through the commitments recomputed from it), and
    the range and shuffle checks after it reject the transaction."""
    from qqbench import gen
    from qqbench.control import SIGMA_CHECKS
    from qqbench.ref.accounts.verifier import Verifier

    cell = spec.workload("n9-block32-batched")
    inputs, _ = gen.verify_inputs(spec.config(cell), spec.traffic(cell), SEED, workers=2)
    bad = inputs["tampered"]["sigma_delta_dleq_zv_0"]
    honest = inputs["pairs"][inputs["tampered_index"]]
    saved = {name: getattr(Verifier, name) for name in SIGMA_CHECKS}

    def ignoring(fn):
        def call(*a, **k):
            try:
                fn(*a, **k)
            except ValueError:
                pass
        return staticmethod(call)
    try:
        for name, fn in saved.items():
            setattr(Verifier, name, ignoring(fn))
        assert gen.ref_verify(honest, bytes(32))
        assert not gen.ref_verify(bad, bytes(32))
    finally:
        for name, fn in saved.items():
            setattr(Verifier, name, staticmethod(fn))
    assert not gen.ref_verify(bad, bytes(32))
