"""The transaction verifier's device path on the CPU (``device="cpu"``: the
kernels' plain versions), mirroring tests/test_device_transaction.py:
``batch_verify_transactions("device-batched")`` gives the host replay's
verdict on an honest batch and on batches with one tampered transaction,
two of the tamperings read only by the device verifiers. Range proofs of 8
bits keep the device programs small. The verdicts are compared exactly. The
honest device-batched call opens the port's spans of every step, whose self
times add up to the call."""

import dataclasses

import pytest
import torch

from quisquis_tpu_torch import config as qconfig
from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks, DeviceBatchCollector
from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
from quisquis_tpu_torch.transaction import transaction as ptx
from quisquis_tpu_torch.transaction.workloads import benchmark_requests
from quisquis_tpu_torch.utils.metrics import SELF, metrics

N_BITS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def eight_bit_ranges(monkeypatch):
    monkeypatch.setattr(qconfig, "DEFAULT", dataclasses.replace(qconfig.DEFAULT,
                                                                range_bits=N_BITS))


@pytest.fixture(scope="module")
def honest():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qconfig, "DEFAULT", dataclasses.replace(qconfig.DEFAULT, range_bits=N_BITS))
        return ptx.batch_create_transactions(benchmark_requests(b"tv", 2, 1, 9),
                                             range_backend="host")


def _tampered(items, what):
    tx, proof = items[0]
    rep = dataclasses.replace
    if what.startswith("range"):
        blob = bytearray(proof.range_proofs[0].to_bytes())
        blob[130 if what == "range t_x" else -64] ^= 1   # t_x, or the inner product's a
        proof = rep(proof, range_proofs=[RangeProof.from_bytes(bytes(blob))])
    else:
        sp = proof.output_shuffle_proof
        if what == "shuffle c_B":
            sp = rep(sp, c_B=[bytes([sp.c_B[0][0] ^ 1]) + sp.c_B[0][1:]] + sp.c_B[1:])
        else:
            me = sp.multi_exponen_commit
            e_k_0 = [bytes([me.E_k_0[0][0] ^ 1]) + me.E_k_0[0][1:]] + me.E_k_0[1:]
            sp = rep(sp, multi_exponen_commit=rep(me, E_k_0=e_k_0))
        proof = rep(proof, output_shuffle_proof=sp)
    return [(tx, proof)] + items[1:]


#: the spans of a device-batched verify (its sigma checks leave no deferred
#: terms for the device, so no "dev.point_checks")
VERIFY_SPANS = {"tx.verify.replay", "tx.verify.device", "dev.shuffle_verify",
                "dev.shuffle_verify.pack", "dev.shuffle_verify.wait", "dev.range_verify",
                "dev.range_verify.pack", "dev.range_verify.wait",
                "ops.point.decode", "ops.point.encode", "ops.strobe", "ops.msm"}


def check_spans(expected, outer="test.call"):
    """Every expected span recorded; the self times of all spans add up to
    the outer span's duration, of which the steps' spans hold nearly all."""
    spans = {k[:-len(SELF)]: v for k, v in metrics.counters.items() if k.endswith(SELF)}
    assert expected <= set(spans), expected - set(spans)
    (call,) = metrics.timers[outer]
    assert sum(spans.values()) == pytest.approx(call, rel=1e-9)
    assert spans[outer] < 0.02 * call
    assert metrics.counters["ops.msm.terms"] > 0


#: tamperings that only the device verifiers see: the host's advance-only
#: replay appends nothing of them before its last challenge check
DEVICE_ONLY = ("range ipp a", "shuffle E_k_0")


@pytest.mark.parametrize("what", [None, "range t_x", "shuffle c_B", *DEVICE_ONLY])
def test_batch_verify_device_batched_gives_the_host_verdict(honest, what):
    batch = honest if what is None else _tampered(honest, what)
    verdicts = []
    for backend in ("device-batched", "host"):
        metrics.reset()
        try:
            with metrics.span("test.call"):
                ptx.batch_verify_transactions(batch, backend=backend, seed=b"tv-w",
                                              device="cpu")
            verdicts.append(True)
        except ValueError:
            verdicts.append(False)
        if backend == "device-batched" and what is None:
            check_spans(VERIFY_SPANS)
    assert verdicts == [what is None] * 2
    if what in DEVICE_ONLY:   # the host part accepts; the collected proofs fail
        collector = DeviceBatchCollector()
        defer = DeferredPointChecks(b"tv-d")
        for tx, proof in batch:
            ptx.verify_transaction(tx, proof, defer=defer, collector=collector)
        defer.verify(backend="host")
        with pytest.raises(ValueError):
            collector.verify(device="cpu")
