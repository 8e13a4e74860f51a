"""Transaction building's device path on the CPU (``device="cpu"``: the
kernels' plain versions), mirroring tests/test_batch_tx.py:
``batch_create_transactions`` with its range proofs on the device prover
equals the ``create_transaction`` loop byte for byte. Range proofs of 8
bits keep the device programs small. Everything is exact: equal bytes and
ints (``workloads.comparable``)."""

import dataclasses

import pytest
import torch

from quisquis_tpu_torch import config as qconfig
from quisquis_tpu_torch.bulletproofs import device_prove as rdp
from quisquis_tpu_torch.transaction import transaction as ptx
from quisquis_tpu_torch.transaction.workloads import benchmark_requests, comparable

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


def _loop(reqs):
    return [ptx.create_transaction(**req) for req in reqs]


def test_batch_create_three_as_a_bucket_of_four_equals_the_loop():
    rdp._PROVER_CACHE.clear()
    built = ptx.batch_create_transactions(benchmark_requests(b"tb-3", 3, 1, 9),
                                          range_backend="device-batched", device="cpu")
    assert [k[:3] for k in rdp._PROVER_CACHE] == [(N_BITS, 2, 4)]
    assert comparable(built) == comparable(_loop(benchmark_requests(b"tb-3", 3, 1, 9)))
    host = ptx.batch_create_transactions(benchmark_requests(b"tb-3", 3, 1, 9),
                                         range_backend="host")
    assert comparable(host) == comparable(built)
    ptx.batch_verify_transactions(built, backend="host", seed=b"tb-check")


def test_batch_create_mixed_widths_equals_the_loop():
    """Two 1 + 1 transactions (m = 2), one of 2 + 2 over 16 accounts (m = 4)
    and one of 3 + 3 (6 values: the per-value host loop): one device bucket
    per width, the odd one on the host."""
    def fresh():
        return (benchmark_requests(b"tb-mix-a", 2, 1, 9) + benchmark_requests(b"tb-mix-b", 1, 2, 16)
                + benchmark_requests(b"tb-mix-c", 1, 3, 16))
    rdp._PROVER_CACHE.clear()
    built = ptx.batch_create_transactions(fresh(), range_backend="device-batched", device="cpu")
    assert sorted(k[:3] for k in rdp._PROVER_CACHE) == [(N_BITS, 2, 2), (N_BITS, 4, 2)]
    assert [len(p.range_proofs) for _, p in built] == [1, 1, 1, 6]
    assert comparable(built) == comparable(_loop(fresh()))
    ptx.batch_verify_transactions(built, backend="host", seed=b"tb-mix-check")
