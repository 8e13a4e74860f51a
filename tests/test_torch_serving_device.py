"""The serving layer's device backends on the CPU (``device="cpu"``: the
kernels' plain versions), mirroring tests/test_serving.py's device cases:
VerificationService on "device" (the workers' exported terms in one merged
MSM on the device path) and "device-batched" (the batched transaction
verifiers), ShuffleVerificationService on both, and RangeProvingService on
"device-batched" byte for byte equal to "host". The "device" services'
workers verify at the default 64-bit ranges (a monkeypatch here does not
reach them); the in-process paths run at 8 bits to keep the device programs
small. Verdicts and bytes are compared exactly."""

import dataclasses

import pytest
import torch

from quisquis_tpu_torch import config as qconfig
from quisquis_tpu_torch import serving
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.prover import Prover
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from quisquis_tpu_torch.shuffle.shuffle import Shuffle, ShuffleProof
from quisquis_tpu_torch.transaction import batch_create_transactions
from quisquis_tpu_torch.transaction.workloads import benchmark_requests
from quisquis_tpu_torch.utils import serde

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


@pytest.fixture
def eight_bit_ranges(monkeypatch):
    monkeypatch.setattr(qconfig, "DEFAULT", dataclasses.replace(qconfig.DEFAULT,
                                                                range_bits=N_BITS))


def _wire(tag: bytes, count: int):
    items = batch_create_transactions(benchmark_requests(tag, count, 1, 9), range_backend="host")
    return [serving.serialize_transaction(tx, proof) for tx, proof in items]


def test_verification_service_device_merged_msm():
    pairs = _wire(b"serving-dev", 2)
    with serving.VerificationService(workers=2, seed=b"dev", backend="device",
                                     device="cpu") as svc:
        assert svc.verify_wire(pairs) == 2
        tx, proof = serde.transaction_from_bytes(pairs[1][0]), \
            serde.transaction_proof_from_bytes(pairs[1][1])
        blob = bytearray(proof.range_proofs[0].to_bytes())
        blob[-64] ^= 1   # the inner product's a: only the merged MSM reads it
        proof = dataclasses.replace(proof, range_proofs=[RangeProof.from_bytes(bytes(blob))])
        with pytest.raises(ValueError, match="Batched"):
            svc.verify_wire([pairs[0], serving.serialize_transaction(tx, proof)])


def test_verification_service_device_batched(eight_bit_ranges):
    pairs = _wire(b"serving-dev-batched", 2)
    with serving.VerificationService(workers=1, seed=b"dev", backend="device-batched",
                                     device="cpu") as svc:
        assert svc.verify_wire(pairs) == 2


@pytest.mark.parametrize("backend", ["device", "device-batched"])
def test_shuffle_service_device_backends(backend):
    r = SeededRng(seed=b"serving-dev-shuffle")
    accounts = [Account.generate_account(
        RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(r), r), r)[0]
        for _ in range(4)]
    blobs = []
    for _ in range(2):
        sh = Shuffle.input_shuffle(accounts, rng=r)
        proof, statement = ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=r), sh, rng=r)
        blobs.append(serde.shuffle_entry_to_bytes(proof, statement, sh.get_inputs_vector(),
                                                  sh.get_outputs_vector()))
    with serving.ShuffleVerificationService(workers=2, seed=b"dev", backend=backend,
                                            device="cpu") as svc:
        assert svc.verify_wire(blobs) == 2


def test_range_proving_service_device_batched_equals_host(eight_bit_ranges):
    rng = SeededRng(seed=b"serving-range")
    requests = [([int.from_bytes(rng.fill_bytes(1), "little") for _ in range(2)],
                 [rng.random_scalar() for _ in range(2)]) for _ in range(2)]
    host = serving.RangeProvingService(n_bits=N_BITS, backend="host", seed=b"rp")
    dev = serving.RangeProvingService(n_bits=N_BITS, backend="device-batched", seed=b"rp",
                                      device="cpu")
    got, want = dev.prove(requests), host.prove(requests)
    assert [(p.to_bytes(), V) for p, V in got] == [(p.to_bytes(), V) for p, V in want]
    for proof, commitments in got:
        proof.verify_multiple(Transcript(b"RangeProof"), commitments, N_BITS)
    with pytest.raises(ValueError, match="unknown proving backend"):
        serving.RangeProvingService(backend="device")
