"""The port's serving layer (``serving.py``) on its host backends, on the
CPU (mirrors tests/test_serving.py): VerificationService on "host" and
"merged-host" and ShuffleVerificationService on "merged-host", with two
worker processes and one pool per service for the whole module, accept
honest wire batches; a tampered transaction or shuffle proof and a
truncated blob are rejected with the failing chunk named; and
ProvingService(workers=2) builds, byte for byte, what the JAX package's
``_build_chunk`` builds in this process on the same chunks and seeds.
Transactions carry 64-bit range proofs: the workers verify them at the
default configuration, which a monkeypatch here would not reach."""

import dataclasses
import hashlib

import pytest
import torch

from quisquis_tpu import serving as jserving
from quisquis_tpu_torch import serving
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.prover import Prover
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from quisquis_tpu_torch.shuffle.shuffle import Shuffle, ShuffleProof
from quisquis_tpu_torch.transaction import batch_create_transactions
from quisquis_tpu_torch.transaction.workloads import benchmark_requests
from quisquis_tpu_torch.utils import serde

WORKERS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def wire_pairs():
    items = batch_create_transactions(benchmark_requests(b"serving", 4, 1, 9),
                                      range_backend="host")
    return [serving.serialize_transaction(tx, proof) for tx, proof in items]


@pytest.fixture(scope="module")
def services():
    svcs = {b: serving.VerificationService(workers=WORKERS, seed=b"svc", backend=b)
            for b in ("host", "merged-host")}
    svcs["shuffle"] = serving.ShuffleVerificationService(workers=WORKERS, seed=b"svc",
                                                         backend="merged-host")
    yield svcs
    for s in svcs.values():
        s.close()


def _sigma_tampered(pair):
    """The delta DLEQ's first response + 1: the eager sigma replay fails in
    the worker."""
    tx, proof = serde.transaction_from_bytes(pair[0]), serde.transaction_proof_from_bytes(pair[1])
    zv, zr1, zr2, x = proof.delta_dleq
    proof = dataclasses.replace(proof, delta_dleq=([zv[0] + 1] + zv[1:], zr1, zr2, x))
    return serving.serialize_transaction(tx, proof)


def _range_tampered(pair):
    """One byte of the range proof's inner-product a: only a deferred check
    reads it."""
    from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
    tx, proof = serde.transaction_from_bytes(pair[0]), serde.transaction_proof_from_bytes(pair[1])
    blob = bytearray(proof.range_proofs[0].to_bytes())
    blob[-64] ^= 1
    proof = dataclasses.replace(proof, range_proofs=[RangeProof.from_bytes(bytes(blob))])
    return serving.serialize_transaction(tx, proof)


@pytest.mark.parametrize("backend", ["host", "merged-host"])
def test_verification_service_accepts_and_rejects_by_chunk(services, wire_pairs, backend):
    svc = services[backend]
    assert svc.verify_wire(wire_pairs) == len(wire_pairs)
    assert svc.verify_wire([]) == 0
    # chunks are pairs[i::2]: index 1 lies in chunk 1, index 2 in chunk 0
    bad = list(wire_pairs)
    bad[1] = _sigma_tampered(bad[1])
    with pytest.raises(ValueError, match="chunk 1"):
        svc.verify_wire(bad)
    bad = list(wire_pairs)
    bad[2] = (bad[2][0], bad[2][1][:-7])
    with pytest.raises(ValueError, match="chunk 0: truncated"):
        svc.verify_wire(bad)
    bad = list(wire_pairs)
    bad[3] = _range_tampered(bad[3])
    # "host": the worker's own MSM names its chunk; "merged-host": the
    # parent's one merged MSM fails
    with pytest.raises(ValueError, match="chunk 1" if backend == "host" else "Batched"):
        svc.verify_wire(bad)


def test_shuffle_service_merged_host_accepts_and_rejects_by_chunk(services):
    r = SeededRng(seed=b"serving-shuffle")
    accounts = [Account.generate_account(
        RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(r), r), r)[0]
        for _ in range(9)]
    blobs = []
    for _ in range(3):
        sh = Shuffle.input_shuffle(accounts, rng=r)
        proof, statement = ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=r), sh, rng=r)
        blobs.append(serde.shuffle_entry_to_bytes(proof, statement, sh.get_inputs_vector(),
                                                  sh.get_outputs_vector()))
    svc = services["shuffle"]
    assert svc.verify_wire(blobs) == 3
    p, s, ins, outs = serde.shuffle_entry_from_bytes(blobs[1])
    p = dataclasses.replace(p, ddh_proof=dataclasses.replace(p.ddh_proof, z=p.ddh_proof.z + 1))
    with pytest.raises(ValueError, match="chunk 1"):
        svc.verify_wire([blobs[0], serde.shuffle_entry_to_bytes(p, s, ins, outs), blobs[2]])
    with pytest.raises(ValueError, match="chunk 0: truncated"):
        svc.verify_wire([blobs[0][:-1], blobs[1], blobs[2]])
    with pytest.raises(ValueError, match="collect-mode only"):
        serving.ShuffleVerificationService(backend="host")


def _build_requests(count: int):
    r = SeededRng(seed=b"serving-build")
    reqs = []
    for i in range(count):
        sk = RistrettoSecretKey.random(r)
        acc, _ = Account.generate_account(RistrettoPublicKey.from_secret_key(sk, r), r)
        acc = Account.update_account(acc, 10 + i, r.random_scalar(), r.random_scalar())
        rec = RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(r), r)
        reqs.append((acc.as_bytes(), sk.as_bytes(), 5, rec.as_bytes(), 10 + i - 5))
    return reqs


def test_proving_service_equals_jax_build_chunk_replay(services):
    reqs = _build_requests(3)
    with serving.ProvingService(workers=WORKERS, seed=b"pp") as pp:
        pairs = pp.build([serving.BuildRequest(*q) for q in reqs])
    assert len(pairs) == 3
    # the JAX package's chunk entry, in this process, on the same chunks
    # (requests i::2) and chunk seeds, un-interleaved
    want = [None] * 3
    for i in range(WORKERS):
        seed = hashlib.sha512(b"pp" + b"build" + i.to_bytes(8, "little")).digest()[:32]
        want[i::WORKERS] = jserving._build_chunk(
            [jserving.BuildRequest(*q) for q in reqs[i::WORKERS]], seed)
    assert pairs == want
    assert services["host"].verify_wire(pairs) == 3
