"""The port's wire format (``utils/serde.py``) against the JAX package's, on
the CPU: under the same SeededRng seeds the port's objects encode to the
JAX package's bytes, for a sigma proof, a shuffle proof and its entry (m =
3, 9 accounts), a bulletproof transaction and its proof and an R1CS
transaction and its proof (8-bit ranges on both sides, as the port's
transaction tests); the port decodes the JAX-made blobs, re-encodes them to
the same bytes, and they verify; garbage and truncations raise ValueError
(mirrors tests/test_serde.py). Everything is exact: equal bytes."""

import dataclasses

import pytest
import torch

from quisquis_tpu import config as jconfig
from quisquis_tpu.accounts.prover import Prover as JaxProver
from quisquis_tpu.accounts.prover import SigmaProof as JaxSigmaProof
from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.shuffle.shuffle import Shuffle as JaxShuffle
from quisquis_tpu.shuffle.shuffle import ShuffleProof as JaxShuffleProof
from quisquis_tpu.transaction import transaction as jtx
from quisquis_tpu.utils import serde as jserde
from quisquis_tpu_torch import config as qconfig
from quisquis_tpu_torch.accounts.prover import Prover, SigmaProof
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.accounts.verifier import Verifier
from quisquis_tpu_torch.shuffle.shuffle import Shuffle, ShuffleProof
from quisquis_tpu_torch.transaction import transaction as ptx
from quisquis_tpu_torch.utils import serde
from tests.test_torch_transaction import JAX, PORT, request

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


@pytest.fixture(scope="module")
def eight_bit_ranges():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qconfig, "DEFAULT", dataclasses.replace(qconfig.DEFAULT, range_bits=N_BITS))
        mp.setattr(jconfig, "DEFAULT", dataclasses.replace(jconfig.DEFAULT, range_bits=N_BITS))
        yield


def _shuffle(side_classes, tag: bytes):
    """(proof, statement, inputs, outputs) of one shuffle of 9 accounts."""
    acc_cls, pk_cls, sk_cls, rng_cls, _ = side_classes[:5]
    prover_cls, transcript_cls, shuffle_cls, proof_cls = side_classes[5:]
    r = rng_cls(seed=tag)
    accounts = [acc_cls.generate_account(pk_cls.from_secret_key(sk_cls.random(r), r), r)[0]
                for _ in range(9)]
    sh = shuffle_cls.input_shuffle(accounts, rng=r)
    proof, statement = proof_cls.create_shuffle_proof(
        prover_cls(b"Shuffle", transcript_cls(b"ShuffleProof"), rng=r), sh, rng=r)
    return proof, statement, sh.get_inputs_vector(), sh.get_outputs_vector()


PORT_SH = PORT + (Prover, Transcript, Shuffle, ShuffleProof)
JAX_SH = JAX + (JaxProver, JaxTranscript, JaxShuffle, JaxShuffleProof)


@pytest.fixture(scope="module")
def shuffles():
    return _shuffle(PORT_SH, b"serde-sh"), _shuffle(JAX_SH, b"serde-sh")


def test_sigma_bytes_equal_jax_both_ways():
    for port, jax in ((SigmaProof.dlog([1, 2, 3], 42), JaxSigmaProof.dlog([1, 2, 3], 42)),
                      (SigmaProof.dleq([5], [6, 7], [], 9), JaxSigmaProof.dleq([5], [6, 7], [], 9))):
        blob = serde.sigma_to_bytes(port)
        assert blob == jserde.sigma_to_bytes(jax)
        back = serde.sigma_from_bytes(jserde.sigma_to_bytes(jax))
        assert (back.kind, back.fields) == (port.kind, port.fields)
        assert jserde.sigma_from_bytes(blob).fields == jax.fields


def test_shuffle_proof_and_entry_bytes_equal_jax_and_verify(shuffles):
    (p, s, ins, outs), (jp, js, jins, jouts) = shuffles
    blob = serde.shuffle_proof_to_bytes(p, s)
    assert blob == jserde.shuffle_proof_to_bytes(jp, js)
    entry = serde.shuffle_entry_to_bytes(p, s, ins, outs)
    jentry = jserde.shuffle_entry_to_bytes(jp, js, jins, jouts)
    assert entry == jentry
    p2, s2, ins2, outs2 = serde.shuffle_entry_from_bytes(jentry)
    p2.verify(Verifier(b"Shuffle", Transcript(b"ShuffleProof")), s2, ins2, outs2)
    assert serde.shuffle_entry_to_bytes(p2, s2, ins2, outs2) == jentry
    jp3, js3 = jserde.shuffle_proof_from_bytes(blob)
    assert jserde.shuffle_proof_to_bytes(jp3, js3) == blob


@pytest.mark.parametrize("r1cs", [False, True], ids=["bulletproof", "r1cs"])
def test_transaction_bytes_equal_jax_and_verify(eight_bit_ranges, r1cs):
    create = "create_transaction_r1cs" if r1cs else "create_transaction"
    tag = b"serde-tx-%d" % r1cs
    tx, proof = getattr(ptx, create)(**request(PORT, tag, 1))
    jtx_, jproof = getattr(jtx, create)(**request(JAX, tag, 1))
    tx_blob, proof_blob = serde.transaction_to_bytes(tx), serde.transaction_proof_to_bytes(proof)
    jtx_blob = jserde.transaction_to_bytes(jtx_)
    jproof_blob = jserde.transaction_proof_to_bytes(jproof)
    assert tx_blob == jtx_blob
    assert proof_blob == jproof_blob
    tx2 = serde.transaction_from_bytes(jtx_blob)
    proof2 = serde.transaction_proof_from_bytes(jproof_blob)
    assert serde.transaction_to_bytes(tx2) == jtx_blob
    assert serde.transaction_proof_to_bytes(proof2) == jproof_blob
    ptx.verify_transaction_auto(tx2, proof2, backend="host")
    assert jserde.transaction_proof_to_bytes(jserde.transaction_proof_from_bytes(proof_blob)) \
        == proof_blob


def test_garbage_and_truncations_raise_value_error(shuffles):
    (p, s, ins, outs), _ = shuffles
    blob = serde.shuffle_proof_to_bytes(p, s)
    entry = serde.shuffle_entry_to_bytes(p, s, ins, outs)
    for bad in (b"", b"\x00" * 10, b"\xff" * 100, blob[:-1], blob[:len(blob) // 2]):
        with pytest.raises(ValueError):
            serde.shuffle_proof_from_bytes(bad)
    with pytest.raises(ValueError):
        serde.shuffle_proof_from_bytes(blob + b"\x00")
    for bad in (entry[:-1], entry + b"\x00", b"\xff\xff\xff\xff"):
        with pytest.raises(ValueError):
            serde.shuffle_entry_from_bytes(bad)
    for bad in (b"", b"\x01\x00\x00\x00", b"\xff" * 64):
        with pytest.raises(ValueError):
            serde.transaction_from_bytes(bad)
        with pytest.raises(ValueError):
            serde.transaction_proof_from_bytes(bad)
    with pytest.raises(ValueError):
        serde.sigma_from_bytes(b"\x00\xff\xff\xff\xff")
