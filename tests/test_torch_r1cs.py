"""The port's R1CS proofs and range gadgets (``bulletproofs/r1cs.py``,
``accounts/rangeproof.py``) against the JAX package's host functions, on
the CPU: the same SeededRng seeds give the same proofs field for field, and
they verify on both sides; a wrong statement, a wrong commitment and an
out-of-range value are rejected (mirrors tests/test_r1cs.py). Everything is
exact: equal bytes and equal ints."""

import pytest
import torch

from quisquis_tpu.accounts.rangeproof import (RangeProofProver as JaxRangeProofProver,
                                              RangeProofVerifier as JaxRangeProofVerifier)
from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.bulletproofs.r1cs import R1CSProver as JaxR1CSProver
from quisquis_tpu_torch import interop
from quisquis_tpu_torch.accounts.rangeproof import RangeProofProver, RangeProofVerifier
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.bulletproofs.r1cs import (LinearCombination, R1CSProof, R1CSProver,
                                                  R1CSVerifier)
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.primitives.pedersen import default_pedersen_gens

VALUES = [156774839, 3564435674839, 674839, 67442545356456839]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


def _range_proof(prover_cls, transcript_cls, rng_cls, values, n=64):
    r = rng_cls(seed=b"r1cs-range-%d" % len(values))
    rp = prover_cls(transcript_cls(b"RangeProofTest"), rng=r)
    coms = [rp.range_proof_prover(v, r.random_scalar(), n) for v in values]
    return coms, rp.build_proof()


def _verify(coms, proof, n=64, label=b"RangeProofTest"):
    rv = RangeProofVerifier(Transcript(label))
    for com in coms:
        rv.range_proof_verifier(com, n)
    rv.verify_proof(proof)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_range_gadgets_equal_jax_and_verify(count):
    values = VALUES[:count]
    coms, proof = _range_proof(RangeProofProver, Transcript, SeededRng, values)
    jcoms, jproof = _range_proof(JaxRangeProofProver, JaxTranscript, JaxSeededRng, values)
    assert coms == jcoms
    assert isinstance(interop.host_object_from_jax(jproof), R1CSProof)
    assert interop.host_object_from_jax(jproof) == proof
    assert proof.to_bytes() == jproof.to_bytes()
    _verify(coms, proof)
    _verify(coms, R1CSProof.from_bytes(proof.to_bytes()))
    rv = JaxRangeProofVerifier(JaxTranscript(b"RangeProofTest"))
    for com in coms:
        rv.range_proof_verifier(com)
    rv.verify_proof(jproof)   # the port's bytes are the JAX package's proof


def test_multiplication_statement():
    """Committed a, b with a * b = 391; the statement 392 is rejected."""
    def build(cs, commit):
        va, vb = commit(17), commit(23)
        al, br, o = cs.allocate_multiplier((17, 23))
        cs.constrain(va - al)
        cs.constrain(vb - br)
        return o

    r = SeededRng(seed=b"r1cs-mul")
    prover = R1CSProver(Transcript(b"MulProof"), rng=r)
    coms = []

    def commit_p(v):
        com, var = prover.commit(v, r.random_scalar())
        coms.append(com)
        return var
    o = build(prover, commit_p)
    prover.constrain(o - LinearCombination.constant_lc(391))
    proof = prover.prove()

    jr = JaxSeededRng(seed=b"r1cs-mul")
    jprover = JaxR1CSProver(JaxTranscript(b"MulProof"), rng=jr)
    jva = jprover.commit(17, jr.random_scalar())[1]
    jvb = jprover.commit(23, jr.random_scalar())[1]
    jal, jbr, jo = jprover.allocate_multiplier((17, 23))
    jprover.constrain(jva - jal)
    jprover.constrain(jvb - jbr)
    jprover.constrain(jo - type(jo).constant_lc(391))
    assert jprover.prove().to_bytes() == proof.to_bytes()

    for rhs, ok in ((391, True), (392, False)):
        verifier = R1CSVerifier(Transcript(b"MulProof"))
        it = iter(coms)
        o = build(verifier, lambda _v: verifier.commit(next(it)))
        verifier.constrain(o - LinearCombination.constant_lc(rhs))
        if ok:
            verifier.verify(proof)
        else:
            with pytest.raises(ValueError):
                verifier.verify(proof)


def test_wrong_commitment_rejected():
    r = SeededRng(seed=b"r1cs-bad")
    rp = RangeProofProver(Transcript(b"RangeBad"), rng=r)
    rp.range_proof_prover(12345, r.random_scalar())
    proof = rp.build_proof()
    wrong = ex.ristretto_encode(default_pedersen_gens().commit(12346, 777))
    with pytest.raises(ValueError):
        _verify([wrong], proof, label=b"RangeBad")


def test_out_of_range_value_rejected():
    """300 needs 9 bits: the prover refuses an 8-bit gadget for it, and a
    proof of 8 bits does not verify as one of the wrong value."""
    r = SeededRng(seed=b"r1cs-oob")
    rp = RangeProofProver(Transcript(b"Range8"), rng=r)
    with pytest.raises(ValueError):
        rp.range_proof_prover(300, r.random_scalar(), n=8)
    with pytest.raises(ValueError):
        rp.range_proof_prover(-1, r.random_scalar(), n=8)
    rp = RangeProofProver(Transcript(b"Range8"), rng=r)
    com = rp.range_proof_prover(200, 99, n=8)
    proof = rp.build_proof()
    _verify([com], proof, n=8, label=b"Range8")
    with pytest.raises(ValueError):
        _verify([com], proof, n=9, label=b"Range8")
