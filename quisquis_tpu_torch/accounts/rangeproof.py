"""R1CS bit-decomposition range-proof gadget.

Mirrors reference src/accounts/rangeproof.rs:17-127: a shared
constraint system accumulates one 64-bit range gadget per committed value
(n multipliers with a*b = 0, a = 1-b, v = sum b_i 2^i), proven/verified
once via the Bulletproofs R1CS protocol. The PyTorch port's host copy of
the JAX package's module.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..ops import exact as ex
from .transcript import Transcript, SeededRng
from ..bulletproofs.r1cs import (LinearCombination, R1CSProof, R1CSProver,
                                 R1CSVerifier)

L = ex.L


def range_proof_gadget(cs, v_lc: LinearCombination,
                       v_assignment: Optional[int], n: int) -> None:
    """Constrain v in [0, 2^n) (rangeproof.rs:95-127)."""
    exp_2 = 1
    v = v_lc
    for i in range(n):
        if v_assignment is not None:
            bit = (v_assignment >> i) & 1
            a, b, o = cs.allocate_multiplier((1 - bit, bit))
        else:
            a, b, o = cs.allocate_multiplier()
        # a * b = 0: one of (a, b) is zero
        cs.constrain(o)
        # a = 1 - b: both are bits
        cs.constrain(a + (b - LinearCombination.constant_lc(1)))
        # v -= b_i * 2^i
        v = v - b * exp_2
        exp_2 = (exp_2 * 2) % L
    # v == sum b_i 2^i
    cs.constrain(v)


class RangeProofProver:
    """Shared R1CS prover for multiple range proofs (rangeproof.rs:17-51)."""

    def __init__(self, transcript: Transcript, rng: Optional[SeededRng] = None):
        self.prover = R1CSProver(transcript, rng=rng)

    def range_proof_prover(self, val: int, epsilon_blinding: int,
                           n: int = 64) -> bytes:
        if not 0 <= val < (1 << n):
            raise ValueError("value out of range")
        com, var = self.prover.commit(val, epsilon_blinding)
        range_proof_gadget(self.prover, var, val, n)
        return com

    def build_proof(self) -> R1CSProof:
        return self.prover.prove()


class RangeProofVerifier:
    """Shared R1CS verifier for multiple range proofs (rangeproof.rs:57-83)."""

    def __init__(self, transcript: Transcript):
        self.verifier = R1CSVerifier(transcript)

    def range_proof_verifier(self, com: bytes, n: int = 64) -> None:
        var = self.verifier.commit(com)
        range_proof_gadget(self.verifier, var, None, n)

    def verify_proof(self, proof: R1CSProof) -> None:
        self.verifier.verify(proof)
