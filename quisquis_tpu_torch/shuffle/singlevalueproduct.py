"""Single-value product argument.

Mirrors reference src/shuffle/singlevalueproduct.rs:33-256: proves the
committed vector's running product equals a public scalar b. Uses truncated
generator sets VectorPedersenGens(len+1) for the (n-1)-length delta vectors
(singlevalueproduct.rs:115,237).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..ops import exact as ex
from ..primitives.pedersen import VectorPedersenGens, vector_pedersen_gens
from ..accounts.prover import Prover
from ..accounts.verifier import Verifier
from ..accounts.deferred import assert_identity

L = ex.L


def _enc(p):
    return ex.ristretto_encode(p)


def _dec(b):
    p = ex.ristretto_decode(b)
    if p is None:
        raise ValueError("SingleValue Product Proof Verify: Decompression Failed")
    return p


@dataclass
class SVPStatement:
    commitment_a: bytes
    b: int


@dataclass
class SVPProof:
    commitment_d: bytes
    commitment_delta_small: bytes
    commitment_delta_capital: bytes
    a_twildle: List[int]
    b_twildle: List[int]
    r_twildle: int
    s_twildle: int

    @staticmethod
    def create_single_value_argument_proof(
        prover: Prover, xpc_gens: VectorPedersenGens, r: int,
        a_vec: Sequence[int],
    ) -> "SVPProof":
        n = len(a_vec)
        prover.new_domain_sep(b"SingleValueProductProof")
        bvec = []
        prod = 1
        for ai in a_vec:
            prod = prod * ai % L
            bvec.append(prod)
        rng = prover.prove_rekey_witness_transcript_rng(bvec)
        d_vec = [rng.random_scalar() for _ in range(n)]
        rd = rng.random_scalar()
        commit_d = _enc(xpc_gens.commit(d_vec, rd))

        delta_vec = [rng.random_scalar() for _ in range(n)]
        delta_vec[0] = d_vec[0]
        delta_vec[n - 1] = 0
        s_1 = rng.random_scalar()
        s_x = rng.random_scalar()

        delta_lower = [(-delta_vec[i]) * d_vec[i + 1] % L for i in range(n - 1)]
        delta_upper = [(delta_vec[i + 1] - a_vec[i + 1] * delta_vec[i]
                        - bvec[i] * d_vec[i + 1]) % L for i in range(n - 1)]
        xpc_trun = vector_pedersen_gens(len(delta_lower) + 1)
        comit_delta_lower = _enc(xpc_trun.commit(delta_lower, s_1))
        comit_delta_upper = _enc(xpc_trun.commit(delta_upper, s_x))

        prover.allocate_point(b"DeltaSmall", comit_delta_lower)
        prover.allocate_point(b"DeltaCapital", comit_delta_upper)
        prover.allocate_point(b"d", commit_d)
        x = prover.get_challenge(b"challenge")

        a_bar = [(a * x + d) % L for a, d in zip(a_vec, d_vec)]
        b_bar = [(b * x + d) % L for b, d in zip(bvec, delta_vec)]
        r_bar = (r * x + rd) % L
        s_bar = (s_x * x + s_1) % L
        return SVPProof(commit_d, comit_delta_lower, comit_delta_upper,
                        a_bar, b_bar, r_bar, s_bar)

    def verify(self, verifier: Verifier, svparg: SVPStatement,
               xpc_gens: VectorPedersenGens, defer=None) -> None:
        n = len(self.a_twildle)
        if len(self.b_twildle) != n:
            raise ValueError("SingleValue Product Proof Verify: Size check failed")
        if self.a_twildle[0] != self.b_twildle[0]:
            raise ValueError("SingleValue Product Proof Verify: Failed")
        verifier.new_domain_sep(b"SingleValueProductProof")
        verifier.allocate_point(b"DeltaSmall", self.commitment_delta_small)
        verifier.allocate_point(b"DeltaCapital", self.commitment_delta_capital)
        verifier.allocate_point(b"d", self.commitment_d)
        x = verifier.get_challenge(b"challenge")
        if svparg.b * x % L != self.b_twildle[n - 1]:
            raise ValueError("SingleValue Product Proof Verify: Failed")
        neg = lambda v: (-v) % L  # noqa: E731
        # x·C_a + C_d − com(a_bar, r_bar) == 0
        assert_identity(
            defer,
            [x, 1, neg(self.r_twildle)] + [neg(v) for v in self.a_twildle],
            [_dec(svparg.commitment_a), _dec(self.commitment_d), xpc_gens.H]
            + xpc_gens.G_vec[:n],
            "SingleValue Product Proof Verify: Failed")
        comvec = [(self.b_twildle[i + 1] * x
                   - self.b_twildle[i] * self.a_twildle[i + 1]) % L
                  for i in range(n - 1)]
        xpc_trun = vector_pedersen_gens(len(comvec) + 1)
        # x·C_Δ + C_δ − com_trunc(comvec, s_bar) == 0
        assert_identity(
            defer,
            [x, 1, neg(self.s_twildle)] + [neg(v) for v in comvec],
            [_dec(self.commitment_delta_capital),
             _dec(self.commitment_delta_small), xpc_trun.H]
            + xpc_trun.G_vec[:len(comvec)],
            "SingleValue Product Proof Verify: Failed")
