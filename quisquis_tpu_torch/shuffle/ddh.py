"""DDH tuple argument (mirrors reference src/shuffle/ddh.rs:27-142)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from ..ops import exact as ex
from ..accounts.prover import Prover
from ..accounts.verifier import Verifier

L = ex.L


def _enc(p):
    return ex.ristretto_encode(p)


@dataclass
class DDHStatement:
    G_dash: bytes
    H_dash: bytes


@dataclass
class DDHProof:
    challenge: int
    z: int

    @staticmethod
    def create_verify_update_ddh_prove(
        prover: Prover, g_i: Sequence[ex.Point], h_i: Sequence[ex.Point],
        exp_x: Sequence[int], G: ex.Point, H: ex.Point, rho: int,
    ) -> Tuple["DDHProof", "DDHStatement"]:
        prover.new_domain_sep(b"DDHTupleProof")
        rng = prover.prove_rekey_witness_transcript_rng(list(exp_x))
        exp_x_rho = [x * rho % L for x in exp_x]
        G_dash = _enc(ex.pt_msm(exp_x_rho, list(g_i)))
        H_dash = _enc(ex.pt_msm(exp_x_rho, list(h_i)))
        r_scalar = rng.random_scalar()
        g_r = _enc(ex.pt_mul(r_scalar, G))
        h_r = _enc(ex.pt_mul(r_scalar, H))
        prover.allocate_point(b"g", _enc(G))
        prover.allocate_point(b"g_dash", G_dash)
        prover.allocate_point(b"h", _enc(H))
        prover.allocate_point(b"h_dash", H_dash)
        prover.allocate_point(b"gr", g_r)
        prover.allocate_point(b"hr", h_r)
        challenge = prover.get_challenge(b"Challenge")
        z = (r_scalar - challenge * rho) % L
        return DDHProof(challenge, z), DDHStatement(G_dash, H_dash)

    def verify_ddh_proof(self, verifier: Verifier, statement: DDHStatement,
                         G: bytes, H: bytes) -> None:
        verifier.new_domain_sep(b"DDHTupleProof")
        verifier.allocate_point(b"g", G)
        verifier.allocate_point(b"g_dash", statement.G_dash)
        verifier.allocate_point(b"h", H)
        verifier.allocate_point(b"h_dash", statement.H_dash)
        g_r = Verifier.multiscalar_multiplication(
            [self.z, self.challenge], [G, statement.G_dash])
        h_r = Verifier.multiscalar_multiplication(
            [self.z, self.challenge], [H, statement.H_dash])
        if g_r is None or h_r is None:
            raise ValueError("DDH Proof Verify: Failed")
        verifier.allocate_point(b"gr", _enc(g_r))
        verifier.allocate_point(b"hr", _enc(h_r))
        if verifier.get_challenge(b"Challenge") != self.challenge % L:
            raise ValueError("DDH Proof Verify: Failed")
