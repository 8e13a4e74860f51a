"""Hadamard product argument (Bayer-thesis style with Lagrange polynomials).

Mirrors reference src/shuffle/hadamard.rs:79-386, generalized from the
hard-coded 3-row case to any m rows: proves A o B = C for committed m x n
matrices, via quotient-polynomial delta commitments and evaluation openings
at a Fiat-Shamir challenge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..ops import exact as ex
from ..primitives.pedersen import VectorPedersenGens
from ..accounts.prover import Prover
from ..accounts.verifier import Verifier
from ..accounts.deferred import assert_identity
from . import polynomial, vectorutil

L = ex.L


def _enc(p):
    return ex.ristretto_encode(p)


@dataclass
class HadamardStatement:
    omega: List[int]  # m interpolation points


@dataclass
class HadamardProof:
    commitment_a_0: bytes
    commitment_b_0: bytes
    commitment_c_0: bytes
    commitment_delta: List[bytes]  # m+1 commitments
    a_bar: List[int]
    b_bar: List[int]
    c_bar: List[int]
    r_bar: int
    s_bar: int
    t_bar: int
    rho_bar: int

    @staticmethod
    def create_hadamard_argument_proof(
        prover: Prover, xpc_gens: VectorPedersenGens,
        a_rows: Sequence[Sequence[int]], b_rows: Sequence[Sequence[int]],
        c_rows: Sequence[Sequence[int]],
        commit_a: Sequence[bytes], commit_b: Sequence[bytes],
        commit_c: Sequence[bytes],
        witness_r: Sequence[int], witness_s: Sequence[int],
        witness_t: Sequence[int],
    ) -> Tuple["HadamardProof", "HadamardStatement"]:
        m = len(a_rows)
        n = len(a_rows[0])
        assert len(commit_a) == len(commit_b) == len(commit_c) == m
        prover.new_domain_sep(b"HadamardProductProof")
        combined = (list(witness_r) + list(witness_s) + list(witness_t) +
                    [x for row in a_rows for x in row] +
                    [x for row in b_rows for x in row] +
                    [x for row in c_rows for x in row])
        rng = prover.prove_rekey_witness_transcript_rng(combined)
        for ca, cb, cc in zip(commit_a, commit_b, commit_c):
            prover.allocate_point(b"c_a", ca)
            prover.allocate_point(b"c_b", cb)
            prover.allocate_point(b"c_c", cc)

        a_0 = [rng.random_scalar() for _ in range(n)]
        b_0 = [rng.random_scalar() for _ in range(n)]
        c_0 = vectorutil.hadamard_product(a_0, b_0)
        r_0 = rng.random_scalar()
        s_0 = rng.random_scalar()
        t_0 = rng.random_scalar()
        c_a_0 = _enc(xpc_gens.commit(a_0, r_0))
        c_b_0 = _enc(xpc_gens.commit(b_0, s_0))
        c_c_0 = _enc(xpc_gens.commit(c_0, t_0))

        omega = [rng.random_scalar() for _ in range(m)]
        l_x_vec = polynomial.create_l_i_x_polynomial(omega)

        a_expr = polynomial.compute_polynomial_expression(l_x_vec, a_rows, a_0)
        b_expr = polynomial.compute_polynomial_expression(l_x_vec, b_rows, b_0)
        c_expr = polynomial.compute_polynomial_expression(l_x_vec, c_rows, c_0)

        # (a.l(X) * b.l(X) - c.l(X)) / l(X), per column
        div_res = [
            (a_expr[j].multiply(b_expr[j]) - c_expr[j]).divide(l_x_vec[0])
            for j in range(n)
        ]
        # delta_i = i-th coefficient across columns
        delta_vec = [[(dr.coefficients[i] if i < len(dr.coefficients) else 0)
                      for dr in div_res] for i in range(m + 1)]

        rho = [rng.random_scalar() for _ in range(m + 1)]
        comit_delta = [_enc(c) for c in xpc_gens.commit_rows(delta_vec, rho)]

        prover.allocate_point(b"c_a_0", c_a_0)
        prover.allocate_point(b"c_b_0", c_b_0)
        prover.allocate_point(b"c_c_0", c_c_0)
        for cd in comit_delta:
            prover.allocate_point(b"c_delta", cd)

        x = prover.get_challenge(b"challenge")
        a_bar = [p.evaluate(x) for p in a_expr]
        b_bar = [p.evaluate(x) for p in b_expr]
        c_bar = [p.evaluate(x) for p in c_expr]
        ev0 = l_x_vec[0].evaluate(x)
        r_bar, s_bar, t_bar = r_0 * ev0 % L, s_0 * ev0 % L, t_0 * ev0 % L
        for i in range(m):
            ev = l_x_vec[i + 1].evaluate(x)
            r_bar = (r_bar + witness_r[i] * ev) % L
            s_bar = (s_bar + witness_s[i] * ev) % L
            t_bar = (t_bar + witness_t[i] * ev) % L
        exp_x = vectorutil.exp_iter(x, m + 1)
        x_i_rho_i = sum(xi * ri for xi, ri in zip(exp_x, rho)) % L
        rho_bar = ev0 * x_i_rho_i % L

        return (HadamardProof(c_a_0, c_b_0, c_c_0, comit_delta, a_bar, b_bar,
                              c_bar, r_bar, s_bar, t_bar, rho_bar),
                HadamardStatement(omega))

    def verify(self, verifier: Verifier, xpc_gens: VectorPedersenGens,
               statement: HadamardStatement,
               commit_a: Sequence[bytes], commit_b: Sequence[bytes],
               commit_c: Sequence[bytes], defer=None) -> None:
        m = len(commit_a)
        if len(set(statement.omega)) != m:
            raise ValueError("Hadamard Proof Verify: Omega values are not unique")
        l_x_vec = polynomial.create_l_i_x_polynomial(statement.omega)
        verifier.new_domain_sep(b"HadamardProductProof")
        for ca, cb, cc in zip(commit_a, commit_b, commit_c):
            verifier.allocate_point(b"c_a", ca)
            verifier.allocate_point(b"c_b", cb)
            verifier.allocate_point(b"c_c", cc)
        verifier.allocate_point(b"c_a_0", self.commitment_a_0)
        verifier.allocate_point(b"c_b_0", self.commitment_b_0)
        verifier.allocate_point(b"c_c_0", self.commitment_c_0)
        for cd in self.commitment_delta:
            verifier.allocate_point(b"c_delta", cd)
        x = verifier.get_challenge(b"challenge")

        # Each check below is expressed as one Σ s_i·P_i == identity MSM so
        # it can either run eagerly or be folded into a cross-proof batch
        # (accounts.deferred); vector-Pedersen commits on the RHS are
        # expanded over the generator points instead of evaluated.
        def _dec(b):
            p = ex.ristretto_decode(b)
            if p is None:
                raise ValueError("HadamardProof Verify: Decompression Failed")
            return p

        l_ev = [l.evaluate(x) for l in l_x_vec]
        n = len(self.a_bar)
        gen_pts = [xpc_gens.H] + xpc_gens.G_vec[:n]

        def recombine_check(c0_bytes, commits, blind_bar, vals_bar, msg):
            # l_0(x)·C_0 + Σ l_i(x)·C_i − com(vals_bar, blind_bar) == 0
            scalars = l_ev[:1 + len(commits)]
            points = [_dec(c0_bytes)] + [_dec(c) for c in commits]
            scalars = scalars + [(-blind_bar) % L] + [(-v) % L for v in vals_bar]
            assert_identity(defer, scalars, points + gen_pts, msg)

        recombine_check(self.commitment_a_0, commit_a, self.r_bar, self.a_bar,
                        "Hadamard Proof Verify: A_bar , B_bar, C_bar check failed")
        recombine_check(self.commitment_b_0, commit_b, self.s_bar, self.b_bar,
                        "Hadamard Proof Verify: A_bar , B_bar, C_bar check failed")
        recombine_check(self.commitment_c_0, commit_c, self.t_bar, self.c_bar,
                        "Hadamard Proof Verify: A_bar , B_bar, C_bar check failed")

        exp_x = vectorutil.exp_iter(x, m + 1)
        ab = vectorutil.hadamard_product(self.a_bar, self.b_bar)
        abc = [(p - q) % L for p, q in zip(ab, self.c_bar)]
        # l_0(x)·Σ x^i·C_delta_i − com(a_bar∘b_bar − c_bar, rho_bar) == 0
        scalars = ([l_ev[0] * xi % L for xi in exp_x]
                   + [(-self.rho_bar) % L] + [(-v) % L for v in abc])
        points = [_dec(c) for c in self.commitment_delta] + gen_pts
        assert_identity(defer, scalars, points,
                        "Hadamard Proof Verify: Delta Commitment check failed")
