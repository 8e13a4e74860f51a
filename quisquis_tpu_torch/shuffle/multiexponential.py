"""Multi-exponentiation argument for ciphertext and pubkey shuffles.

Mirrors reference src/shuffle/multiexponential.rs:37-917: proves
prod C_i^{a_i} = reencryption * E_m for the ElGamal-commitment and
public-key variants.

The reference hard-codes the E_k diagonal MSMs for 3x3
(multiexponential.rs:691-761, with a dead general version at :771-806);
here the diagonals are computed for any m x n via the offset relation
E_k = sum_i cipher_row[i] ^ a_row[i + k - m + 1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..ops import exact as ex
from ..primitives.keys import RistrettoPublicKey
from ..primitives.elgamal import ElGamalCommitment
from ..primitives.pedersen import VectorPedersenGens, default_pedersen_gens
from ..accounts.accounts import Account
from ..accounts.prover import Prover
from ..accounts.verifier import Verifier
from ..accounts.deferred import assert_identity
from . import vectorutil

L = ex.L


def _enc(p):
    return ex.ristretto_encode(p)


def _dec(b):
    p = ex.ristretto_decode(b)
    if p is None:
        raise ValueError("MultiexponentialProof Verify: Decompression Failed")
    return p


def _rows(flat: Sequence, m: int, n: int) -> List[List]:
    assert len(flat) == m * n
    return [list(flat[i * n:(i + 1) * n]) for i in range(m)]


def create_ek_common(cipher_rows: Sequence[Sequence[ex.Point]],
                     a_rows: Sequence[Sequence[int]]) -> List[ex.Point]:
    """E_k diagonals, k = 0..2m-1: E_k = sum_i row_i ^ a_{i+k-m+1}.

    cipher_rows: m rows of points; a_rows: m+1 rows of scalars (a_0 first).
    """
    m = len(cipher_rows)
    items = []
    for k in range(2 * m):
        scalars: List[int] = []
        points: List[ex.Point] = []
        for i in range(m):
            j = i + k - m + 1
            if 0 <= j <= m:
                scalars.extend(a_rows[j])
                points.extend(cipher_rows[i])
        items.append((scalars, points))
    # all 2m diagonal MSMs in one batch
    return ex.pt_msm_many(items)


def reencrypt_commitment(p: RistrettoPublicKey, rscalar: int,
                         bl_scalar: int) -> ElGamalCommitment:
    return ElGamalCommitment.generate_commitment(p, rscalar, bl_scalar)


@dataclass
class MultiexpoProof:
    c_A_0: bytes
    c_B_k: List[bytes]
    E_k_0: List[bytes]
    E_k_1: List[bytes]
    a_vec: List[int]
    r: int
    b: int
    s: int
    t: int

    # ------------------------------------------------------------------ common

    @staticmethod
    def _initial_message(xpc_gens, pc, rng, m: int, n: int):
        a_0 = [rng.random_scalar() for _ in range(n)]
        r_0 = rng.random_scalar()
        b_vec = [rng.random_scalar() for _ in range(2 * m)]
        s_vec = [rng.random_scalar() for _ in range(2 * m)]
        b_vec[m] = 0
        s_vec[m] = 0
        c_A_0 = _enc(xpc_gens.commit(a_0, r_0))
        cb_k = [_enc(pc.commit(b, s)) for b, s in zip(b_vec, s_vec)]
        return a_0, b_vec, s_vec, c_A_0, cb_k, r_0

    @staticmethod
    def _challenge_response(a_witness_rows, x_exp, a_0, s_dash, b_vec, s_vec, r_0):
        m = len(a_witness_rows)
        cols = [list(c) for c in zip(*a_witness_rows)]
        # note: reference indexes as_columns()[i] over ROWS — square matrices
        ax = [vectorutil.vector_multiply_scalar(cols[i], x_exp[1:m + 1])
              for i in range(len(cols))]
        a_vec = [(a + b) % L for a, b in zip(ax, a_0)]
        rx = vectorutil.vector_multiply_scalar(s_dash, x_exp[1:m + 1])
        r = (r_0 + rx) % L
        bx = vectorutil.vector_multiply_scalar(b_vec, x_exp)
        sx = vectorutil.vector_multiply_scalar(s_vec, x_exp)
        return a_vec, r, bx, sx

    # ------------------------------------------------------------------ prove

    @staticmethod
    def create_multiexponential_elgamal_commit_proof(
        prover: Prover, commit: Sequence[ElGamalCommitment],
        a_witness_rows: Sequence[Sequence[int]], s_dash: Sequence[int],
        xpc_gens: VectorPedersenGens, base_pk: RistrettoPublicKey, rho: int,
    ) -> "MultiexpoProof":
        pc = default_pedersen_gens()
        m = len(a_witness_rows)
        n = len(a_witness_rows[0])
        prover.new_domain_sep(b"MultiExponentialElgamalCommmitmentProof")
        rng = prover.prove_rekey_witness_transcript_rng(
            [x for row in a_witness_rows for x in row])
        a_0, b_vec, s_vec, c_A_0, cb_k, r_0 = MultiexpoProof._initial_message(
            xpc_gens, pc, rng, m, n)
        tau_vec = [rng.random_scalar() for _ in range(2 * m)]
        tau_vec[m] = rho % L

        c_rows = _rows([c.c_point for c in commit], m, n)
        d_rows = _rows([c.d_point for c in commit], m, n)
        a_rows_full = [a_0] + [list(r_) for r_ in a_witness_rows]
        e_k_c = create_ek_common(c_rows, a_rows_full)
        e_k_d = create_ek_common(d_rows, a_rows_full)
        # reencrypt: E_k = Enc_base_pk(b_k; tau_k) + e_k
        E_K_c, E_K_d = [], []
        for e_c, e_d, b, tau in zip(e_k_c, e_k_d, b_vec, tau_vec):
            enc = reencrypt_commitment(base_pk, tau, b)
            E_K_c.append(_enc(ex.pt_add(enc.c_point, e_c)))
            E_K_d.append(_enc(ex.pt_add(enc.d_point, e_d)))

        prover.allocate_point(b"A0Commitment", c_A_0)
        for cbk, ekc, ekd in zip(cb_k, E_K_c, E_K_d):
            prover.allocate_point(b"BKCommitment", cbk)
            prover.allocate_point(b"EK0Commitment", ekc)
            prover.allocate_point(b"EK1Commitment", ekd)
        x = prover.get_challenge(b"xchallenege")
        x_exp = vectorutil.exp_iter(x, 2 * m)
        a_vec, r, bx, sx = MultiexpoProof._challenge_response(
            a_witness_rows, x_exp, a_0, s_dash, b_vec, s_vec, r_0)
        tx = vectorutil.vector_multiply_scalar(tau_vec, x_exp)
        return MultiexpoProof(c_A_0, cb_k, E_K_c, E_K_d, a_vec, r, bx, sx, tx)

    @staticmethod
    def create_multiexponential_pubkey_proof(
        prover: Prover, pks: Sequence[RistrettoPublicKey],
        a_witness_rows: Sequence[Sequence[int]], s_dash: Sequence[int],
        xpc_gens: VectorPedersenGens, base_pk: RistrettoPublicKey,
    ) -> "MultiexpoProof":
        pc = default_pedersen_gens()
        m = len(a_witness_rows)
        n = len(a_witness_rows[0])
        prover.new_domain_sep(b"MultiExponentialPubKeyProof")
        rng = prover.prove_rekey_witness_transcript_rng(
            [x for row in a_witness_rows for x in row])
        a_0, b_vec, s_vec, c_A_0, cb_k, r_0 = MultiexpoProof._initial_message(
            xpc_gens, pc, rng, m, n)
        g_rows = _rows([pk.gr_point for pk in pks], m, n)
        h_rows = _rows([pk.grsk_point for pk in pks], m, n)
        a_rows_full = [a_0] + [list(r_) for r_ in a_witness_rows]
        e_k_g = create_ek_common(g_rows, a_rows_full)
        e_k_h = create_ek_common(h_rows, a_rows_full)
        G = base_pk.gr_point
        H = base_pk.grsk_point
        ek_g = [_enc(ex.pt_add(ex.pt_mul(b, G), e)) for b, e in zip(b_vec, e_k_g)]
        ek_h = [_enc(ex.pt_add(ex.pt_mul(b, H), e)) for b, e in zip(b_vec, e_k_h)]

        prover.allocate_point(b"A0Commitment", c_A_0)
        for cbk, ekg, ekh in zip(cb_k, ek_g, ek_h):
            prover.allocate_point(b"BKCommitment", cbk)
            prover.allocate_point(b"EK0Commitment", ekg)
            prover.allocate_point(b"EK1Commitment", ekh)
        x = prover.get_challenge(b"xchallenege")
        x_exp = vectorutil.exp_iter(x, 2 * m)
        a_vec, r, bx, sx = MultiexpoProof._challenge_response(
            a_witness_rows, x_exp, a_0, s_dash, b_vec, s_vec, r_0)
        return MultiexpoProof(c_A_0, cb_k, ek_g, ek_h, a_vec, r, bx, sx, 0)

    # ------------------------------------------------------------------ verify

    def _verify_scalars(self, c_A: Sequence[bytes], x_exp: Sequence[int],
                        xpc_gens: VectorPedersenGens, m: int,
                        defer=None) -> None:
        pc = default_pedersen_gens()
        n = len(self.a_vec)
        neg = lambda v: (-v) % L  # noqa: E731
        # C_A_0 + Σ x^i·C_A_i − com(a_vec, r) == 0
        assert_identity(
            defer,
            [1] + list(x_exp[1:m + 1]) + [neg(self.r)]
            + [neg(a) for a in self.a_vec],
            [_dec(self.c_A_0)] + [_dec(c) for c in c_A]
            + [xpc_gens.H] + xpc_gens.G_vec[:n],
            "Multi-exponentiation Argument: a Scalar vector Verification Failed")
        # com(b, s) − Σ x^k·C_B_k == 0
        assert_identity(
            defer,
            [self.b, self.s] + [neg(xk) for xk in x_exp],
            [pc.B, pc.B_blinding] + [_dec(c) for c in self.c_B_k],
            "Multi-exponentiation Argument: Scalar b Verification Failed")

    def _ek_check_terms(self, x_exp: Sequence[int], pts: Sequence[ex.Point],
                        e_k: Sequence[bytes], reenc: ex.Point, m: int, n: int):
        """Terms of Σ x^k·E_k − Σ_i x^{m-1-i}·<a_vec, row_i> − reenc == 0."""
        rows = _rows(pts, m, n)
        scalars = list(x_exp)
        points = [_dec(p) for p in e_k]
        for i in range(m):
            scalars.extend((-ai * x_exp[m - 1 - i]) % L for ai in self.a_vec)
            points.extend(rows[i])
        scalars.append(L - 1)
        points.append(reenc)
        return scalars, points

    def verify_multiexponential_elgamal_commit_proof(
        self, verifier: Verifier, c_A: Sequence[bytes],
        updated_accounts: Sequence[Account], accounts: Sequence[Account],
        xpc_gens: VectorPedersenGens, base_pk: RistrettoPublicKey,
        exp_x: Sequence[int], m: int, n: int, defer=None,
    ) -> None:
        if not (len(self.a_vec) == n
                and self.c_B_k[m] == _enc(ex.IDENTITY)):
            raise ValueError(
                "Multi-exponentiation Commitment Argument: Verify com(0,0) == c_B_m Failed")
        c_i = [acc.comm.c_point for acc in accounts]
        d_i = [acc.comm.d_point for acc in accounts]
        # Σ x^i·C_i == E_m (the statement ciphertext aggregate)
        assert_identity(defer, list(exp_x) + [L - 1],
                        c_i + [_dec(self.E_k_0[m])],
                        "Multi-exponentiation Commitment Argument: Verify C == Em Failed")
        assert_identity(defer, list(exp_x) + [L - 1],
                        d_i + [_dec(self.E_k_1[m])],
                        "Multi-exponentiation Commitment Argument: Verify C == Em Failed")
        verifier.new_domain_sep(b"MultiExponentialElgamalCommmitmentProof")
        verifier.allocate_point(b"A0Commitment", self.c_A_0)
        for cbk, ek0, ek1 in zip(self.c_B_k, self.E_k_0, self.E_k_1):
            verifier.allocate_point(b"BKCommitment", cbk)
            verifier.allocate_point(b"EK0Commitment", ek0)
            verifier.allocate_point(b"EK1Commitment", ek1)
        x = verifier.get_challenge(b"xchallenege")
        x_exp = vectorutil.exp_iter(x, 2 * m)
        self._verify_scalars(c_A, x_exp, xpc_gens, m, defer=defer)
        c = [acc.comm.c_point for acc in updated_accounts]
        d = [acc.comm.d_point for acc in updated_accounts]
        c_bb = reencrypt_commitment(base_pk, self.t, self.b)
        msg = "Multi-exponentiation Commitment Argument: E_K Verification Failed"
        assert_identity(
            defer, *self._ek_check_terms(x_exp, c, self.E_k_0,
                                         c_bb.c_point, m, n), msg)
        assert_identity(
            defer, *self._ek_check_terms(x_exp, d, self.E_k_1,
                                         c_bb.d_point, m, n), msg)

    def verify_multiexponential_pubkey_proof(
        self, verifier: Verifier, c_A: Sequence[bytes],
        updated_accounts: Sequence[Account],
        xpc_gens: VectorPedersenGens, base_pk: RistrettoPublicKey,
        pk_GH: RistrettoPublicKey, m: int, n: int, defer=None,
    ) -> None:
        if not (len(self.a_vec) == n
                and self.c_B_k[m] == _enc(ex.IDENTITY)):
            raise ValueError(
                "Multi-exponentiation Pubkey Argument: Verify com(0,0) == c_B_m Failed")
        if not (pk_GH.gr == self.E_k_0[m] and pk_GH.grsk == self.E_k_1[m]):
            raise ValueError(
                "Multi-exponentiation Pubkey Argument: Verify Em == C Failed")
        verifier.new_domain_sep(b"MultiExponentialPubKeyProof")
        verifier.allocate_point(b"A0Commitment", self.c_A_0)
        for cbk, ek0, ek1 in zip(self.c_B_k, self.E_k_0, self.E_k_1):
            verifier.allocate_point(b"BKCommitment", cbk)
            verifier.allocate_point(b"EK0Commitment", ek0)
            verifier.allocate_point(b"EK1Commitment", ek1)
        x = verifier.get_challenge(b"xchallenege")
        x_exp = vectorutil.exp_iter(x, 2 * m)
        self._verify_scalars(c_A, x_exp, xpc_gens, m, defer=defer)
        g = [acc.pk.gr_point for acc in updated_accounts]
        h = [acc.pk.grsk_point for acc in updated_accounts]
        g_bb = ex.pt_mul(self.b, base_pk.gr_point)
        h_bb = ex.pt_mul(self.b, base_pk.grsk_point)
        msg = "Multi-exponentiation Pubkey Argument: E_K Verification Failed"
        assert_identity(
            defer, *self._ek_check_terms(x_exp, g, self.E_k_0, g_bb, m, n), msg)
        assert_identity(
            defer, *self._ek_check_terms(x_exp, h, self.E_k_1, h_bb, m, n), msg)
