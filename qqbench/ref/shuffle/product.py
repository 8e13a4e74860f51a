"""Product argument: MultiHadamard + Zero argument + single-value product.

Mirrors reference src/shuffle/product.rs:32-792, generalized from the
hard-coded 3x3 case to any square m x m witness (m >= 3 for the
multi-hadamard chain; the 64-account config uses m = 8).

Matrices are lists of rows; the witness enters in *column-major* semantics
exactly as the reference ("witness in column major order", product.rs:112).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..ops import exact as ex
from ..primitives.pedersen import VectorPedersenGens, default_pedersen_gens
from ..accounts.prover import Prover
from ..accounts.verifier import Verifier
from ..accounts.deferred import assert_identity
from .singlevalueproduct import SVPProof, SVPStatement
from . import vectorutil

L = ex.L


def _enc(p):
    return ex.ristretto_encode(p)


def _dec(b):
    p = ex.ristretto_decode(b)
    if p is None:
        raise ValueError("Product Proof Verify: Decompression Failed")
    return p


def columns(matrix_rows: Sequence[Sequence[int]]) -> List[List[int]]:
    return [list(col) for col in zip(*matrix_rows)]


@dataclass
class ZeroStatement:
    c_A: List[bytes]


@dataclass
class ZeroProof:
    c_A_0: bytes
    c_B_m: bytes
    c_D: List[bytes]
    a_vec: List[int]
    b_vec: List[int]
    r: int
    s: int
    t: int

    @staticmethod
    def create_zero_argument_proof(
        prover: Prover, a_cols: Sequence[Sequence[int]],
        b_cols: Sequence[Sequence[int]],
        xpc_gens: VectorPedersenGens,
        r_vec: Sequence[int], s_vec: List[int], y: int,
    ) -> "ZeroProof":
        """a_cols/b_cols: m columns each of length n; proves
        sum_i a_col_i * b_col_i = 0 under the y-bilinear map."""
        pc = default_pedersen_gens()
        m = len(a_cols)
        n = len(a_cols[0])
        prover.new_domain_sep(b"ZeroArgumentProof")
        flat = [x for col in columns(a_cols) for x in col]  # row-major of A
        rng = prover.prove_rekey_witness_transcript_rng(flat)
        a_0 = [rng.random_scalar() for _ in range(n)]
        b_m = [rng.random_scalar() for _ in range(n)]
        r_0 = rng.random_scalar()
        s_m = rng.random_scalar()
        c_a_0 = _enc(xpc_gens.commit(a_0, r_0))
        c_b_m = _enc(xpc_gens.commit(b_m, s_m))

        full_a_cols = [a_0] + [list(c) for c in a_cols]        # m+1 columns
        full_b_cols = [list(c) for c in b_cols] + [b_m]        # m+1 columns

        dv = bilinearmap(full_a_cols, full_b_cols, y, m)

        t = [rng.random_scalar() for _ in range(2 * m + 1)]
        t[m + 1] = 0
        c_D = [_enc(c) for c in pc.commit_many(dv, t)]

        prover.allocate_point(b"A0Commitment", c_a_0)
        prover.allocate_point(b"BmCommitment", c_b_m)
        for cd in c_D:
            prover.allocate_point(b"DCommitment", cd)
        x = prover.get_challenge(b"challenge")

        x_exp = vectorutil.exp_iter(x, 2 * m + 1)      # x^0..x^2m
        x_exp_m = x_exp[:m + 1]                        # x^0..x^m
        x_m_j = list(reversed(x_exp_m))                # x^m..x^0

        a_bar = [sum(full_a_cols[i][j] * x_exp_m[i] for i in range(m + 1)) % L
                 for j in range(n)]
        b_bar = [sum(full_b_cols[i][j] * x_m_j[i] for i in range(m + 1)) % L
                 for j in range(n)]

        r_ext = [r_0] + list(r_vec[1:m]) + [0]
        s_vec = list(s_vec) + [s_m]
        r_new = vectorutil.vector_multiply_scalar(r_ext, x_exp_m)
        s_new = vectorutil.vector_multiply_scalar(s_vec, x_m_j)
        t_new = vectorutil.vector_multiply_scalar(t, x_exp)
        return ZeroProof(c_a_0, c_b_m, c_D, a_bar, b_bar, r_new, s_new, t_new)

    def verify(self, verifier: Verifier, c_A: Sequence[bytes],
               xpc_gens: VectorPedersenGens, c_B: Sequence[ex.Point],
               chal_y: int, defer=None) -> None:
        pc = default_pedersen_gens()
        m = len(c_A)
        n = len(self.a_vec)
        if not (len(self.c_D) == 2 * m + 1 and len(self.b_vec) == n):
            raise ValueError("Zero Argument Proof Verify: Size check failed")
        # c_D[m+1] must be com(0,0) == identity (byte compare, constant)
        if self.c_D[m + 1] != ex.ristretto_encode(ex.IDENTITY):
            raise ValueError("Zero Argument Proof Verify: c_d_(m+1) == com(0,0) Failed")
        verifier.new_domain_sep(b"ZeroArgumentProof")
        verifier.allocate_point(b"A0Commitment", self.c_A_0)
        verifier.allocate_point(b"BmCommitment", self.c_B_m)
        for cd in self.c_D:
            verifier.allocate_point(b"DCommitment", cd)
        x = verifier.get_challenge(b"challenge")
        x_exp = vectorutil.exp_iter(x, 2 * m + 1)
        x_m_1 = x_exp[1:m + 1]
        gen_pts = [xpc_gens.H] + xpc_gens.G_vec[:n]
        neg = lambda v: (-v) % L  # noqa: E731

        # com(a_bar, r) − C_A_0 − Σ x^i·C_A_i == 0
        assert_identity(
            defer,
            [self.r] + list(self.a_vec) + [neg(1)] + [neg(xi) for xi in x_m_1],
            gen_pts + [_dec(self.c_A_0)] + [_dec(c) for c in c_A],
            "Zero Argument Proof Verify: com(a_bar, r) verification check Failed")

        # com(b_bar, s) − Σ x^{m-i}·C_B_i − C_B_m == 0
        assert_identity(
            defer,
            [self.s] + list(self.b_vec)
            + [neg(xi) for xi in reversed(x_m_1)] + [neg(1)],
            gen_pts + list(c_B) + [_dec(self.c_B_m)],
            "Zero Argument Proof Verify: com(b_bar, s) verification check Failed")

        y_i = vectorutil.exp_iter(chal_y, n, skip=1)
        a_bar_b_bar = single_bilinearmap(self.a_vec, self.b_vec, y_i)
        # com(a_bar·b_bar, t) − Σ x^k·C_D_k == 0 (plain Pedersen gens)
        assert_identity(
            defer,
            [a_bar_b_bar, self.t] + [neg(xi) for xi in x_exp],
            [pc.B, pc.B_blinding] + [_dec(c) for c in self.c_D],
            "Zero Argument Proof Verify: com(a_bar * b_bar, t) verification check Failed")


def bilinearmap(a_cols: Sequence[Sequence[int]], b_cols: Sequence[Sequence[int]],
                y_chal: int, m: int) -> List[int]:
    """d_k = sum over (i,j) with j == m-k+i of <a_i, b_j>_y, k = 0..2m."""
    n = len(a_cols[0])
    y_i = vectorutil.exp_iter(y_chal, n, skip=1)
    dvec = []
    for k in range(2 * m + 1):
        total = 0
        for i in range(m + 1):
            j = m - k + i
            if 0 <= j <= m:
                total = (total + single_bilinearmap(a_cols[i], b_cols[j], y_i)) % L
        dvec.append(total)
    return dvec


def single_bilinearmap(ai: Sequence[int], bj: Sequence[int],
                       yi: Sequence[int]) -> int:
    assert len(ai) == len(bj) == len(yi)
    return sum(a * b % L * y for a, b, y in zip(ai, bj, yi)) % L


@dataclass
class MultiHadamardStatement:
    c_b: bytes
    zero_statement: ZeroStatement


@dataclass
class MultiHadamardProof:
    c_B: List[bytes]
    zero_proof: ZeroProof

    @staticmethod
    def create_multi_hadamard_product_arg(
        prover: Prover, witness_cols: Sequence[Sequence[int]],
        xpc_gens: VectorPedersenGens, bvec: Sequence[int],
        comit_a: Sequence[ex.Point], cb: ex.Point,
        r: Sequence[int], s_3: int,
    ) -> Tuple["MultiHadamardProof", "MultiHadamardStatement"]:
        m = len(witness_cols)
        n = len(witness_cols[0])
        prover.new_domain_sep(b"MultiHadamardProductProof")
        # running hadamard products: b_1 = a_1, b_i = b_{i-1} o a_i, b_m = bvec
        b_list = [list(witness_cols[0])]
        for i in range(1, m - 1):
            b_list.append(vectorutil.hadamard_product(b_list[-1], witness_cols[i]))
        b_list.append(list(bvec))

        rng = prover.prove_rekey_witness_transcript_rng(list(bvec))
        # s_1 = r_1; s_2..s_{m-1} random; s_m = s_3
        s_vec_product = [r[0]] + [rng.random_scalar() for _ in range(m - 2)] + [s_3]
        c_B_initial = ([comit_a[0]] +
                       xpc_gens.commit_rows(b_list[1:m - 1],
                                            s_vec_product[1:m - 1]) + [cb])
        for cr in c_B_initial:
            prover.allocate_point(b"BVectorCommitment", _enc(cr))
        x = prover.get_challenge(b"XChallenge")
        y = prover.get_challenge(b"YChallenge")
        x_exp = vectorutil.exp_iter(x, m, skip=1)  # x^1..x^m

        c_D_mh = [ex.pt_mul(xi, pt) for pt, xi in zip(c_B_initial, x_exp)]
        c_D = ex.pt_msm(x_exp[:m - 1], c_B_initial[1:m])
        neg_ones = [(-1) % L] * n
        c_minus_one = xpc_gens.commit(neg_ones, 0)

        # d_i = x^i * b_i (i=1..m-1); d = sum x^i * b_{i+1}
        d_list = [[bi * x_exp[i] % L for bi in b_list[i]] for i in range(m - 1)]
        t_list = [s_vec_product[i] * x_exp[i] % L for i in range(m - 1)]
        d = [0] * n
        for i in range(m - 1):
            for j in range(n):
                d[j] = (d[j] + b_list[i + 1][j] * x_exp[i]) % L
        t = vectorutil.vector_multiply_scalar(x_exp[:m - 1], s_vec_product[1:m])

        s = t_list + [t]
        a_cols = [list(witness_cols[i]) for i in range(1, m)] + [neg_ones]
        b_cols = d_list + [d]
        cA = list(comit_a[1:m]) + [c_minus_one]

        zero_proof = ZeroProof.create_zero_argument_proof(
            prover, a_cols, b_cols, xpc_gens, list(r), s, y)
        zero_statement = ZeroStatement([_enc(p) for p in cA])
        return (MultiHadamardProof([_enc(p) for p in c_B_initial], zero_proof),
                MultiHadamardStatement(_enc(cb), zero_statement))

    def verify(self, verifier: Verifier, statement: MultiHadamardStatement,
               c_A: Sequence[ex.Point], xpc_gens: VectorPedersenGens,
               defer=None) -> None:
        m = len(self.c_B)
        if not (_enc(c_A[0]) == self.c_B[0] and all(
                _enc(c_A[i]) == statement.zero_statement.c_A[i - 1]
                for i in range(1, m))):
            raise ValueError(
                "Multihadamard Product Proof Verify: c_B_1 == c_A_1 Failed")
        if statement.c_b != self.c_B[m - 1]:
            raise ValueError(
                "Multihadamard Product Proof Verify: c_B_m == c_b Failed")
        verifier.new_domain_sep(b"MultiHadamardProductProof")
        for cr in self.c_B:
            verifier.allocate_point(b"BVectorCommitment", cr)
        x = verifier.get_challenge(b"XChallenge")
        y_chal = verifier.get_challenge(b"YChallenge")
        x_exp = vectorutil.exp_iter(x, m, skip=1)
        commitment_b = [_dec(c) for c in self.c_B]
        c_D_mh = ex.pt_mul_batch(list(x_exp[:m]), commitment_b)
        c_D = ex.pt_msm(x_exp[:m - 1], commitment_b[1:m])
        n = len(self.zero_proof.a_vec)
        c_minus_one = _enc(xpc_gens.commit([(-1) % L] * n, 0))
        commit_D_vec = c_D_mh[:m - 1] + [c_D]
        c_zero_A = list(statement.zero_statement.c_A)
        if c_zero_A[m - 1] != c_minus_one:
            c_zero_A[m - 1] = c_minus_one
        self.zero_proof.verify(verifier, c_zero_A, xpc_gens, commit_D_vec,
                               y_chal, defer=defer)


@dataclass
class ProductStatement:
    multi_hadamard_statement: MultiHadamardStatement
    svp_statement: SVPStatement


@dataclass
class ProductProof:
    multi_hadamard_proof: MultiHadamardProof
    svp_proof: SVPProof

    @staticmethod
    def create_product_argument_proof(
        prover: Prover, witness_rows: Sequence[Sequence[int]],
        witness_r: Sequence[int], xpc_gens: VectorPedersenGens,
    ) -> Tuple["ProductProof", "ProductStatement"]:
        """witness_rows: m x n matrix (column-major semantics per reference)."""
        witness_cols = columns(witness_rows)
        m = len(witness_cols)
        c_prod_A = xpc_gens.commit_rows(witness_cols[:m], witness_r[:m])
        # bvec = row products
        bvec = [1] * len(witness_rows)
        for i, row in enumerate(witness_rows):
            p = 1
            for e in row:
                p = p * e % L
            bvec[i] = p
        rng = prover.prove_rekey_witness_transcript_rng(bvec)
        s = rng.random_scalar()
        cb = xpc_gens.commit(bvec, s)
        b = 1
        for v in bvec:
            b = b * v % L
        svp_state = SVPStatement(_enc(cb), b)
        mh_proof, mh_state = MultiHadamardProof.create_multi_hadamard_product_arg(
            prover, witness_cols, xpc_gens, bvec, c_prod_A, cb, witness_r, s)
        svp_proof = SVPProof.create_single_value_argument_proof(
            prover, xpc_gens, s, bvec)
        return (ProductProof(mh_proof, svp_proof),
                ProductStatement(mh_state, svp_state))

    def verify(self, verifier: Verifier, prod_statement: ProductStatement,
               c_prod_A: Sequence[ex.Point],
               xpc_gens: VectorPedersenGens, defer=None) -> None:
        self.multi_hadamard_proof.verify(
            verifier, prod_statement.multi_hadamard_statement, c_prod_A,
            xpc_gens, defer=defer)
        self.svp_proof.verify(verifier, prod_statement.svp_statement, xpc_gens,
                              defer=defer)
