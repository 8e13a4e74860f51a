"""QuisQuis shuffle: permutation, account shuffling, and the full shuffle
argument.

Mirrors reference src/shuffle/shuffle.rs:50-744, with the fixed
N=9 / 3x3 configuration (shuffle.rs:55-59) generalized: any square m x m
anonymity set (N = m^2), e.g. N=9 (m=3) or N=64 (m=8, the multi-host
config). The proof composes Hadamard, Product (MultiHadamard + Zero + SVP),
DDH, and two Multi-exponentiation arguments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..ops import exact as ex
from ..primitives.keys import RistrettoPublicKey
from ..primitives.elgamal import ElGamalCommitment
from ..primitives.pedersen import VectorPedersenGens, vector_pedersen_gens
from ..accounts.accounts import Account
from ..accounts.prover import Prover
from ..accounts.verifier import Verifier
from ..accounts.transcript import SeededRng
from .hadamard import HadamardProof, HadamardStatement
from .product import ProductProof, ProductStatement
from .multiexponential import MultiexpoProof
from .ddh import DDHProof, DDHStatement
from . import vectorutil

L = ex.L

# default configuration from config.DEFAULT (reference: 9 / 3x3,
# shuffle.rs:55-59); actual sizes always derive from input lengths
from ..config import DEFAULT as _DEFAULT_CFG  # noqa: E402

N = _DEFAULT_CFG.anonymity_set_size
ROWS = _DEFAULT_CFG.rows
COLUMNS = _DEFAULT_CFG.columns


def _enc(p):
    return ex.ristretto_encode(p)


def _dims(n: int) -> Tuple[int, int]:
    m = math.isqrt(n)
    assert m * m == n, "anonymity set size must be a perfect square"
    return m, m


class Permutation:
    """Permutation over 1..n stored as an m x n matrix (row-major)."""

    def __init__(self, rng: SeededRng, n: int):
        perm = list(range(1, n + 1))
        # Fisher-Yates (shuffle.rs:70-79)
        for i in range(len(perm) - 1, 0, -1):
            j = self._gen_range(rng, i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        self.perm = perm
        self.n = n

    @staticmethod
    def _gen_range(rng: SeededRng, bound: int) -> int:
        """Uniform value in [0, bound) from the injected RNG."""
        while True:
            v = int.from_bytes(rng.fill_bytes(8), "little")
            limit = (1 << 64) - ((1 << 64) % bound)
            if v < limit:
                return v % bound

    def set(self, perm: Sequence[int]) -> None:
        self.perm = list(perm)
        self.n = len(self.perm)

    def get_row_major(self) -> List[int]:
        return list(self.perm)

    def invert_permutation(self) -> List[int]:
        inverse = [0] * self.n
        for i, p in enumerate(self.perm):
            inverse[p - 1] = i + 1
        return inverse

    def get_permutation_as_scalar_matrix(self) -> List[List[int]]:
        m, n_cols = _dims(self.n)
        return [[self.perm[i * n_cols + j] for j in range(n_cols)]
                for i in range(m)]


@dataclass
class Shuffle:
    inputs: List[Account]
    outputs: List[Account]
    shuffled_tau: List[int]  # row-major
    rho: int
    pi: Permutation

    @staticmethod
    def _random_initialization(length: int, rng: SeededRng):
        pi = Permutation(rng, length)
        tau = [rng.random_scalar() for _ in range(length)]
        rho = rng.random_scalar()
        return pi, tau, rho

    @staticmethod
    def input_shuffle(inputs: Sequence[Account],
                      rng: Optional[SeededRng] = None) -> "Shuffle":
        """Permute accounts, update with tau_i/rho; pi is inverted so that
        outputs = inputs updated and inputs = permuted (shuffle.rs:211-248)."""
        if len(inputs) == 0:
            raise ValueError("Error::EmptyShuffle")
        if rng is None:
            rng = SeededRng()
        length = len(inputs)
        pi, tau, rho = Shuffle._random_initialization(length, rng)
        permutation = pi.get_row_major()
        shuffled = [inputs[permutation[i] - 1] for i in range(length)]
        pi.set(pi.invert_permutation())
        updated = Account.update_accounts_batch(
            list(inputs), [0] * length, tau, [rho] * length)
        return Shuffle(shuffled, updated, tau, rho, pi)

    @staticmethod
    def output_shuffle(inputs: Sequence[Account],
                       rng: Optional[SeededRng] = None) -> "Shuffle":
        if len(inputs) == 0:
            raise ValueError("Error::EmptyShuffle")
        if rng is None:
            rng = SeededRng()
        length = len(inputs)
        pi, tau, rho = Shuffle._random_initialization(length, rng)
        permutation = pi.get_row_major()
        shuffled = [inputs[permutation[i] - 1] for i in range(length)]
        outputs = Account.update_accounts_batch(
            shuffled, [0] * length, tau, [rho] * length)
        return Shuffle(list(inputs), outputs, tau, rho, pi)

    def get_inputs_vector(self) -> List[Account]:
        return list(self.inputs)

    def get_outputs_vector(self) -> List[Account]:
        return list(self.outputs)


def create_b_b_dash(exp_x: Sequence[int], tau: Sequence[int],
                    p: Permutation) -> Tuple[List[int], List[int]]:
    """b_i = x^{pi(i)}, b'_i = b_i / tau_i (shuffle.rs:723-744), row-major."""
    perm = p.get_row_major()
    tau_inv = ex.sc_batch_invert([t % L for t in tau])
    b = [exp_x[perm[i] - 1] for i in range(len(exp_x))]
    b_dash = [b[i] * tau_inv[i] % L for i in range(len(b))]
    return b, b_dash


def _to_rows(flat: Sequence, m: int, n: int) -> List[List]:
    return [list(flat[i * n:(i + 1) * n]) for i in range(m)]


@dataclass
class ShuffleStatement:
    hadamard_statement: HadamardStatement
    product_statement: ProductStatement
    ddh_statement: DDHStatement


@dataclass
class ShuffleProof:
    c_A: List[bytes]
    c_tau: List[bytes]
    c_B: List[bytes]
    c_B_dash: List[bytes]
    hadamard_proof: HadamardProof
    product_proof: ProductProof
    multi_exponen_pk: MultiexpoProof
    multi_exponen_commit: MultiexpoProof
    ddh_proof: DDHProof

    @staticmethod
    def create_shuffle_proof(
        prover: Prover, shuffle: Shuffle,
        xpc_gens: Optional[VectorPedersenGens] = None,
        rng: Optional[SeededRng] = None,
    ) -> Tuple["ShuffleProof", "ShuffleStatement"]:
        n_total = len(shuffle.inputs)
        m, n_cols = _dims(n_total)
        if xpc_gens is None:
            xpc_gens = vector_pedersen_gens(m + 1)
        if rng is None:
            rng = SeededRng()

        witness = shuffle.pi.get_permutation_as_scalar_matrix()  # m x n rows
        r = [rng.random_scalar() for _ in range(m)]
        commitment_witness = [_enc(c) for c in
                              xpc_gens.commit_rows(witness[:m], r)]
        trng = prover.prove_rekey_witness_transcript_rng(shuffle.shuffled_tau)
        r_dash = [trng.random_scalar() for _ in range(m)]
        tau_rows = _to_rows(shuffle.shuffled_tau, m, n_cols)
        commitment_tau = [_enc(c) for c in
                          xpc_gens.commit_rows(tau_rows, r_dash)]
        for a, tau_c in zip(commitment_witness, commitment_tau):
            prover.allocate_point(b"ACommitment", a)
            prover.allocate_point(b"tauCommitment", tau_c)
        x = prover.get_challenge(b"xChallenge")
        exp_x = vectorutil.exp_iter(x, n_total, skip=1)

        b_flat, b_dash_flat = create_b_b_dash(exp_x, shuffle.shuffled_tau,
                                              shuffle.pi)
        b_rows = _to_rows(b_flat, m, n_cols)
        b_dash_rows = _to_rows(b_dash_flat, m, n_cols)
        s = [trng.random_scalar() for _ in range(m)]
        s_dash = [trng.random_scalar() for _ in range(m)]
        commitment_b = [_enc(c) for c in xpc_gens.commit_rows(b_rows, s)]
        commitment_b_dash = [_enc(c) for c in
                             xpc_gens.commit_rows(b_dash_rows, s_dash)]
        for cb, cbd in zip(commitment_b, commitment_b_dash):
            prover.allocate_point(b"BCommitment", cb)
            prover.allocate_point(b"BDashCommitment", cbd)

        # Hadamard: b' o tau = b
        hadamard_proof, hadamard_statement = \
            HadamardProof.create_hadamard_argument_proof(
                prover, xpc_gens, b_dash_rows, tau_rows, b_rows,
                commitment_b_dash, commitment_tau, commitment_b,
                s_dash, r_dash, s)

        y = prover.get_challenge(b"yChallenge")
        z = prover.get_challenge(b"zChallenge")
        # f = y*a + b ; e = f - z ; e arranged column-major into m x n
        a_flat = [x_ for row in witness for x_ in row]
        f = [(a * y + b) % L for a, b in zip(a_flat, b_flat)]
        t = [(ri * y + si) % L for ri, si in zip(r, s)]
        e = [(fi - z) % L for fi in f]
        # column-major m x n (shuffle.rs:457)
        e_rows = [[e[j * m + i] for j in range(n_cols)] for i in range(m)]
        product_proof, product_state = ProductProof.create_product_argument_proof(
            prover, e_rows, t, xpc_gens)

        pks = [acc.pk for acc in shuffle.inputs]
        g_i = [pk.gr_point for pk in pks]
        h_i = [pk.grsk_point for pk in pks]
        G = ex.pt_msm(exp_x, g_i)
        H = ex.pt_msm(exp_x, h_i)
        pk_GH = RistrettoPublicKey.from_points(G, H)
        ddh_proof, ddh_statement = DDHProof.create_verify_update_ddh_prove(
            prover, g_i, h_i, exp_x, G, H, shuffle.rho)

        upk = [acc.pk for acc in shuffle.outputs]
        updated_commitment = [acc.comm for acc in shuffle.outputs]
        base_pk = RistrettoPublicKey.generate_base_pk()
        multiexpo_pk_proof = MultiexpoProof.create_multiexponential_pubkey_proof(
            prover, upk, b_dash_rows, s_dash, xpc_gens, base_pk)
        neg_rho = (-shuffle.rho) % L
        multiexpo_commit_proof = \
            MultiexpoProof.create_multiexponential_elgamal_commit_proof(
                prover, updated_commitment, b_rows, s, xpc_gens, pk_GH, neg_rho)

        return (ShuffleProof(commitment_witness, commitment_tau, commitment_b,
                             commitment_b_dash, hadamard_proof, product_proof,
                             multiexpo_pk_proof, multiexpo_commit_proof,
                             ddh_proof),
                ShuffleStatement(hadamard_statement, product_state,
                                 ddh_statement))

    def verify(self, verifier: Verifier, statement: ShuffleStatement,
               shuffle_input: Sequence[Account],
               shuffle_output: Sequence[Account],
               xpc_gens: Optional[VectorPedersenGens] = None,
               defer=None) -> None:
        n_total = len(shuffle_input)
        m, n_cols = _dims(n_total)
        if xpc_gens is None:
            xpc_gens = vector_pedersen_gens(m + 1)
        if not (len(self.c_A) == m and len(self.c_B) == m
                and len(self.c_B_dash) == m and len(self.c_tau) == m):
            raise ValueError(
                "Shuffle Proof Verify: Invalid length of commitment vectors")
        for ca, ctau in zip(self.c_A, self.c_tau):
            verifier.allocate_point(b"ACommitment", ca)
            verifier.allocate_point(b"tauCommitment", ctau)
        x = verifier.get_challenge(b"xChallenge")
        exp_x = vectorutil.exp_iter(x, n_total, skip=1)
        base_pk = RistrettoPublicKey.generate_base_pk()
        for cb, cbd in zip(self.c_B, self.c_B_dash):
            verifier.allocate_point(b"BCommitment", cb)
            verifier.allocate_point(b"BDashCommitment", cbd)

        self.hadamard_proof.verify(verifier, xpc_gens,
                                   statement.hadamard_statement,
                                   self.c_B_dash, self.c_tau, self.c_B,
                                   defer=defer)
        y = verifier.get_challenge(b"yChallenge")
        z = verifier.get_challenge(b"zChallenge")
        product = 1
        for i, xi in enumerate(exp_x):
            product = product * ((y * (i + 1) + xi - z) % L) % L
        if product != statement.product_statement.svp_statement.b % L:
            raise ValueError(
                "Shuffle Proof Verify:prod pf i .. N (yi + x^i -z) failed")

        pa_vec, pb_vec = [], []
        for ca, cb in zip(self.c_A, self.c_B):
            pa = ex.ristretto_decode(ca)
            pb = ex.ristretto_decode(cb)
            if pa is None or pb is None:
                raise ValueError("ShuffleProof Verify: Decompression Failed")
            pa_vec.append(pa)
            pb_vec.append(pb)
        # c_F_i = y*C_A_i + C_B_i in one batch
        c_F = ex.pt_fold_batch([y] * m, [1] * m, pa_vec, pb_vec)
        # C_-z: commitment to the (-z,...,-z) column with zero blinding —
        # all m columns are identical, so commit once and reuse
        comit_z_neg = xpc_gens.commit([(-z) % L] * m, 0)
        c_E = [ex.pt_add(a, comit_z_neg) for a in c_F]
        self.product_proof.verify(verifier, statement.product_statement, c_E,
                                  xpc_gens, defer=defer)

        pks = [acc.pk for acc in shuffle_input]
        g_i = [pk.gr_point for pk in pks]
        h_i = [pk.grsk_point for pk in pks]
        G, H = ex.pt_msm_many([(exp_x, g_i), (exp_x, h_i)])
        pk_GH = RistrettoPublicKey.from_points(G, H)
        self.ddh_proof.verify_ddh_proof(verifier, statement.ddh_statement,
                                        pk_GH.gr, pk_GH.grsk)
        self.multi_exponen_pk.verify_multiexponential_pubkey_proof(
            verifier, self.c_B_dash, list(shuffle_output), xpc_gens, base_pk,
            pk_GH, m, n_cols, defer=defer)
        self.multi_exponen_commit.verify_multiexponential_elgamal_commit_proof(
            verifier, self.c_B, list(shuffle_output), list(shuffle_input),
            xpc_gens, pk_GH, exp_x, m, n_cols, defer=defer)


