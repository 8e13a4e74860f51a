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
from ..device import resolve_device
from ..utils.metrics import span
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
    @span("shuffle.prove")
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


def _advance_shuffle_transcript(proof: ShuffleProof, verifier: Verifier,
                                statement: ShuffleStatement,
                                shuffle_input: Sequence[Account]) -> None:
    """Replay ONLY the transcript interactions of ShuffleProof.verify,
    advancing the verifier's transcript to the post-proof state with no
    scalar-vector or point-identity work (that runs on device from a
    snapshot taken before this call).

    The one unavoidable computation is the DDH section: the transcript
    absorbs the *encodings* of (G, H) = sum x^i pk_i and of the Schnorr
    first-message recomputation, so those two MSMs and two 2-term folds
    run here on the host. The append/challenge schedule below is the host
    verifier's, byte for byte: it ends in the state ShuffleProof.verify
    leaves (tests/test_torch_shuffle.py).
    """
    m, _ = _dims(len(shuffle_input))
    t = verifier.transcript
    for ca, ctau in zip(proof.c_A, proof.c_tau):
        t.append_point_var(b"ACommitment", ca)
        t.append_point_var(b"tauCommitment", ctau)
    x = t.get_challenge(b"xChallenge")
    for cb, cbd in zip(proof.c_B, proof.c_B_dash):
        t.append_point_var(b"BCommitment", cb)
        t.append_point_var(b"BDashCommitment", cbd)
    # Hadamard argument
    had = proof.hadamard_proof
    t.domain_sep(b"HadamardProductProof")
    for i in range(m):
        t.append_point_var(b"c_a", proof.c_B_dash[i])
        t.append_point_var(b"c_b", proof.c_tau[i])
        t.append_point_var(b"c_c", proof.c_B[i])
    t.append_point_var(b"c_a_0", had.commitment_a_0)
    t.append_point_var(b"c_b_0", had.commitment_b_0)
    t.append_point_var(b"c_c_0", had.commitment_c_0)
    for cd in had.commitment_delta:
        t.append_point_var(b"c_delta", cd)
    t.get_challenge(b"challenge")
    t.get_challenge(b"yChallenge")
    t.get_challenge(b"zChallenge")
    # Product argument: MultiHadamard -> Zero -> SVP
    mh = proof.product_proof.multi_hadamard_proof
    t.domain_sep(b"MultiHadamardProductProof")
    for cb in mh.c_B:
        t.append_point_var(b"BVectorCommitment", cb)
    t.get_challenge(b"XChallenge")
    t.get_challenge(b"YChallenge")
    zp = mh.zero_proof
    t.domain_sep(b"ZeroArgumentProof")
    t.append_point_var(b"A0Commitment", zp.c_A_0)
    t.append_point_var(b"BmCommitment", zp.c_B_m)
    for cd in zp.c_D:
        t.append_point_var(b"DCommitment", cd)
    t.get_challenge(b"challenge")
    svp = proof.product_proof.svp_proof
    t.domain_sep(b"SingleValueProductProof")
    t.append_point_var(b"DeltaSmall", svp.commitment_delta_small)
    t.append_point_var(b"DeltaCapital", svp.commitment_delta_capital)
    t.append_point_var(b"d", svp.commitment_d)
    t.get_challenge(b"challenge")
    # DDH: the encodings of (G, H) and of the first-message recomputation
    # feed the transcript, so this section runs eagerly (it is also the
    # one host-side challenge equality check retained here)
    exp_x = vectorutil.exp_iter(x, len(shuffle_input), skip=1)
    g_i = [acc.pk.gr_point for acc in shuffle_input]
    h_i = [acc.pk.grsk_point for acc in shuffle_input]
    G, H = ex.pt_msm_many([(exp_x, g_i), (exp_x, h_i)])
    proof.ddh_proof.verify_ddh_proof(verifier, statement.ddh_statement,
                                     _enc(G), _enc(H))
    # Multi-exponentiation arguments (pubkey, then commitment)
    for label, me in ((b"MultiExponentialPubKeyProof",
                       proof.multi_exponen_pk),
                      (b"MultiExponentialElgamalCommmitmentProof",
                       proof.multi_exponen_commit)):
        t.domain_sep(label)
        t.append_point_var(b"A0Commitment", me.c_A_0)
        for k in range(2 * m):
            t.append_point_var(b"BKCommitment", me.c_B_k[k])
            t.append_point_var(b"EK0Commitment", me.E_k_0[k])
            t.append_point_var(b"EK1Commitment", me.E_k_1[k])
        t.get_challenge(b"xchallenege")


ShuffleProof.advance_transcript = _advance_shuffle_transcript


def _auto_min_device(m: int) -> float:
    """The fewest shuffles of side m that "auto" proves on the device: on
    the H100 (four runs) a device call cost 2.1-3.8 s at m = 3 and 2.7-5.4 s
    at m = 8 for 2 to 64 shuffles, the host prover on the C++ curve
    24.2-43.4 ms a proof at m = 3 and 68.8-98.8 ms at m = 8; the device led
    only at m = 8 with 64 (3,153-5,349 ms against 4,403-6,323)
    (``python3 -m quisquis_tpu_torch.auto_rules``; PERF.md §5)."""
    return 64 if m >= 8 else float("inf")


#: the smallest device bucket of batch_create_shuffle_proofs
_MIN_BUCKET = 2

#: the fewest proofs (each of side 8 or more) that batch_verify_shuffle_proofs'
#: "auto" verifies on the device (see its docstring)
AUTO_DEVICE_PROOFS = 64


def batch_create_shuffle_proofs(shuffles, rngs=None, backend="auto", device="cuda"):
    """Prove many shuffles; returns [(proof, statement)] in order.

    The shuffles are grouped by anonymity-set size. backend:
      - "host": ShuffleProof.create_shuffle_proof per shuffle, each with its
        own Prover and Transcript.
      - "device-batched": each group is padded to a power-of-two bucket (at
        least 2 lanes; pad lanes draw from a fresh SeededRng) and
        proved in one call of ``shuffle.device_prove.DeviceShuffleProver``
        on ``device``: byte-identical to the host prover under the same
        per-lane rng streams.
      - "auto": "device-batched" for a group of at least
        ``_auto_min_device(m)`` shuffles, "host" for a smaller one (read on
        the H100 with the C++ curve under the host prover; ROADMAP.md §C,
        PERF.md §5). ``device`` is resolved first, so the default raises
        without a GPU whichever backend a group takes. The JAX package's
        TPU crossover table is not carried over.

    Reference prove path: reference src/shuffle/shuffle.rs:361-532 (one
    proof at a time).
    """
    from ..accounts.transcript import Transcript

    shuffles = list(shuffles)
    if rngs is None:
        rngs = [SeededRng() for _ in shuffles]
    if backend not in ("auto", "host", "device-batched"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        resolve_device(device)
    groups: dict = {}
    for i, sh in enumerate(shuffles):
        groups.setdefault(len(sh.inputs), []).append(i)
    results: list = [None] * len(shuffles)
    for n_acc, idxs in sorted(groups.items()):
        m = math.isqrt(n_acc)
        if backend == "host" or (backend == "auto" and len(idxs) < _auto_min_device(m)):
            for i in idxs:
                prover = Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=rngs[i])
                results[i] = ShuffleProof.create_shuffle_proof(prover, shuffles[i], rng=rngs[i])
            continue
        if m * m != n_acc:
            raise ValueError(f"anonymity set size {n_acc} is not square")
        from .device_prove import get_device_shuffle_prover

        B = max(_MIN_BUCKET, 1 << (len(idxs) - 1).bit_length())
        pad = idxs + [idxs[0]] * (B - len(idxs))
        dsp = get_device_shuffle_prover(m, B, device=device)
        proved = dsp.prove([shuffles[i] for i in pad],
                           [rngs[i] if k < len(idxs) else SeededRng() for k, i in enumerate(pad)])
        for k, i in enumerate(idxs):
            results[i] = proved[k]
    return results


def batch_verify_shuffle_proofs(entries, xpc_gens=None, backend="auto",
                                seed=None, device="cuda", mesh=None) -> None:
    """Verify many shuffle proofs at once; raises ValueError if any fails.

    `entries`: iterable of (proof, verifier, statement, inputs, outputs).

    backend:
      - "device-batched": the whole verifier (batched transcript replay,
        challenge arithmetic and one combined MSM) on ``device``, per shape
        bucket (shuffle.device_verify).
      - "host" or "device": each proof's transcript is replayed here and
        every point-identity check, scaled by a fresh random weight, joins
        one accumulator (accounts.deferred.DeferredPointChecks); its one
        MSM runs on the host ("host") or on ``device`` ("device").
      - "auto": "device-batched" for at least AUTO_DEVICE_PROOFS proofs, all
        of side 8 or more, else "host" (``device`` resolved first). On the
        H100 with the C++ curve (four runs), "host" led at 2, 16 and 32
        proofs of side 8 (33.0-48.4 against 714.5-907.4 ms at 2,
        441.9-577.0 against 685.1-900.7 at 32) and at every batch of side 3
        up to 64; "device-batched" led at 64 of side 8 (614.5-897.3
        against 890.4-1,159.7 ms) (``python3 -m
        quisquis_tpu_torch.auto_rules``; PERF.md §5).
      - "sharded": each proof's transcript is replayed here, on every rank
        of ``mesh`` (a ``parallel.Mesh``), and the accumulator's one MSM
        runs with its point axis split over the ranks
        (DeferredPointChecks.verify).

    The eager equivalent loops `proof.verify(...)` per proof (reference
    behavior, reference src/shuffle/shuffle.rs:547-712).
    """
    from ..accounts.deferred import DeferredPointChecks

    entries = list(entries)
    if backend == "auto":
        resolve_device(device)
        wide = all(len(ins) >= 64 for _, _, _, ins, _ in entries)
        backend = "device-batched" if wide and len(entries) >= AUTO_DEVICE_PROOFS else "host"
    if backend not in ("device-batched", "host", "device", "sharded"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "device-batched":
        from .device_verify import device_batch_verify

        if xpc_gens is not None:
            raise ValueError(
                "device-batched backend uses the default generator set")
        device_batch_verify(
            [(p, st, ins, outs) for p, _, st, ins, outs in entries],
            transcripts=[v.transcript for _, v, _, _, _ in entries],
            rng=SeededRng(seed) if seed is not None else None, device=device)
        return
    defer = DeferredPointChecks(seed)
    for proof, verifier, statement, inputs, outputs in entries:
        proof.verify(verifier, statement, inputs, outputs, xpc_gens, defer=defer)
    defer.verify(backend=backend, device=device, mesh=mesh)

