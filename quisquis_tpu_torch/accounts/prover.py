"""Sigma-protocol provers for the Quisquis protocol.

Mirrors reference src/accounts/prover.rs:21-951 — the `Prover`
transcript manager with witness-rekeyed transcript RNG, the `SigmaProof`
enum, and all nine protocol provers:

* verify_delta_compact_prover      (prover.rs:120-253)  batch DLEQ
* verify_update_account_prover     (prover.rs:264-342)  anonymity-set DLOG
* verify_account_prover            (prover.rs:355-505)  sender sk+balance
* verify_non_negative_sender_receiver_prover (prover.rs:544-591) bulletproofs
* zero_balance_account_vector_prover (prover.rs:602-659)
* zero_balance_account_prover      (prover.rs:670-704)
* destroy_account_prover           (prover.rs:715-772)
* same_value_compact_prover        (prover.rs:784-847)
* verify_update_account_dark_tx_prover (prover.rs:864-951)

Deviation from the reference (documented bug fix): the reference's
zero-balance *vector* proof can never verify because prover and verifier
use different domain separators ("ZeroBalanceAccountVectorProof" at
prover.rs:613 vs "ZeroBalanceAccounVectorProof" at verifier.rs:605 — note
the missing 't'); its only in-tree test asserts failure. Here both sides
use "ZeroBalanceAccountVectorProof".

Randomness: the reference finalizes transcript RNGs with thread_rng()
(prover.rs:71); here entropy is injectable for reproducible proofs.

The PyTorch port's own copy of the JAX package's host prover, pure Python
(no native dispatch).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..ops import exact as ex
from ..primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from ..primitives.pedersen import default_pedersen_gens
from .accounts import Account
from .transcript import Transcript, SeededRng

L = ex.L


@dataclass
class SigmaProof:
    """Dlog(z_vector, x) or Dleq(zv, zr1, zr2, x)."""

    kind: str  # "dlog" | "dleq"
    fields: tuple

    @staticmethod
    def dlog(z_vector: List[int], x: int) -> "SigmaProof":
        return SigmaProof("dlog", (list(z_vector), x))

    @staticmethod
    def dleq(zv: List[int], zr1: List[int], zr2: List[int], x: int) -> "SigmaProof":
        return SigmaProof("dleq", (list(zv), list(zr1), list(zr2), x))

    def get_dlog(self) -> Tuple[List[int], int]:
        if self.kind != "dlog":
            raise ValueError("Not a DLOG sigma proof")
        return self.fields

    def get_dleq(self) -> Tuple[List[int], List[int], List[int], int]:
        if self.kind != "dleq":
            raise ValueError("Not a DLEQ sigma proof")
        return self.fields


def _enc(p: ex.Point) -> bytes:
    return ex.ristretto_encode(p)


class Prover:
    """Transcript manager for proof generation (prover.rs:49-107)."""

    def __init__(self, proof_label: bytes, transcript: Transcript,
                 rng: Optional[SeededRng] = None):
        transcript.domain_sep(proof_label)
        self.transcript = transcript
        self.scalars: List[int] = []
        self._rng = rng

    # -- transcript plumbing -------------------------------------------------

    def _entropy(self) -> Optional[bytes]:
        return self._rng.fill_bytes(32) if self._rng is not None else None

    def prove_impl(self):
        builder = self.transcript.clone().build_rng()
        for s in self.scalars:
            builder = builder.rekey_with_witness_bytes(b"", ex.sc_to_bytes(s))
        return builder.finalize(entropy=self._entropy())

    def prove_rekey_witness_transcript_rng(self, scalars: Sequence[int]):
        builder = self.transcript.clone().build_rng()
        wbuf = b"".join(ex.sc_to_bytes(s) for s in scalars)
        builder = builder.rekey_with_witness_batch(b"", wbuf, 32)
        return builder.finalize(entropy=self._entropy())

    def allocate_scalar(self, label: bytes, assignment: int) -> None:
        self.transcript.append_scalar_var(label, assignment)
        self.scalars.append(assignment)

    def allocate_point(self, label: bytes, point_bytes: bytes) -> None:
        self.transcript.append_point_var(label, point_bytes)

    def allocate_account(self, label: bytes, account: Account) -> None:
        self.transcript.append_account_var(label, account)

    def new_domain_sep(self, label: bytes) -> None:
        self.transcript.domain_sep(label)

    def get_challenge(self, label: bytes) -> int:
        return self.transcript.get_challenge(label)

    # -- sigma provers -------------------------------------------------------

    @staticmethod
    def verify_delta_compact_prover(
        delta_accounts: Sequence[Account], epsilon_accounts: Sequence[Account],
        rscalar: Sequence[int], value_vector: Sequence[int], prover: "Prover",
    ) -> SigmaProof:
        """Batch DLEQ: delta and epsilon accounts commit the same values."""
        assert len(delta_accounts) == len(epsilon_accounts)
        n = len(delta_accounts)
        prover.new_domain_sep(b"VerifyDeltaCompact")
        prover.scalars = list(rscalar) + list(value_vector)
        for d, e in zip(delta_accounts, epsilon_accounts):
            prover.allocate_account(b"delta_account", d)
            prover.allocate_account(b"epsilon_account", e)
        trng = prover.prove_impl()
        r1_dash, r2_dash, v_dd = [], [], []
        for _ in range(n):
            r1_dash.append(trng.random_scalar())
            r2_dash.append(trng.random_scalar())
            v_dd.append(trng.random_scalar())

        # first messages in three batches + one encode pass
        B = ex.BASEPOINT
        e_delta = ex.pt_mul_batch(
            r1_dash + r2_dash,
            [d.pk.gr_point for d in delta_accounts]
            + [e.pk.gr_point for e in epsilon_accounts])
        e_eps = e_delta[n:]
        e_delta = e_delta[:n]
        f_delta = ex.pt_fold_batch(
            v_dd + v_dd, r1_dash + r2_dash, [B] * (2 * n),
            [d.pk.grsk_point for d in delta_accounts]
            + [e.pk.grsk_point for e in epsilon_accounts])
        f_eps = f_delta[n:]
        f_delta = f_delta[:n]
        encs = ex.ristretto_encode_batch(e_delta + f_delta + e_eps + f_eps)
        for i in range(n):
            prover.allocate_point(b"e_delta", encs[i])
            prover.allocate_point(b"f_delta", encs[n + i])
            prover.allocate_point(b"e_epsilon", encs[2 * n + i])
            prover.allocate_point(b"f_epsilon", encs[3 * n + i])

        x = prover.get_challenge(b"challenge")
        zv = [(vd - v * x) % L for vd, v in zip(v_dd, value_vector)]
        zr1 = [(r1 - r * x) % L for r1, r in zip(r1_dash, rscalar)]
        zr2 = [(r2 - r * x) % L for r2, r in zip(r2_dash, rscalar)]
        return SigmaProof.dleq(zv, zr1, zr2, x)

    @staticmethod
    def verify_update_account_prover(
        updated_input_accounts: Sequence[Account],
        updated_delta_accounts: Sequence[Account],
        delta_rscalar: Sequence[int], prover: "Prover",
    ) -> SigmaProof:
        """DLOG over the anonymity set (detected via comm-diff == pk^r)."""
        check_delta = [
            Account(d.pk, d.comm - i.comm)
            for i, d in zip(updated_input_accounts, updated_delta_accounts)
        ]
        pkdelta_r = [d.pk * r for d, r in zip(updated_delta_accounts, delta_rscalar)]
        anonymity_index = [
            i for i, (cd, pk) in enumerate(zip(check_delta, pkdelta_r))
            if cd.comm.c == pk.gr and cd.comm.d == pk.grsk
        ]

        prover.new_domain_sep(b"DLOGProof")
        prover.scalars = list(delta_rscalar)
        trng = prover.prove_impl()
        s_scalar = trng.random_scalar()

        input_pk_s = [updated_input_accounts[i].pk * s_scalar for i in anonymity_index]
        for i in anonymity_index:
            prover.allocate_point(b"inputgr", updated_input_accounts[i].pk.gr)
            prover.allocate_point(b"inputgrsk", updated_input_accounts[i].pk.grsk)
            prover.allocate_point(b"outputgr", updated_delta_accounts[i].pk.gr)
            prover.allocate_point(b"outputgrsk", updated_delta_accounts[i].pk.grsk)
        for pk in input_pk_s:
            prover.allocate_point(b"commitmentgr", pk.gr)
            prover.allocate_point(b"commitmentgrsk", pk.grsk)

        x = prover.get_challenge(b"chal")
        z_vector = [(s_scalar - x * delta_rscalar[i]) % L for i in anonymity_index]
        return SigmaProof.dlog(z_vector, x)

    @staticmethod
    def verify_account_prover(
        updated_delta_account_sender: Sequence[Account],
        bl_updated_sender: Sequence[int], sk: Sequence[RistrettoSecretKey],
        prover: "Prover", base_pk: RistrettoPublicKey,
    ) -> Tuple[List[Account], List[int], SigmaProof]:
        """Sender knows sk and updated balance; emits fresh epsilon accounts."""
        assert len(updated_delta_account_sender) == len(bl_updated_sender)
        n = len(updated_delta_account_sender)
        prover.new_domain_sep(b"VerifyAccountProof")
        v_vector = [b % L for b in bl_updated_sender]
        prover.scalars = list(v_vector)
        trng = prover.prove_impl()

        epsilon_accounts, epsilon_rscalars = [], []
        for i in range(n):
            rscalar = trng.random_scalar()
            epsilon_accounts.append(
                Account.create_epsilon_account(base_pk, rscalar, bl_updated_sender[i]))
            epsilon_rscalars.append(rscalar)
        for d, e in zip(updated_delta_account_sender, epsilon_accounts):
            prover.allocate_account(b"delta_account", d)
            prover.allocate_account(b"epsilon_account", e)

        rv = [trng.random_scalar() for _ in range(n)]
        rsk = [trng.random_scalar() for _ in range(n)]
        r_dash = [trng.random_scalar() for _ in range(n)]

        eps_gr = [e.pk.gr_point for e in epsilon_accounts]
        e_delta = ex.pt_mul_batch(
            rsk + r_dash,
            [d.pk.gr_point for d in updated_delta_account_sender] + eps_gr)
        e_eps = e_delta[n:]
        e_delta = e_delta[:n]
        # f_delta_i = rv_i*eps_gr_i + rsk_i*delta_c_i;
        # f_eps_i   = rv_i*eps_gr_i + r_dash_i*eps_grsk_i
        f_delta = ex.pt_fold_batch(
            rv + rv, rsk + r_dash, eps_gr + eps_gr,
            [d.comm.c_point for d in updated_delta_account_sender]
            + [e.pk.grsk_point for e in epsilon_accounts])
        f_eps = f_delta[n:]
        f_delta = f_delta[:n]
        encs = ex.ristretto_encode_batch(e_delta + f_delta + e_eps + f_eps)
        for i in range(n):
            prover.allocate_point(b"e_delta", encs[i])
            prover.allocate_point(b"f_delta", encs[n + i])
            prover.allocate_point(b"e_epsilon", encs[2 * n + i])
            prover.allocate_point(b"f_epsilon", encs[3 * n + i])

        x = prover.get_challenge(b"challenge")
        zv = [(r - v * x) % L for r, v in zip(rv, v_vector)]
        zsk = [(r - s.scalar * x) % L for r, s in zip(rsk, sk)]
        zr = [(rd - r * x) % L for rd, r in zip(r_dash, epsilon_rscalars)]
        return epsilon_accounts, epsilon_rscalars, SigmaProof.dleq(zv, zsk, zr, x)

    @staticmethod
    def verify_non_negative_prover(bl, rscalar, rp_prover) -> None:
        """R1CS range gadget per receiver (prover.rs:514-534)."""
        for b, r in zip(bl, rscalar):
            if b < 0:
                raise ValueError("Receiver balance is negative")
            rp_prover.range_proof_prover(b, r)

    def verify_non_negative_sender_receiver_prover(
        self, bl: Sequence[int], rscalar: Sequence[int],
    ) -> list:
        """64-bit bulletproof range proofs: aggregated if len is a power of 2,
        else one proof per value (prover.rs:544-591)."""
        from ..bulletproofs.range_proof import RangeProof
        from ..config import DEFAULT as _cfg
        n_bits = _cfg.range_bits
        size = len(bl)
        power_of_2 = size & (size - 1) == 0
        self.new_domain_sep(b"AggregateBulletProof")
        proofs = []
        if power_of_2:
            proof, _ = RangeProof.prove_multiple(
                self.transcript, list(bl), list(rscalar), n_bits,
                rng=self._rng)
            proofs.append(proof)
        else:
            for b, r in zip(bl, rscalar):
                proof, _ = RangeProof.prove_single(
                    self.transcript, b, r, n_bits, rng=self._rng)
                proofs.append(proof)
        return proofs

    @staticmethod
    def zero_balance_account_vector_prover(
        anonymity_accounts: Sequence[Account], comm_rscalar: Sequence[int],
        prover: "Prover",
    ) -> SigmaProof:
        assert len(anonymity_accounts) == len(comm_rscalar)
        prover.new_domain_sep(b"ZeroBalanceAccountVectorProof")
        prover.scalars = list(comm_rscalar)
        for acc in anonymity_accounts:
            prover.allocate_account(b"anonymity_account", acc)
        trng = prover.prove_impl()
        r_vector = [trng.random_scalar() for _ in comm_rscalar]
        n = len(r_vector)
        pts = ex.pt_mul_batch(
            r_vector + r_vector,
            [acc.pk.gr_point for acc in anonymity_accounts]
            + [acc.pk.grsk_point for acc in anonymity_accounts])
        encs = ex.ristretto_encode_batch(pts)
        for i in range(n):
            prover.allocate_point(b"e", encs[i])
            prover.allocate_point(b"f", encs[n + i])
        x = prover.get_challenge(b"challenge")
        z = [(r - s * x) % L for r, s in zip(r_vector, comm_rscalar)]
        return SigmaProof.dlog(z, x)

    @staticmethod
    def zero_balance_account_prover(
        account: Account, comm_rscalar: int, prover: "Prover",
    ) -> SigmaProof:
        prover.new_domain_sep(b"ZeroBalanceAccountProof")
        prover.scalars.append(comm_rscalar)
        prover.allocate_account(b"zero_account", account)
        trng = prover.prove_impl()
        r = trng.random_scalar()
        e = ex.pt_mul(r, account.pk.gr_point)
        f = ex.pt_mul(r, account.pk.grsk_point)
        prover.allocate_point(b"e", _enc(e))
        prover.allocate_point(b"f", _enc(f))
        x = prover.get_challenge(b"challenge")
        return SigmaProof.dlog([(r - comm_rscalar * x) % L], x)

    @staticmethod
    def destroy_account_prover(
        accounts: Sequence[Account], sk: Sequence[RistrettoSecretKey],
        prover: "Prover",
    ) -> SigmaProof:
        assert len(accounts) == len(sk)
        prover.new_domain_sep(b"DestroyAccountProof")
        sk_scalars = [s.scalar for s in sk]
        prover.scalars = list(sk_scalars)
        for acc in accounts:
            prover.allocate_account(b"account", acc)
        trng = prover.prove_impl()
        r_vector = [trng.random_scalar() for _ in sk]
        n = len(r_vector)
        pts = ex.pt_mul_batch(
            r_vector + r_vector,
            [acc.pk.gr_point for acc in accounts]
            + [acc.comm.c_point for acc in accounts])
        encs = ex.ristretto_encode_batch(pts)
        for i in range(n):
            prover.allocate_point(b"e", encs[i])
            prover.allocate_point(b"f", encs[n + i])
        x = prover.get_challenge(b"challenge")
        z = [(r - s * x) % L for r, s in zip(r_vector, sk_scalars)]
        return SigmaProof.dlog(z, x)

    @staticmethod
    def same_value_compact_prover(
        enc_account: Account, rscalar: int, value: int,
        pedersen_commitment: bytes, rng: Optional[SeededRng] = None,
    ) -> SigmaProof:
        """DLEQ: same value committed in ElGamal and Pedersen commitments.

        Creates its own transcript (prover.rs:793-794).
        """
        pc = default_pedersen_gens()
        transcript = Transcript(b"SameValueProof")
        prover = Prover(b"DLEQProof", transcript, rng=rng)
        prover.scalars = [rscalar, value]
        prover.allocate_account(b"encrypted_account", enc_account)
        prover.allocate_point(b"G", _enc(pc.B))
        prover.allocate_point(b"H", _enc(pc.B_blinding))
        prover.allocate_point(b"d", pedersen_commitment)
        trng = prover.prove_impl()
        r1_dash = trng.random_scalar()
        v_dd = trng.random_scalar()
        gv_dd = ex.pt_base_mul(v_dd)
        f_delta = ex.pt_add(gv_dd, ex.pt_mul(r1_dash, enc_account.pk.grsk_point))
        f_eps = ex.pt_add(gv_dd, ex.pt_mul(r1_dash, pc.B_blinding))
        prover.allocate_point(b"f_delta", _enc(f_delta))
        prover.allocate_point(b"f_epsilon", _enc(f_eps))
        x = prover.get_challenge(b"challenge")
        zv = (v_dd - x * value) % L
        zr1 = (r1_dash - rscalar * x) % L
        return SigmaProof.dleq([zv], [zr1], [], x)

    @staticmethod
    def verify_update_account_dark_tx_prover(
        delta_updated_accounts: Sequence[Account],
        output_accounts: Sequence[Account],
        pk_rscalar: int, comm_rscalar: int, prover: "Prover",
    ) -> SigmaProof:
        """Outputs updated with one (pk_rscalar, comm_rscalar) pair."""
        assert len(delta_updated_accounts) == len(output_accounts)
        prover.new_domain_sep(b"VerifyUpdateAccountDarkTx")
        prover.scalars.append(pk_rscalar)
        prover.scalars.append(comm_rscalar)
        trng = prover.prove_impl()
        pk_blinding = trng.random_scalar()
        comm_blinding = trng.random_scalar()

        delta_pk_blind = [d.pk * pk_blinding for d in delta_updated_accounts]
        check_zero = [o.comm - d.comm
                      for d, o in zip(delta_updated_accounts, output_accounts)]
        pk_comm_rscalar = [d.pk * comm_rscalar for d in delta_updated_accounts]
        for cd, pkr in zip(check_zero, pk_comm_rscalar):
            if cd.c != pkr.gr or cd.d != pkr.grsk:
                raise ValueError(
                    "Commitments are not properly updated. Every Commitment "
                    "should be updated with 0 balance")
        delta_pk_comm_blind = [d.pk * comm_blinding for d in delta_updated_accounts]

        for inp, out in zip(delta_updated_accounts, output_accounts):
            prover.allocate_account(b"account", inp)
            prover.allocate_account(b"updatedaccount", out)
        for pk in delta_pk_blind:
            prover.allocate_point(b"commitmentgr", pk.gr)
            prover.allocate_point(b"commitmentgrsk", pk.grsk)
        for pk in delta_pk_comm_blind:
            prover.allocate_point(b"commitmentc", pk.gr)
            prover.allocate_point(b"commitmentd", pk.grsk)

        x = prover.get_challenge(b"challenge")
        z = [(pk_blinding - x * pk_rscalar) % L,
             (comm_blinding - x * comm_rscalar) % L]
        return SigmaProof.dlog(z, x)
