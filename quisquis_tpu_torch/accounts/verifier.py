"""Sigma-protocol verifiers for the Quisquis protocol.

Mirrors reference src/accounts/verifier.rs:25-916. Each verifier
recomputes the prover's first messages via multiscalar multiplication and
re-derives the Fiat-Shamir challenge; verification succeeds iff the
challenge matches.

The multiscalar recombination goes through `multiscalar_multiplication`,
the port's host exact backend; :mod:`quisquis_tpu_torch.accounts.device_verifier`
runs two of these verifiers' recombinations on the device, and the batched
verification paths take their MSMs to :mod:`quisquis_tpu_torch.ops.msm`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..ops import exact as ex
from ..primitives.keys import RistrettoPublicKey
from ..primitives.pedersen import default_pedersen_gens
from .accounts import Account
from .prover import SigmaProof
from .transcript import Transcript

L = ex.L


def _config():
    from ..config import DEFAULT
    return DEFAULT
BASEPOINT_BYTES = ex.ristretto_encode(ex.BASEPOINT)


def _enc(p: ex.Point) -> bytes:
    return ex.ristretto_encode(p)


class Verifier:
    """Transcript manager for proof verification (verifier.rs:25-121)."""

    def __init__(self, proof_label: bytes, transcript: Transcript):
        transcript.domain_sep(proof_label)
        self.transcript = transcript
        self.scalars: List[int] = []

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

    @staticmethod
    def multiscalar_multiplication(scalars: Sequence[int],
                                   points: Sequence[bytes]) -> Optional[ex.Point]:
        """optional_multiscalar_mul over compressed points; None on bad point."""
        decompressed = []
        for pb in points:
            p = ex.ristretto_decode(pb)
            if p is None:
                return None
            decompressed.append(p)
        return ex.pt_msm(scalars, decompressed)

    # -- verifiers -----------------------------------------------------------

    @staticmethod
    def verify_delta_compact_verifier(
        delta_accounts: Sequence[Account], epsilon_accounts: Sequence[Account],
        zv_vector: Sequence[int], zr1_vector: Sequence[int],
        zr2_vector: Sequence[int], x: int, verifier: "Verifier",
    ) -> None:
        verifier.new_domain_sep(b"VerifyDeltaCompact")
        for d, e in zip(delta_accounts, epsilon_accounts):
            verifier.allocate_account(b"delta_account", d)
            verifier.allocate_account(b"epsilon_account", e)
        # all 4n first-message recomputations in one batch
        rows = []
        for i in range(len(delta_accounts)):
            d, e = delta_accounts[i], epsilon_accounts[i]
            rows.append(([zr1_vector[i], x],
                         [d.pk.gr_point, d.comm.c_point]))
            rows.append(([zr1_vector[i], x, zv_vector[i]],
                         [d.pk.grsk_point, d.comm.d_point, ex.BASEPOINT]))
            rows.append(([zr2_vector[i], x],
                         [e.pk.gr_point, e.comm.c_point]))
            rows.append(([zr2_vector[i], x, zv_vector[i]],
                         [e.pk.grsk_point, e.comm.d_point, ex.BASEPOINT]))
        encs = ex.ristretto_encode_batch(ex.pt_msm_many(rows))
        for i in range(len(delta_accounts)):
            verifier.allocate_point(b"e_delta", encs[4 * i])
            verifier.allocate_point(b"f_delta", encs[4 * i + 1])
            verifier.allocate_point(b"e_epsilon", encs[4 * i + 2])
            verifier.allocate_point(b"f_epsilon", encs[4 * i + 3])
        if verifier.get_challenge(b"challenge") != x % L:
            raise ValueError("Dleq Proof Verify: Failed")

    @staticmethod
    def verify_update_account_verifier(
        updated_input_accounts: Sequence[Account],
        updated_delta_accounts: Sequence[Account],
        z_vector: Sequence[int], x: int, verifier: "Verifier",
    ) -> None:
        a = [d.comm - i.comm
             for i, d in zip(updated_input_accounts, updated_delta_accounts)]
        rows = []
        for i in range(len(z_vector)):
            rows.append(([z_vector[i], x],
                         [updated_input_accounts[i].pk.gr_point,
                          a[i].c_point]))
            rows.append(([z_vector[i], x],
                         [updated_input_accounts[i].pk.grsk_point,
                          a[i].d_point]))
        encs = ex.ristretto_encode_batch(ex.pt_msm_many(rows))
        e11 = encs[0::2]
        e12 = encs[1::2]
        verifier.new_domain_sep(b"DLOGProof")
        for inp, out in zip(updated_input_accounts, updated_delta_accounts):
            verifier.allocate_point(b"inputgr", inp.pk.gr)
            verifier.allocate_point(b"inputgrsk", inp.pk.grsk)
            verifier.allocate_point(b"outputgr", out.pk.gr)
            verifier.allocate_point(b"outputgrsk", out.pk.grsk)
        for p1, p2 in zip(e11, e12):
            verifier.allocate_point(b"commitmentgr", p1)
            verifier.allocate_point(b"commitmentgrsk", p2)
        if verifier.get_challenge(b"chal") != x % L:
            raise ValueError("DLOG Proof Verify: Failed")

    @staticmethod
    def verify_non_negative_verifier(epsilon_accounts, rp_verifier) -> None:
        """R1CS range verification over epsilon d-commitments
        (verifier.rs:484-492)."""
        for acc in epsilon_accounts:
            rp_verifier.range_proof_verifier(acc.comm.d)

    @staticmethod
    def verify_account_verifier(
        updated_delta_account_sender, account_epsilon_sender, base_pk,
        zv, zsk, zr, x, rp_verifier, verifier,
    ) -> None:
        """R1CS variant (verifier.rs:305-380): the sigma check plus queuing
        each sender epsilon d-commitment into the shared range verifier."""
        Verifier.verify_account_verifier_bulletproof(
            updated_delta_account_sender, account_epsilon_sender, base_pk,
            zv, zsk, zr, x, verifier)
        for acc in account_epsilon_sender:
            rp_verifier.range_proof_verifier(acc.comm.d)

    @staticmethod
    def verify_account_verifier_bulletproof(
        updated_delta_account_sender: Sequence[Account],
        account_epsilon_sender: Sequence[Account],
        base_pk: RistrettoPublicKey,
        zv: Sequence[int], zsk: Sequence[int], zr: Sequence[int], x: int,
        verifier: "Verifier",
    ) -> None:
        """Sender sk+balance verification (bulletproof variant,
        verifier.rs:396-473)."""
        verifier.new_domain_sep(b"VerifyAccountProof")
        for d, e in zip(updated_delta_account_sender, account_epsilon_sender):
            verifier.allocate_account(b"delta_account", d)
            verifier.allocate_account(b"epsilon_account", e)
        for i, delta in enumerate(updated_delta_account_sender):
            e_delta = Verifier.multiscalar_multiplication(
                [zsk[i], x], [delta.pk.gr, delta.pk.grsk])
            f_delta = Verifier.multiscalar_multiplication(
                [zv[i], zsk[i], x], [base_pk.gr, delta.comm.c, delta.comm.d])
            e_eps = Verifier.multiscalar_multiplication(
                [x, zr[i]], [account_epsilon_sender[i].comm.c, base_pk.gr])
            f_eps = Verifier.multiscalar_multiplication(
                [zv[i], zr[i], x],
                [base_pk.gr, base_pk.grsk, account_epsilon_sender[i].comm.d])
            if None in (e_delta, f_delta, e_eps, f_eps):
                raise ValueError("Account Verify: Failed")
            verifier.allocate_point(b"e_delta", _enc(e_delta))
            verifier.allocate_point(b"f_delta", _enc(f_delta))
            verifier.allocate_point(b"e_epsilon", _enc(e_eps))
            verifier.allocate_point(b"f_epsilon", _enc(f_eps))
        if verifier.get_challenge(b"challenge") != x % L:
            raise ValueError("sender account verification failed")

    def verify_non_negative_sender_receiver_bulletproof_batch_verifier(
        self, epsilon_account: Sequence[Account], proof, defer=None,
        collector=None,
    ) -> None:
        """Aggregated 64-bit range-proof verification over the epsilon
        accounts' `d` points (verifier.rs:504-523). With `defer`, the MSM
        terms join the cross-proof batch (transcript work still happens
        here, in sequence). With `collector`
        (accounts.deferred.DeviceBatchCollector), the proof is snapshotted
        for one-program device verification and only the transcript
        advances here."""
        self.new_domain_sep(b"AggregateBulletProof")
        commitments = [acc.comm.d for acc in epsilon_account]
        if collector is not None:
            collector.add_range(proof, commitments, self.transcript.clone(),
                                _config().range_bits)
            proof.advance_transcript(self.transcript, commitments,
                                     _config().range_bits)
        elif defer is None:
            proof.verify_multiple(self.transcript, commitments,
                                  _config().range_bits)
        else:
            type(proof).batch_verify([(proof, commitments, self.transcript)],
                                     _config().range_bits,
                                     defer=defer, backend="host")

    def verify_non_negative_sender_receiver_bulletproof_vector_verifier(
        self, epsilon_account: Sequence[Account], proof_vector: Sequence,
        defer=None, collector=None,
    ) -> None:
        """Per-value range-proof verification (verifier.rs:534-555)."""
        self.new_domain_sep(b"AggregateBulletProof")
        commitments = [acc.comm.d for acc in epsilon_account]
        if collector is not None:
            for proof, com in zip(proof_vector, commitments):
                collector.add_range(proof, [com], self.transcript.clone(),
                                    _config().range_bits)
                proof.advance_transcript(self.transcript, [com],
                                         _config().range_bits)
        elif defer is None:
            for proof, com in zip(proof_vector, commitments):
                proof.verify_single(self.transcript, com,
                                    _config().range_bits)
        else:
            for proof, com in zip(proof_vector, commitments):
                type(proof).batch_verify([(proof, [com], self.transcript)],
                                         _config().range_bits,
                                         defer=defer, backend="host")

    @staticmethod
    def verify_delta_identity_check(epsilon_accounts: Sequence[Account]) -> None:
        """Sum of epsilon commitments (c and d) must be the identity."""
        sum_c = ex.IDENTITY
        sum_d = ex.IDENTITY
        for acc in epsilon_accounts:
            sum_c = ex.pt_add(sum_c, acc.comm.c_point)
            sum_d = ex.pt_add(sum_d, acc.comm.d_point)
        if _enc(sum_c) != b"\x00" * 32 or _enc(sum_d) != b"\x00" * 32:
            raise ValueError("Identity sum verify: Failed")

    @staticmethod
    def zero_balance_account_vector_verifier(
        anonymity_accounts: Sequence[Account], z: Sequence[int], x: int,
        verifier: "Verifier",
    ) -> None:
        """Note: domain separator fixed to match the prover (see prover.py —
        the reference's label typo makes its vector proof unverifiable)."""
        assert len(anonymity_accounts) == len(z)
        verifier.new_domain_sep(b"ZeroBalanceAccountVectorProof")
        for acc in anonymity_accounts:
            verifier.allocate_account(b"anonymity_account", acc)
        rows = []
        for i, acc in enumerate(anonymity_accounts):
            rows.append(([z[i], x], [acc.pk.gr_point, acc.comm.c_point]))
            rows.append(([z[i], x], [acc.pk.grsk_point, acc.comm.d_point]))
        encs = ex.ristretto_encode_batch(ex.pt_msm_many(rows))
        for i in range(len(anonymity_accounts)):
            verifier.allocate_point(b"e", encs[2 * i])
            verifier.allocate_point(b"f", encs[2 * i + 1])
        if verifier.get_challenge(b"challenge") != x % L:
            raise ValueError("Zero balance account verification failed")

    @staticmethod
    def zero_balance_account_verifier(
        account: Account, z: int, x: int, verifier: "Verifier",
    ) -> None:
        verifier.new_domain_sep(b"ZeroBalanceAccountProof")
        verifier.allocate_account(b"zero_account", account)
        e = Verifier.multiscalar_multiplication(
            [z, x], [account.pk.gr, account.comm.c])
        f = Verifier.multiscalar_multiplication(
            [z, x], [account.pk.grsk, account.comm.d])
        if e is None or f is None:
            raise ValueError("Zero balance Account Verify: Failed")
        verifier.allocate_point(b"e", _enc(e))
        verifier.allocate_point(b"f", _enc(f))
        if verifier.get_challenge(b"challenge") != x % L:
            raise ValueError("Zero balance account verification failed")

    @staticmethod
    def destroy_account_verifier(
        accounts: Sequence[Account], z: Sequence[int], x: int,
        verifier: "Verifier",
    ) -> None:
        assert len(accounts) == len(z)
        verifier.new_domain_sep(b"DestroyAccountProof")
        for acc in accounts:
            verifier.allocate_account(b"account", acc)
        rows = []
        for i, acc in enumerate(accounts):
            rows.append(([z[i], x], [acc.pk.gr_point, acc.pk.grsk_point]))
            rows.append(([z[i], x], [acc.comm.c_point, acc.comm.d_point]))
        encs = ex.ristretto_encode_batch(ex.pt_msm_many(rows))
        for i in range(len(accounts)):
            verifier.allocate_point(b"e", encs[2 * i])
            verifier.allocate_point(b"f", encs[2 * i + 1])
        if verifier.get_challenge(b"challenge") != x % L:
            raise ValueError("Destroy account verification failed")

    @staticmethod
    def verify_same_value_compact_verifier(
        enc_account: Account, commitment: bytes, proof: SigmaProof,
    ) -> None:
        pc = default_pedersen_gens()
        transcript = Transcript(b"SameValueProof")
        verifier = Verifier(b"DLEQProof", transcript)
        verifier.allocate_account(b"encrypted_account", enc_account)
        verifier.allocate_point(b"G", _enc(pc.B))
        verifier.allocate_point(b"H", _enc(pc.B_blinding))
        verifier.allocate_point(b"d", commitment)
        zv, zr, _, x = proof.get_dleq()
        f_enc = Verifier.multiscalar_multiplication(
            [zr[0], x, zv[0]],
            [enc_account.pk.grsk, enc_account.comm.d, BASEPOINT_BYTES])
        f_ped = Verifier.multiscalar_multiplication(
            [zr[0], x, zv[0]],
            [_enc(pc.B_blinding), commitment, BASEPOINT_BYTES])
        if f_enc is None or f_ped is None:
            raise ValueError("Delta Compact Proof Verify: Failed")
        verifier.allocate_point(b"f_delta", _enc(f_enc))
        verifier.allocate_point(b"f_epsilon", _enc(f_ped))
        if verifier.get_challenge(b"challenge") != x % L:
            raise ValueError("Same Value Proof Verify: Failed")

    @staticmethod
    def verify_update_account_dark_tx_verifier(
        delta_updated_accounts: Sequence[Account],
        output_accounts: Sequence[Account],
        z_vector: Sequence[int], x: int, verifier: "Verifier",
    ) -> None:
        if len(delta_updated_accounts) != len(output_accounts):
            raise ValueError(
                "Length of delta_updated_accounts and output_accounts is not same")
        e_gr, e_grsk = [], []
        for i in range(len(delta_updated_accounts)):
            p1 = Verifier.multiscalar_multiplication(
                [z_vector[0], x],
                [delta_updated_accounts[i].pk.gr, output_accounts[i].pk.gr])
            p2 = Verifier.multiscalar_multiplication(
                [z_vector[0], x],
                [delta_updated_accounts[i].pk.grsk, output_accounts[i].pk.grsk])
            if p1 is None or p2 is None:
                raise ValueError("Update Account: DLOG Proof Verify: Failed")
            e_gr.append(_enc(p1))
            e_grsk.append(_enc(p2))
        pk_comm_scalar = [o.comm - d.comm
                          for d, o in zip(delta_updated_accounts, output_accounts)]
        f_c, f_d = [], []
        for i in range(len(delta_updated_accounts)):
            p1 = Verifier.multiscalar_multiplication(
                [z_vector[1], x],
                [delta_updated_accounts[i].pk.gr, pk_comm_scalar[i].c])
            p2 = Verifier.multiscalar_multiplication(
                [z_vector[1], x],
                [delta_updated_accounts[i].pk.grsk, pk_comm_scalar[i].d])
            if p1 is None or p2 is None:
                raise ValueError("DLOG Proof Verify: Failed")
            f_c.append(_enc(p1))
            f_d.append(_enc(p2))
        verifier.new_domain_sep(b"VerifyUpdateAccountDarkTx")
        for inp, out in zip(delta_updated_accounts, output_accounts):
            verifier.allocate_account(b"account", inp)
            verifier.allocate_account(b"updatedaccount", out)
        for p1, p2 in zip(e_gr, e_grsk):
            verifier.allocate_point(b"commitmentgr", p1)
            verifier.allocate_point(b"commitmentgrsk", p2)
        for p1, p2 in zip(f_c, f_d):
            verifier.allocate_point(b"commitmentc", p1)
            verifier.allocate_point(b"commitmentd", p2)
        if verifier.get_challenge(b"challenge") != x % L:
            raise ValueError("Update Output Challenge : DLOG Proof Verify: Failed")
