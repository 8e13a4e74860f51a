"""Quisquis accounts: pk + ElGamal balance commitment.

Mirrors reference src/accounts/accounts.rs:48-347 (generate / verify /
update / delta-epsilon creation / delta update + verification), with the
reference's hard-coded 9-account loop generalized to any length
(accounts.rs:180 loops `0..9`; here `len(accounts)`).

Randomness is injected via a SeededRng for reproducibility (the reference
uses OsRng, accounts.rs:70).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..ops import exact as ex
from ..primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from ..primitives.elgamal import ElGamalCommitment
from .transcript import SeededRng


@dataclass(frozen=True)
class Account:
    pk: RistrettoPublicKey
    comm: ElGamalCommitment

    # -- constructors --------------------------------------------------------

    @staticmethod
    def set_account(pk: RistrettoPublicKey, comm: ElGamalCommitment) -> "Account":
        return Account(pk, comm)

    # -- serde: 128 bytes = 64-byte pk ‖ 64-byte commitment (the reference's
    # concatenation layouts, ristretto/keys.rs:113-134 + elgamal.rs:135-156)

    def as_bytes(self) -> bytes:
        return self.pk.as_bytes() + self.comm.to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Account":
        if len(data) != 128:
            raise ValueError("Account bytes must be 128 bytes")
        return cls(RistrettoPublicKey.from_bytes(data[:64]),
                   ElGamalCommitment.from_bytes(data[64:]))

    @staticmethod
    def generate_account(pk: RistrettoPublicKey, rng: SeededRng) -> Tuple["Account", int]:
        """Fresh zero-balance account; returns (account, commitment scalar)."""
        comm_scalar = rng.random_scalar()
        comm = ElGamalCommitment.generate_commitment(pk, comm_scalar, 0)
        return Account(pk, comm), comm_scalar

    # -- verification ---------------------------------------------------------

    def verify_account(self, sk: RistrettoSecretKey, bl: int) -> None:
        self.pk.verify_keypair(sk)
        self.comm.verify_commitment(sk, bl)

    def verify_account_keypair(self, sk: RistrettoSecretKey) -> None:
        self.pk.verify_keypair(sk)

    def decrypt_account_balance(self, sk: RistrettoSecretKey, bl: int) -> bytes:
        self.verify_account(sk, bl)
        return self.comm.decommit(sk)

    def decrypt_account_balance_value(self, sk: RistrettoSecretKey) -> int:
        self.pk.verify_keypair(sk)
        v = self.comm.decommit_value(sk)
        if v is None:
            raise ValueError("Decryption value failed.")
        return v

    def get_account(self) -> Tuple[RistrettoPublicKey, ElGamalCommitment]:
        return self.pk, self.comm

    # -- updates ---------------------------------------------------------------

    @staticmethod
    def update_account(a: "Account", bl: int, update_key_scalar: int,
                       generate_commitment_scalar: int) -> "Account":
        """pk' = c*pk; comm' = comm + Enc_pk(bl) (accounts.rs:143-154)."""
        updated_pk = RistrettoPublicKey.update_public_key(a.pk, update_key_scalar)
        new_comm = ElGamalCommitment.generate_commitment(
            a.pk, generate_commitment_scalar, bl)
        updated_comm = ElGamalCommitment.add_commitments(new_comm, a.comm)
        return Account(updated_pk, updated_comm)

    @staticmethod
    def update_accounts_batch(accounts: Sequence["Account"], bls: Sequence[int],
                              update_key_scalars: Sequence[int],
                              comm_scalars: Sequence[int]) -> List["Account"]:
        """update_account over a vector in three batches (the shuffle
        updates every account of the anonymity set at once)."""
        n = len(accounts)
        # pk'_i = c_i*(gr_i, grsk_i); new_c_i = r_i*gr_i; then one fold for
        # new_d_i = v_i*B + r_i*grsk_i
        muls = ex.pt_mul_batch(
            list(update_key_scalars) + list(update_key_scalars)
            + list(comm_scalars),
            [a.pk.gr_point for a in accounts]
            + [a.pk.grsk_point for a in accounts]
            + [a.pk.gr_point for a in accounts])
        new_d = ex.pt_fold_batch(
            [b % ex.L for b in bls], list(comm_scalars),
            [ex.BASEPOINT] * n, [a.pk.grsk_point for a in accounts])
        out = []
        for i, a in enumerate(accounts):
            pk = RistrettoPublicKey.from_points(muls[i], muls[n + i])
            comm = ElGamalCommitment.from_points(
                ex.pt_add(muls[2 * n + i], a.comm.c_point),
                ex.pt_add(new_d[i], a.comm.d_point))
            out.append(Account(pk, comm))
        return out

    @staticmethod
    def verify_account_update(updated_input_accounts: Sequence["Account"],
                              accounts: Sequence["Account"],
                              updated_keys_scalar: Sequence[int],
                              generate_commitment_scalar: Sequence[int]) -> bool:
        recomputed = [
            Account.update_account(acc, 0, uks, gcs)
            for acc, uks, gcs in zip(accounts, updated_keys_scalar,
                                     generate_commitment_scalar)
        ]
        return all(u == i for u, i in zip(recomputed, updated_input_accounts))

    # -- delta / epsilon --------------------------------------------------------

    @staticmethod
    def create_delta_and_epsilon_accounts(
        accounts: Sequence["Account"], bl: Sequence[int],
        base_pk: RistrettoPublicKey, rng: SeededRng,
    ) -> Tuple[List["Account"], List["Account"], List[int]]:
        """Delta: Enc_pk_i(v_i, r_i); epsilon: Enc_base_pk(v_i, r_i); sum r = 0."""
        n = len(accounts)
        rscalar = Account.generate_sum_and_negate_rscalar(n, rng)
        vals = [b % ex.L for b in bl]
        # all 2n commitments in two batches:
        # c_i = r_i*gr_i; d_i = v_i*B + r_i*grsk_i
        c_pts = ex.pt_mul_batch(
            rscalar + rscalar,
            [acc.pk.gr_point for acc in accounts] + [base_pk.gr_point] * n)
        d_pts = ex.pt_fold_batch(
            vals + vals, rscalar + rscalar, [ex.BASEPOINT] * (2 * n),
            [acc.pk.grsk_point for acc in accounts]
            + [base_pk.grsk_point] * n)
        delta = [Account(acc.pk, ElGamalCommitment.from_points(c, d))
                 for acc, c, d in zip(accounts, c_pts[:n], d_pts[:n])]
        epsilon = [Account(base_pk, ElGamalCommitment.from_points(c, d))
                   for c, d in zip(c_pts[n:], d_pts[n:])]
        return delta, epsilon, rscalar

    @staticmethod
    def update_delta_accounts(updated_accounts: Sequence["Account"],
                              delta_accounts: Sequence["Account"]) -> List["Account"]:
        if not all(u.pk == d.pk for u, d in zip(updated_accounts, delta_accounts)):
            raise ValueError("pks are not equal")
        return [
            Account(u.pk, ElGamalCommitment.add_commitments(u.comm, d.comm))
            for u, d in zip(updated_accounts, delta_accounts)
        ]

    @staticmethod
    def verify_delta_update(updated_delta_accounts: Sequence["Account"],
                            delta_accounts: Sequence["Account"],
                            updated_input_accounts: Sequence["Account"]) -> bool:
        if not all(u.pk == d.pk for u, d in zip(updated_delta_accounts, delta_accounts)):
            raise ValueError("pks are not equal")
        if not all(u.pk == i.pk for u, i in zip(updated_delta_accounts,
                                                updated_input_accounts)):
            raise ValueError("pks are not equal")
        added = [
            ElGamalCommitment.add_commitments(d.comm, i.comm)
            for d, i in zip(delta_accounts, updated_input_accounts)
        ]
        return all(u.comm == a for u, a in zip(updated_delta_accounts, added))

    @staticmethod
    def create_epsilon_account(base_pk: RistrettoPublicKey, rscalar: int,
                               bl: int) -> "Account":
        if bl < 0:
            raise ValueError("Not enough balance in the sender account")
        comm = ElGamalCommitment.generate_commitment(base_pk, rscalar, bl)
        return Account(base_pk, comm)

    # -- misc ---------------------------------------------------------------------

    @staticmethod
    def generate_sum_and_negate_rscalar(length: int, rng: SeededRng) -> List[int]:
        scalars = [rng.random_scalar() for _ in range(length - 1)]
        scalars.append((-sum(scalars)) % ex.L)
        return scalars

    @staticmethod
    def generate_random_account_with_value(
        amount: int, rng: SeededRng,
    ) -> Tuple["Account", RistrettoSecretKey]:
        sk = RistrettoSecretKey.random(rng)
        pk = RistrettoPublicKey.from_secret_key(sk, rng)
        acc, _ = Account.generate_account(pk, rng)
        updated_keys_scalar = rng.random_scalar()
        comm_scalar = rng.random_scalar()
        return Account.update_account(acc, amount, updated_keys_scalar, comm_scalar), sk
