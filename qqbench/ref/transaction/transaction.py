"""Full QuisQuis transaction orchestration.

Functional port of the reference's transaction module
(reference src/transaction/transaction.rs:28-749) with its bit-rotted
call sites repaired (the module is excluded from the reference build at
src/lib.rs:51; e.g. it calls `zero_balance_account_prover` with a slice at
transaction.rs:311 where the vector variant is required). The 12-step
bulletproof flow (transaction.rs:487-749):

 1. values -> scalars; base pk
 2. input shuffle + proof + self-verify
 3. delta/epsilon accounts (zero-sum rscalars)
 4. delta-compact DLEQ + epsilon identity check + verify
 5. update delta accounts; slice anonymity set
 6. update-account DLOG prove/verify on the anonymity slice
 7. zero-balance proof for on-the-fly anonymity accounts
 8. sender account proof (emits sender epsilon accounts)
 9. aggregated/vector 64-bit range proofs over [sender balances || receiver amounts]
10. output shuffle + proof + verify
11. assemble Transaction

Generalized beyond the reference's fixed 9: any perfect-square anonymity
set size (9, 64 = the multi-host config).

The reference's frozen copy of the port's host module: the same draw
order and transcript schedule, so the same transactions byte for byte.
Only the host paths are kept: ``create_transaction`` (steps 1-11 on the
host) and ``verify_transaction`` (one deferred MSM on the host).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..ops import exact as ex
from ..primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from ..accounts.accounts import Account
from ..accounts.transcript import Transcript, SeededRng
from ..accounts.prover import Prover
from ..accounts.verifier import Verifier
from ..shuffle.shuffle import Shuffle, ShuffleProof, ShuffleStatement

L = ex.L


@dataclass
class Receiver:
    amount: int
    public_key: RistrettoPublicKey


@dataclass
class Sender:
    total_amount: int  # negative: amount leaving the account
    account: Account
    receivers: List[Receiver]


@dataclass
class Transaction:
    input_account_vector: List[Account]
    updated_account_vector: List[Account]
    account_delta_vector: List[Account]
    account_epsilon_vector: List[Account]
    account_updated_delta_vector: List[Account]
    output_account_vector: List[Account]

    @staticmethod
    def generate_value_vector(balance: int,
                              n: Optional[int] = None) -> List[int]:
        if n is None:
            from ..config import DEFAULT
            n = DEFAULT.anonymity_set_size
        return [-balance, balance] + [0] * (n - 2)


@dataclass
class TransactionProof:
    """Everything a third party needs to verify a Transaction standalone.

    The reference's (dead) transaction module proves and immediately
    self-verifies inside creation (transaction.rs:487-749) and never
    returns the sigma responses; here the bundle is first-class so
    transactions can be verified — and *batch*-verified — by parties that
    did not build them (the serving path).
    """
    delta_dleq: Tuple[List[int], List[int], List[int], int]
    update_dlog: Tuple[List[int], int]
    zero_dlog: Tuple[List[int], int]
    sender_dleq: Tuple[List[int], List[int], List[int], int]
    epsilon_sender_accounts: List[Account]
    # the on-the-fly anonymity accounts in prover order (tx.input_account_
    # vector holds them permuted; the zero-balance DLOG is bound to this
    # order via the transcript)
    anonymity_accounts: List[Account]
    range_proofs: list
    input_shuffle_proof: ShuffleProof
    input_shuffle_statement: ShuffleStatement
    output_shuffle_proof: ShuffleProof
    output_shuffle_statement: ShuffleStatement
    senders_count: int
    receivers_count: int
    anonymity_account_diff: int


def generate_value_and_account_vector(
    tx_vector: Sequence[Sender], rng: Optional[SeededRng] = None,
    n: Optional[int] = None,
) -> Tuple[List[int], List[Account], List[int], int, int, int]:
    """Build value/account vectors, padding to n with fresh zero-balance
    anonymity accounts (transaction.rs:103-164). `n` defaults to
    config.DEFAULT.anonymity_set_size (reference: 9)."""
    if n is None:
        from ..config import DEFAULT
        n = DEFAULT.anonymity_set_size
    if rng is None:
        rng = SeededRng()
    if len(tx_vector) >= n:
        raise ValueError("account count is more than anonymity set size")
    value_vector = [s.total_amount for s in tx_vector]
    account_vector = [s.account for s in tx_vector]
    senders_count = len(tx_vector)
    receivers_count = 0
    anonymity_scalars: List[int] = []
    for sender in tx_vector:
        for rec in sender.receivers:
            receivers_count += 1
            value_vector.append(rec.amount)
            acc, _ = Account.generate_account(rec.public_key, rng)
            account_vector.append(acc)
    if not (senders_count < n and receivers_count < n
            and senders_count + receivers_count <= n):
        raise ValueError("senders and receivers count should be less than set size")
    diff = n - (senders_count + receivers_count)
    pk_anonymity = RistrettoPublicKey.update_public_key(
        account_vector[0].pk, rng.random_scalar())
    for _ in range(diff):
        value_vector.append(0)
        acc, comm_scalar = Account.generate_account(
            RistrettoPublicKey.update_public_key(pk_anonymity,
                                                 rng.random_scalar()), rng)
        account_vector.append(acc)
        anonymity_scalars.append(comm_scalar)
    return (value_vector, account_vector, anonymity_scalars, diff,
            senders_count, receivers_count)


@dataclass
class _TxBuildCtx:
    """Everything steps 1-8 produced that steps 9-11 still need.

    Splitting the 12-step flow at the range-proof boundary lets
    batch_create_transactions funnel MANY transactions' step-9 range
    proofs through ONE device program (bulletproofs.device_prove) while
    each transaction keeps its own Fiat-Shamir transcript."""
    rng: SeededRng
    n: int
    qq_prover: Prover
    qq_verifier: Verifier
    defer: object
    input_shuffle: Shuffle
    updated_accounts: list
    input_shuffle_proof: ShuffleProof
    input_shuffle_statement: ShuffleStatement
    account_vector: list
    delta_accounts: list
    epsilon_accounts: list
    updated_delta_accounts: list
    anonymity_index: int
    delta_dleq: tuple
    update_dlog: tuple
    zero_dlog: tuple
    sender_dleq: tuple
    eps_sender_accounts: list
    bl_rp_vector: list
    scalars_bp_vector: list
    bp_epsilon_vec: list
    senders_count: int
    receivers_count: int
    anonymity_account_diff: int


def _tx_pre_range(
    value_vector: Sequence[int],
    account_vector: Sequence[Account],
    sender_updated_balance: Sequence[int],
    sender_sk: Sequence[RistrettoSecretKey],
    anonymity_comm_scalar: Sequence[int],
    anonymity_account_diff: int,
    receiver_updated_balance: Sequence[int],
    senders_count: int,
    receivers_count: int,
    rng: Optional[SeededRng] = None,
) -> _TxBuildCtx:
    """Steps 1-8 of the bulletproof transaction flow (transaction.rs:487-651):
    everything before the aggregated range proofs."""
    if rng is None:
        rng = SeededRng()
    n = len(account_vector)
    assert math.isqrt(n) ** 2 == n

    value_vector_scalar = [v % L for v in value_vector]
    base_pk = RistrettoPublicKey.generate_base_pk()

    # Step 1-2: input shuffle + proof
    input_shuffle = Shuffle.input_shuffle(list(account_vector), rng=rng)
    updated_accounts = input_shuffle.get_outputs_vector()
    tp = Transcript(b"QuisQuisProof")
    qq_prover = Prover(b"QuisQuis", tp, rng=rng)
    input_shuffle_proof, input_shuffle_statement = \
        ShuffleProof.create_shuffle_proof(qq_prover, input_shuffle, rng=rng)
    tv = Transcript(b"QuisQuisProof")
    qq_verifier = Verifier(b"QuisQuis", tv)
    # self-verification point checks accumulate into ONE MSM evaluated just
    # before returning (same checks as the reference's eager loop)
    from ..accounts.deferred import DeferredPointChecks
    defer = DeferredPointChecks()
    input_shuffle_proof.verify(qq_verifier, input_shuffle_statement,
                               input_shuffle.get_inputs_vector(),
                               updated_accounts, defer=defer)

    # Step 3: delta/epsilon accounts
    delta_accounts, epsilon_accounts, delta_rscalar = \
        Account.create_delta_and_epsilon_accounts(
            updated_accounts, value_vector_scalar, base_pk, rng)

    # Step 4: delta-compact DLEQ
    zv, zr1, zr2, x = Prover.verify_delta_compact_prover(
        delta_accounts, epsilon_accounts, delta_rscalar, value_vector_scalar,
        qq_prover).get_dleq()
    Verifier.verify_delta_identity_check(epsilon_accounts)
    Verifier.verify_delta_compact_verifier(
        delta_accounts, epsilon_accounts, zv, zr1, zr2, x, qq_verifier)

    # Step 5: update delta accounts, slice anonymity set
    updated_delta_accounts = Account.update_delta_accounts(
        updated_accounts, delta_accounts)
    anonymity_index = n - anonymity_account_diff
    updated_accounts_slice = updated_accounts[anonymity_index:n]
    updated_delta_accounts_slice = updated_delta_accounts[anonymity_index:n]
    rscalars_slice = delta_rscalar[anonymity_index:n]

    # Step 6: update-account DLOG on the anonymity slice
    z_vec, x_dlog = Prover.verify_update_account_prover(
        updated_accounts_slice, updated_delta_accounts_slice, rscalars_slice,
        qq_prover).get_dlog()
    Verifier.verify_update_account_verifier(
        updated_accounts_slice, updated_delta_accounts_slice, z_vec, x_dlog,
        qq_verifier)

    # Step 7: zero-balance proof for the on-the-fly anonymity accounts
    # (reference calls the single-account prover with a slice,
    # transaction.rs:311 — repaired to the vector variant)
    z_zero, x_zero = Prover.zero_balance_account_vector_prover(
        list(account_vector[anonymity_index:n]), list(anonymity_comm_scalar),
        qq_prover).get_dlog()
    Verifier.zero_balance_account_vector_verifier(
        list(account_vector[anonymity_index:n]), z_zero, x_zero, qq_verifier)

    # Step 8: sender account proof
    updated_delta_account_sender = updated_delta_accounts[:senders_count]
    eps_sender_accounts, eps_sender_rscalars, sigma_dleq = \
        Prover.verify_account_prover(
            updated_delta_account_sender, list(sender_updated_balance),
            list(sender_sk), qq_prover, base_pk)
    zv_a, zsk_a, zr_a, x_a = sigma_dleq.get_dleq()
    Verifier.verify_account_verifier_bulletproof(
        updated_delta_account_sender, eps_sender_accounts, base_pk,
        zv_a, zsk_a, zr_a, x_a, qq_verifier)

    # Step 9 inputs: [sender updated balances || receiver amounts]
    bl_rp_vector = list(sender_updated_balance) + list(receiver_updated_balance)
    rec_rscalars_slice = delta_rscalar[senders_count:senders_count + receivers_count]
    scalars_bp_vector = list(eps_sender_rscalars) + list(rec_rscalars_slice)
    receiver_eps_slice = epsilon_accounts[senders_count:
                                          senders_count + receivers_count]
    bp_epsilon_vec = list(eps_sender_accounts) + list(receiver_eps_slice)
    return _TxBuildCtx(
        rng=rng, n=n, qq_prover=qq_prover, qq_verifier=qq_verifier,
        defer=defer, input_shuffle=input_shuffle,
        updated_accounts=updated_accounts,
        input_shuffle_proof=input_shuffle_proof,
        input_shuffle_statement=input_shuffle_statement,
        account_vector=list(account_vector),
        delta_accounts=delta_accounts, epsilon_accounts=epsilon_accounts,
        updated_delta_accounts=updated_delta_accounts,
        anonymity_index=anonymity_index,
        delta_dleq=(zv, zr1, zr2, x),
        update_dlog=(z_vec, x_dlog),
        zero_dlog=(z_zero, x_zero),
        sender_dleq=(zv_a, zsk_a, zr_a, x_a),
        eps_sender_accounts=list(eps_sender_accounts),
        bl_rp_vector=bl_rp_vector, scalars_bp_vector=scalars_bp_vector,
        bp_epsilon_vec=bp_epsilon_vec,
        senders_count=senders_count, receivers_count=receivers_count,
        anonymity_account_diff=anonymity_account_diff)


def _tx_post_range(ctx: _TxBuildCtx,
                   range_proofs: list) -> Tuple[Transaction, TransactionProof]:
    """Steps 9 (verify side) through 11 (transaction.rs:652-749), given the
    finished range proofs (host- or device-proved; the qq_prover transcript
    must already be advanced past them)."""
    qq_prover, qq_verifier, defer = ctx.qq_prover, ctx.qq_verifier, ctx.defer
    if len(range_proofs) == 1:
        qq_verifier.verify_non_negative_sender_receiver_bulletproof_batch_verifier(
            ctx.bp_epsilon_vec, range_proofs[0], defer=defer)
    else:
        qq_verifier.verify_non_negative_sender_receiver_bulletproof_vector_verifier(
            ctx.bp_epsilon_vec, range_proofs, defer=defer)

    # Step 10: output shuffle + proof (continues the same transcript,
    # transaction.rs:704-709)
    output_shuffle = Shuffle.output_shuffle(ctx.updated_delta_accounts,
                                            rng=ctx.rng)
    output_accounts = output_shuffle.get_outputs_vector()
    output_shuffle_proof, output_shuffle_statement = \
        ShuffleProof.create_shuffle_proof(qq_prover, output_shuffle,
                                          rng=ctx.rng)
    output_shuffle_proof.verify(qq_verifier, output_shuffle_statement,
                                output_shuffle.get_inputs_vector(),
                                output_accounts, defer=defer)
    defer.verify(backend="host")

    # Step 11: assemble
    tx = Transaction(
        ctx.input_shuffle.get_inputs_vector(), ctx.updated_accounts,
        ctx.delta_accounts, ctx.epsilon_accounts,
        ctx.updated_delta_accounts, output_accounts)
    tx_proof = TransactionProof(
        delta_dleq=ctx.delta_dleq,
        update_dlog=ctx.update_dlog,
        zero_dlog=ctx.zero_dlog,
        sender_dleq=ctx.sender_dleq,
        epsilon_sender_accounts=list(ctx.eps_sender_accounts),
        anonymity_accounts=list(ctx.account_vector[ctx.anonymity_index:ctx.n]),
        range_proofs=range_proofs,
        input_shuffle_proof=ctx.input_shuffle_proof,
        input_shuffle_statement=ctx.input_shuffle_statement,
        output_shuffle_proof=output_shuffle_proof,
        output_shuffle_statement=output_shuffle_statement,
        senders_count=ctx.senders_count,
        receivers_count=ctx.receivers_count,
        anonymity_account_diff=ctx.anonymity_account_diff)
    return tx, tx_proof


def create_transaction(
    value_vector: Sequence[int],
    account_vector: Sequence[Account],
    sender_updated_balance: Sequence[int],
    sender_sk: Sequence[RistrettoSecretKey],
    anonymity_comm_scalar: Sequence[int],
    anonymity_account_diff: int,
    receiver_updated_balance: Sequence[int],
    senders_count: int,
    receivers_count: int,
    rng: Optional[SeededRng] = None,
) -> Tuple[Transaction, TransactionProof]:
    """The bulletproof transaction path (create_quuisquis_transaction_bulletproof,
    transaction.rs:487-749).

    Returns the assembled Transaction plus the TransactionProof bundle for
    standalone / batched verification (verify_transaction below)."""
    ctx = _tx_pre_range(
        value_vector, account_vector, sender_updated_balance, sender_sk,
        anonymity_comm_scalar, anonymity_account_diff,
        receiver_updated_balance, senders_count, receivers_count, rng)
    # Step 9: range proofs over [sender updated balances || receiver amounts]
    range_proofs = ctx.qq_prover.verify_non_negative_sender_receiver_prover(
        ctx.bl_rp_vector, ctx.scalars_bp_vector)
    return _tx_post_range(ctx, range_proofs)


def verify_transaction(tx: Transaction, proof: TransactionProof,
                       defer=None) -> None:
    """Standalone verification of a Transaction (no prover secrets).

    Replays the exact verifier-transcript sequence of create_transaction:
    input-shuffle proof, epsilon identity, delta-compact DLEQ, the
    homomorphic delta-update consistency, update-account DLOG over the
    anonymity slice, zero-balance DLOG over the on-the-fly accounts, the
    sender-account DLEQ, the aggregated range proofs, and the
    output-shuffle proof. Raises ValueError on any failure.

    Sigma checks recompute first messages into the transcript (eager,
    2-3-term MSMs); shuffle and range point-identities are collected into
    `defer` (or a local accumulator) and evaluated as ONE MSM on `backend`.

    The port's device paths (`collector`, `backend`, `mesh`) are not
    copied: the local accumulator's MSM runs on the host.
    """
    from ..accounts.deferred import DeferredPointChecks

    own = defer is None
    if own:
        defer = DeferredPointChecks()
    n = len(tx.input_account_vector)
    sc, rc = proof.senders_count, proof.receivers_count
    anonymity_index = n - proof.anonymity_account_diff

    tv = Transcript(b"QuisQuisProof")
    qq_verifier = Verifier(b"QuisQuis", tv)

    proof.input_shuffle_proof.verify(
        qq_verifier, proof.input_shuffle_statement,
        tx.input_account_vector, tx.updated_account_vector, defer=defer)

    Verifier.verify_delta_identity_check(tx.account_epsilon_vector)
    zv, zr1, zr2, x = proof.delta_dleq
    Verifier.verify_delta_compact_verifier(
        tx.account_delta_vector, tx.account_epsilon_vector, zv, zr1, zr2, x,
        qq_verifier)

    # delta-update consistency: updated_delta == updated + delta
    # (homomorphic add; accounts.rs:225-291 semantics)
    if not Account.verify_delta_update(tx.account_updated_delta_vector,
                                       tx.account_delta_vector,
                                       tx.updated_account_vector):
        raise ValueError("Transaction Verify: delta update mismatch")

    z_vec, x_dlog = proof.update_dlog
    Verifier.verify_update_account_verifier(
        tx.updated_account_vector[anonymity_index:n],
        tx.account_updated_delta_vector[anonymity_index:n], z_vec, x_dlog,
        qq_verifier)

    # the zero-balance statement is over the pre-shuffle anonymity accounts;
    # check each is genuinely a member of the transaction's input set
    input_set = {(a.pk.gr, a.pk.grsk, a.comm.c, a.comm.d)
                 for a in tx.input_account_vector}
    for a in proof.anonymity_accounts:
        if (a.pk.gr, a.pk.grsk, a.comm.c, a.comm.d) not in input_set:
            raise ValueError(
                "Transaction Verify: anonymity account not in input set")
    z_zero, x_zero = proof.zero_dlog
    Verifier.zero_balance_account_vector_verifier(
        proof.anonymity_accounts, z_zero, x_zero, qq_verifier)

    zv_a, zsk_a, zr_a, x_a = proof.sender_dleq
    Verifier.verify_account_verifier_bulletproof(
        tx.account_updated_delta_vector[:sc], proof.epsilon_sender_accounts,
        RistrettoPublicKey.generate_base_pk(), zv_a, zsk_a, zr_a, x_a,
        qq_verifier)

    bp_epsilon_vec = (list(proof.epsilon_sender_accounts)
                      + tx.account_epsilon_vector[sc:sc + rc])
    if len(proof.range_proofs) == 1:
        qq_verifier.verify_non_negative_sender_receiver_bulletproof_batch_verifier(
            bp_epsilon_vec, proof.range_proofs[0], defer=defer)
    else:
        qq_verifier.verify_non_negative_sender_receiver_bulletproof_vector_verifier(
            bp_epsilon_vec, proof.range_proofs, defer=defer)

    proof.output_shuffle_proof.verify(
        qq_verifier, proof.output_shuffle_statement,
        tx.account_updated_delta_vector, tx.output_account_vector,
        defer=defer)

    if own:
        defer.verify(backend="host")
