"""Demo CLI (equivalent of the reference's `quisquisbin`,
reference src/bin.rs:15-117): keygen -> account -> update -> pk
update/verify -> base pk -> commitments add; plus a full-transaction demo.

Run: python -m quisquis_tpu_torch.cli [--tx | --batch N | --serve N]

Every path here is a host path (the C++ curve and STROBE), as in the JAX
package's CLI: an interactive demo should not pay for a device instance's
set-up. The services' device backends, the daemon and chip_smoke.py drive
the card.
"""

from __future__ import annotations

from .ops import exact as ex
from .primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from .primitives.elgamal import ElGamalCommitment
from .accounts.accounts import Account
from .accounts.transcript import SeededRng


def main() -> None:
    rng = SeededRng()
    print("== quisquis_tpu_torch demo ==")

    sk = RistrettoSecretKey.random(rng)
    pk = RistrettoPublicKey.from_secret_key(sk, rng)
    print(f"secret key : {sk.as_bytes().hex()}")
    print(f"public key : {pk.as_bytes().hex()}")

    acc, comm_scalar = Account.generate_account(pk, rng)
    print(f"account    : pk={acc.pk.as_bytes().hex()[:32]}.. "
          f"comm={acc.comm.to_bytes().hex()[:32]}..")
    acc.verify_account(sk, 0)
    print("verify_account(0)          : OK")

    updated = Account.update_account(acc, 16, rng.random_scalar(),
                                     rng.random_scalar())
    updated.verify_account(sk, 16)
    print("update_account(+16) verify : OK")

    update_scalar = rng.random_scalar()
    updated_pk = RistrettoPublicKey.update_public_key(pk, update_scalar)
    assert RistrettoPublicKey.verify_public_key_update(updated_pk, pk,
                                                       update_scalar)
    print("pk update + verify         : OK")

    base_pk = RistrettoPublicKey.generate_base_pk()
    print(f"base pk    : {base_pk.as_bytes().hex()[:32]}..")

    c1 = ElGamalCommitment.generate_commitment(pk, rng.random_scalar(), 16)
    c2 = ElGamalCommitment.generate_commitment(pk, rng.random_scalar(), 26)
    added = ElGamalCommitment.add_commitments(c1, c2)
    added.verify_commitment(sk, 42)
    print("commitment add (16+26=42)  : OK")

    print(f"decommit(42) == 42         : "
          f"{added.decommit_value(sk, max_value=1 << 16) == 42}")


def tx_demo() -> None:
    """Full QuisQuis transaction: shuffle proofs, sigma proofs, range
    proofs over a 9-account anonymity set (transaction.rs:487-749 flow)."""
    import time
    from .transaction.transaction import (Sender, Receiver, create_transaction,
                                          generate_value_and_account_vector,
                                          verify_transaction)

    rng = SeededRng(seed=b"cli-tx-demo")
    print("== quisquis_tpu_torch full-transaction demo ==")
    sk = RistrettoSecretKey.random(rng)
    pk = RistrettoPublicKey.from_secret_key(sk, rng)
    acc, _ = Account.generate_account(pk, rng)
    acc = Account.update_account(acc, 10, rng.random_scalar(),
                                 rng.random_scalar())
    rec_sk = RistrettoSecretKey.random(rng)
    rec_pk = RistrettoPublicKey.from_secret_key(rec_sk, rng)
    sender = Sender(total_amount=-5, account=acc,
                    receivers=[Receiver(5, rec_pk)])
    values, accounts, anon_scalars, diff, sc, rc = \
        generate_value_and_account_vector([sender], rng=rng)
    print(f"anonymity set              : {len(accounts)} accounts "
          f"(sender 1, receiver 1, anonymity {diff})")
    t0 = time.perf_counter()
    tx, tx_proof = \
        create_transaction(
            values, accounts, sender_updated_balance=[10 - 5],
            sender_sk=[sk], anonymity_comm_scalar=anon_scalars,
            anonymity_account_diff=diff, receiver_updated_balance=[5],
            senders_count=sc, receivers_count=rc, rng=rng)
    dt = time.perf_counter() - t0
    print(f"transaction built+verified : OK ({dt*1e3:.0f} ms; "
          f"{len(tx_proof.range_proofs)} range proof(s), 2 shuffle proofs)")
    t0 = time.perf_counter()
    verify_transaction(tx, tx_proof, backend="host")
    dt = time.perf_counter() - t0
    print(f"standalone verification    : OK ({dt*1e3:.0f} ms, "
          "one combined MSM)")
    tx.account_updated_delta_vector[0].verify_account(sk, 5)
    print("sender delta balance (5)   : OK")
    total = ex.IDENTITY
    for e in tx.account_epsilon_vector:
        total = ex.pt_add(total, e.comm.d_point)
    assert ex.ristretto_encode(total) == b"\x00" * 32
    print("epsilon conservation check : OK")


def batch_demo(count: int = 4) -> None:
    """Serving path: build `count` transactions, then verify them all with
    ONE combined MSM (batch_verify_transactions)."""
    import time
    from .transaction.transaction import (Sender, Receiver, create_transaction,
                                          generate_value_and_account_vector,
                                          batch_verify_transactions)

    rng = SeededRng(seed=b"cli-batch-demo")
    print(f"== quisquis_tpu_torch batch-verification demo ({count} transactions) ==")
    items = []
    t0 = time.perf_counter()
    for i in range(count):
        sk = RistrettoSecretKey.random(rng)
        pk = RistrettoPublicKey.from_secret_key(sk, rng)
        acc, _ = Account.generate_account(pk, rng)
        acc = Account.update_account(acc, 10 + i, rng.random_scalar(),
                                     rng.random_scalar())
        rec_pk = RistrettoPublicKey.from_secret_key(
            RistrettoSecretKey.random(rng), rng)
        sender = Sender(total_amount=-5, account=acc,
                        receivers=[Receiver(5, rec_pk)])
        values, accounts, anon_scalars, diff, sc, rc = \
            generate_value_and_account_vector([sender], rng=rng)
        items.append(create_transaction(
            values, accounts, sender_updated_balance=[10 + i - 5],
            sender_sk=[sk], anonymity_comm_scalar=anon_scalars,
            anonymity_account_diff=diff, receiver_updated_balance=[5],
            senders_count=sc, receivers_count=rc, rng=rng))
    dt = time.perf_counter() - t0
    print(f"built {count} transactions    : {dt*1e3:.0f} ms")
    t0 = time.perf_counter()
    # explicit host backend: "auto" resolves the card first, and an
    # interactive demo should not need one
    batch_verify_transactions(items, backend="host")
    dt = time.perf_counter() - t0
    print(f"batch verification         : OK ({dt*1e3:.0f} ms total, "
          f"{dt*1e3/count:.1f} ms/tx, one combined MSM)")


def serve_demo(count: int = 16) -> None:
    """Production serving path: multi-process proving + verification
    services over the wire format (serving.py)."""
    import os
    import time
    from .serving import VerificationService, ProvingService, BuildRequest

    rng = SeededRng(seed=b"cli-serve-demo")
    workers = os.cpu_count() or 1
    print(f"== quisquis_tpu_torch serving demo ({count} transactions, "
          f"{workers} worker processes) ==")
    reqs = []
    for i in range(count):
        sk = RistrettoSecretKey.random(rng)
        pk = RistrettoPublicKey.from_secret_key(sk, rng)
        acc, _ = Account.generate_account(pk, rng)
        acc = Account.update_account(acc, 10 + i, rng.random_scalar(),
                                     rng.random_scalar())
        rec_pk = RistrettoPublicKey.from_secret_key(
            RistrettoSecretKey.random(rng), rng)
        reqs.append(BuildRequest(acc.as_bytes(), sk.as_bytes(), 5,
                                 rec_pk.as_bytes(), 10 + i - 5))
    with ProvingService(workers=workers, seed=b"pp") as pp:
        pp.build(reqs[:1])
        t0 = time.perf_counter()
        pairs = pp.build(reqs)
        dt = time.perf_counter() - t0
        print(f"proving service            : built {len(pairs)} wire tx in "
              f"{dt*1e3:.0f} ms ({count/dt:.1f} tx/s)")
    wire_kb = sum(len(a) + len(b) for a, b in pairs) / 1024
    print(f"wire size                  : {wire_kb:.1f} KiB total "
          f"({wire_kb/count:.1f} KiB/tx)")
    with VerificationService(workers=workers, seed=b"vv", backend="host") as svc:
        svc.verify_wire(pairs[:1])
        t0 = time.perf_counter()
        n = svc.verify_wire(pairs)
        dt = time.perf_counter() - t0
        print(f"verification service       : OK, {n} tx in {dt*1e3:.0f} ms "
              f"({n/dt:.1f} tx/s)")


if __name__ == "__main__":
    import sys as _sys

    if "--serve" in _sys.argv:
        idx = _sys.argv.index("--serve")
        n = int(_sys.argv[idx + 1]) if len(_sys.argv) > idx + 1 else 16
        serve_demo(n)
    elif "--batch" in _sys.argv:
        idx = _sys.argv.index("--batch")
        n = int(_sys.argv[idx + 1]) if len(_sys.argv) > idx + 1 else 4
        batch_demo(n)
    elif "--tx" in _sys.argv:
        tx_demo()
    else:
        main()
