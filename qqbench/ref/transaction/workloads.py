"""Transaction workloads of benchmarks.py's configs, on the reference's
classes (a frozen copy of the port's ``transaction/workloads.py``).

:func:`benchmark_requests` makes the ``create_transaction`` keyword dicts
of config 6/6b (1 sender and 1 receiver over the reference's 9 accounts,
``benchmarks.py:496-545``) and 6e (4 and 4 over 16 accounts,
``benchmarks.py:605-668``), each transaction with its own rng, so that two
calls with one tag build the same transactions.
"""

from __future__ import annotations

from ..accounts.accounts import Account
from ..accounts.transcript import SeededRng
from ..primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from .transaction import Receiver, Sender, generate_value_and_account_vector


def benchmark_requests(tag: bytes, n_tx: int, n_senders: int, n_accounts: int) -> list:
    """n_tx requests of n_senders senders, each sending 5 to its own
    receiver, over n_accounts accounts (the rest anonymity accounts)."""
    r = SeededRng(seed=tag)
    reqs = []
    for i in range(n_tx):
        senders, sks, bals = [], [], []
        for s in range(n_senders):
            sk = RistrettoSecretKey.random(r)
            acc, _ = Account.generate_account(RistrettoPublicKey.from_secret_key(sk, r), r)
            acc = Account.update_account(acc, 20 + i + s, r.random_scalar(), r.random_scalar())
            rec_pk = RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(r), r)
            senders.append(Sender(total_amount=-5, account=acc, receivers=[Receiver(5, rec_pk)]))
            sks.append(sk)
            bals.append(20 + i + s - 5)
        values, accounts, anon, diff, sc, rc = generate_value_and_account_vector(
            senders, rng=r, n=n_accounts)
        reqs.append(dict(value_vector=values, account_vector=accounts,
                         sender_updated_balance=bals, sender_sk=sks,
                         anonymity_comm_scalar=anon, anonymity_account_diff=diff,
                         receiver_updated_balance=[5] * n_senders, senders_count=sc,
                         receivers_count=rc, rng=SeededRng(seed=tag + b"-tx%d" % i)))
    return reqs
