"""Device-batched account operations.

Batch counterparts of the Account-layer hot paths: delta/epsilon account
creation (accounts.rs:198-220, 2n ElGamal commitments) and bulk account
updates run on the device over the whole account vector; only the
compressed 64-byte wire forms return to the host.

Byte-identical to the host Account methods given the same SeededRng
(tests/test_torch_accounts.py).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..device import resolve_device
from ..ops import batch as qb
from ..ops import cuda_point as kp
from ..ops import exact as ex
from ..primitives.elgamal import ElGamalCommitment
from ..primitives.keys import RistrettoPublicKey
from .accounts import Account
from .transcript import SeededRng

L = ex.L


def _comm_to_host(comm: qb.BatchCommitment) -> List[ElGamalCommitment]:
    c_bytes = kp.encode_bytes(comm.c).cpu().numpy()
    d_bytes = kp.encode_bytes(comm.d).cpu().numpy()
    return [ElGamalCommitment(bytes(cb), bytes(db)) for cb, db in zip(c_bytes, d_bytes)]


def create_delta_and_epsilon_accounts_device(
    accounts: Sequence[Account], bl: Sequence[int],
    base_pk: RistrettoPublicKey, rng: SeededRng, device="cuda",
) -> Tuple[List[Account], List[Account], List[int]]:
    """Device-batched Account.create_delta_and_epsilon_accounts.

    Draws rscalars in the same order as the host version, so outputs are
    byte-identical for the same rng state.
    """
    dev = resolve_device(device)
    n = len(accounts)
    rscalar = Account.generate_sum_and_negate_rscalar(n, rng)
    pk_dev = qb.pks_to_device([a.pk for a in accounts], dev)
    base_dev = qb.pks_to_device([base_pk] * n, dev)
    r_nib = qb.scalars_to_device(rscalar, dev)
    v_nib = qb.scalars_to_device([v % L for v in bl], dev)
    delta_host = _comm_to_host(qb.generate_commitments(pk_dev, r_nib, v_nib))
    eps_host = _comm_to_host(qb.generate_commitments(base_dev, r_nib, v_nib))
    delta = [Account(a.pk, c) for a, c in zip(accounts, delta_host)]
    epsilon = [Account(base_pk, c) for c in eps_host]
    return delta, epsilon, rscalar


def update_accounts_device(
    accounts: Sequence[Account], bl: Sequence[int],
    update_key_scalars: Sequence[int],
    commitment_scalars: Sequence[int], device="cuda",
) -> List[Account]:
    """Device-batched Account.update_account over an account vector."""
    dev = resolve_device(device)
    new_pk, new_comm = qb.update_accounts(
        qb.pks_to_device([a.pk for a in accounts], dev),
        qb.comms_to_device([a.comm for a in accounts], dev),
        qb.scalars_to_device([v % L for v in bl], dev),
        qb.scalars_to_device(list(update_key_scalars), dev),
        qb.scalars_to_device(list(commitment_scalars), dev))
    gr_bytes = kp.encode_bytes(new_pk.gr).cpu().numpy()
    grsk_bytes = kp.encode_bytes(new_pk.grsk).cpu().numpy()
    comm_host = _comm_to_host(new_comm)
    return [
        Account(RistrettoPublicKey(bytes(g), bytes(h)), c)
        for g, h, c in zip(gr_bytes, grsk_bytes, comm_host)
    ]
