"""The port's device-batched account operations, run on the CPU, against
the JAX package and the port's own host Account methods (mirrors
tests/test_device_accounts.py): as_bytes()-identical outputs for the same
SeededRng seeds.

Delta/epsilon creation is compared with the JAX package's device_accounts
and its host Account method, at the batch of 8 that tests/test_torch_batch.py
also gives the JAX generate_commitments: both files compile that one program
at one shape, so whichever runs second finds it in the JAX compilation cache.
Updates are compared with the JAX host Account.update_account, which
tests/test_device_accounts.py holds byte-identical to its device version;
this keeps the JAX update program's 26 s compile out of this file."""

import pytest
import torch

from quisquis_tpu.accounts import device_accounts as jda
from quisquis_tpu.accounts.accounts import Account as JAccount
from quisquis_tpu.accounts.transcript import SeededRng as JSeededRng
from quisquis_tpu.primitives.keys import RistrettoPublicKey as JPk
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.device_accounts import (
    create_delta_and_epsilon_accounts_device, update_accounts_device)
from quisquis_tpu_torch.accounts.transcript import SeededRng
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey

L = ex.L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_accounts(r, n=8):
    out = []
    for _ in range(n):
        sk = RistrettoSecretKey.random(r)
        pk = RistrettoPublicKey.from_secret_key(sk, r)
        acc, _ = Account.generate_account(pk, r)
        out.append(acc)
    return out


def to_jax(accounts):
    return [JAccount.from_bytes(a.as_bytes()) for a in accounts]


def test_update_accounts_device_matches_jax_and_host():
    r = SeededRng(seed=b"upd-dev")
    accounts = make_accounts(r)
    bl = [7] * 6 + [0, L - 1]
    uks = [r.random_scalar() for _ in range(8)]
    cs = [r.random_scalar() for _ in range(8)]
    dev = update_accounts_device(accounts, bl, uks, cs, device="cpu")
    host = [Account.update_account(a, b, u, c) for a, b, u, c in zip(accounts, bl, uks, cs)]
    jax_out = [JAccount.update_account(a, b, u, c)
               for a, b, u, c in zip(to_jax(accounts), bl, uks, cs)]
    assert [a.as_bytes() for a in dev] == [a.as_bytes() for a in host]
    assert [a.as_bytes() for a in dev] == [a.as_bytes() for a in jax_out]


def test_delta_epsilon_device_matches_jax_and_host():
    base_pk = RistrettoPublicKey.generate_base_pk()
    values = [(-5) % L, 5, 0, 0, 0, 0, 0, 0]
    accounts = make_accounts(SeededRng(seed=b"da"))
    d_d, e_d, rs_d = create_delta_and_epsilon_accounts_device(
        accounts, values, base_pk, SeededRng(seed=b"db"), device="cpu")
    d_h, e_h, rs_h = Account.create_delta_and_epsilon_accounts(
        accounts, values, base_pk, SeededRng(seed=b"db"))
    jax_accounts, jax_base = to_jax(accounts), JPk.generate_base_pk()
    d_j, e_j, rs_j = jda.create_delta_and_epsilon_accounts_device(
        jax_accounts, values, jax_base, JSeededRng(seed=b"db"))
    d_jh, e_jh, rs_jh = JAccount.create_delta_and_epsilon_accounts(
        jax_accounts, values, jax_base, JSeededRng(seed=b"db"))
    assert rs_d == rs_h == rs_j == rs_jh
    assert [a.as_bytes() for a in d_d] == [a.as_bytes() for a in d_h] == \
        [a.as_bytes() for a in d_j] == [a.as_bytes() for a in d_jh]
    assert [a.as_bytes() for a in e_d] == [a.as_bytes() for a in e_h] == \
        [a.as_bytes() for a in e_j] == [a.as_bytes() for a in e_jh]
