"""The port's transaction layer (``transaction/transaction.py``) against the
JAX package's host functions, on the CPU (mirrors tests/test_transaction.py
and tests/test_device_transaction.py): under the same seeds the port builds
the JAX package's transactions field for field, bulletproof and R1CS paths,
at n = 9 with 1 + 1 and 2 + 2 values; it verifies the JAX-made ones carried
across by ``interop.host_object_from_jax``; it rejects tampered ones and an
insufficient balance; and the collector's advance-only replay leaves the
transcript where the full host replay does. Everything is exact: equal
bytes and ints (``workloads.comparable``)."""

import dataclasses

import pytest
import torch

from quisquis_tpu.accounts.accounts import Account as JaxAccount
from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.primitives.keys import RistrettoPublicKey as JaxPk
from quisquis_tpu.primitives.keys import RistrettoSecretKey as JaxSk
from quisquis_tpu.transaction import transaction as jtx
from quisquis_tpu_torch import interop
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks, DeviceBatchCollector
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.accounts.verifier import Verifier
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops.device_strobe import snapshot_host_strobe
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from quisquis_tpu_torch.transaction import transaction as ptx
from quisquis_tpu_torch.transaction.workloads import comparable

PORT = (Account, RistrettoPublicKey, RistrettoSecretKey, SeededRng, ptx)
JAX = (JaxAccount, JaxPk, JaxSk, JaxSeededRng, jtx)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


def request(side, tag: bytes, n_senders: int, balance: int = 20, n: int = 9):
    """A create_transaction request on one side's classes: n_senders senders
    of `balance` each sending 5 to a receiver of their own."""
    acc_cls, pk_cls, sk_cls, rng_cls, tx = side
    r = rng_cls(seed=tag)
    senders, sks = [], []
    for _ in range(n_senders):
        sk = sk_cls.random(r)
        acc, _ = acc_cls.generate_account(pk_cls.from_secret_key(sk, r), r)
        acc = acc_cls.update_account(acc, balance, r.random_scalar(), r.random_scalar())
        rec = pk_cls.from_secret_key(sk_cls.random(r), r)
        senders.append(tx.Sender(-5, acc, [tx.Receiver(5, rec)]))
        sks.append(sk)
    values, accounts, anon, diff, sc, rc = tx.generate_value_and_account_vector(
        senders, rng=r, n=n)
    return dict(value_vector=values, account_vector=accounts,
                sender_updated_balance=[balance - 5] * n_senders, sender_sk=sks,
                anonymity_comm_scalar=anon, anonymity_account_diff=diff,
                receiver_updated_balance=[5] * n_senders, senders_count=sc,
                receivers_count=rc, rng=r)


def _reversed_outputs(tx):
    return dataclasses.replace(tx, output_account_vector=list(reversed(tx.output_account_vector)))


@pytest.mark.parametrize("n_senders", [1, 2])
def test_create_transaction_equals_jax_and_verifies(n_senders):
    tag = b"tx-eq-%d" % n_senders
    made = ptx.create_transaction(**request(PORT, tag, n_senders))
    jax_made = interop.host_object_from_jax(jtx.create_transaction(**request(JAX, tag, n_senders)))
    assert comparable(made) == comparable(jax_made)
    assert len(made[1].range_proofs) == 1   # 2 or 4 values: one aggregated proof
    ptx.verify_transaction(*jax_made, backend="host")
    ptx.verify_transaction_auto(*jax_made, backend="host")
    with pytest.raises(ValueError):
        ptx.verify_transaction(_reversed_outputs(jax_made[0]), jax_made[1], backend="host")
    # the updated delta balances still decrypt to the senders' balances
    req = request(PORT, tag, n_senders)
    for i, sk in enumerate(req["sender_sk"]):
        made[0].account_updated_delta_vector[i].verify_account(sk, 15)


@pytest.mark.parametrize("n_senders", [1, 2])
def test_create_transaction_r1cs_equals_jax_and_verifies(n_senders):
    tag = b"tx-r1cs-%d" % n_senders
    made = ptx.create_transaction_r1cs(**request(PORT, tag, n_senders))
    jax_made = interop.host_object_from_jax(
        jtx.create_transaction_r1cs(**request(JAX, tag, n_senders)))
    assert comparable(made) == comparable(jax_made)
    ptx.verify_transaction_r1cs(*jax_made, backend="host")
    ptx.verify_transaction_auto(*jax_made, backend="host")
    with pytest.raises(ValueError):
        ptx.verify_transaction_r1cs(_reversed_outputs(jax_made[0]), jax_made[1],
                                    backend="host")


def test_generate_value_and_account_vector_equals_jax():
    got, want = request(PORT, b"tx-vec", 2), request(JAX, b"tx-vec", 2)
    keys = ("value_vector", "account_vector", "anonymity_comm_scalar",
            "anonymity_account_diff", "senders_count", "receivers_count")
    assert comparable([got[k] for k in keys]) == \
        comparable(interop.host_object_from_jax([want[k] for k in keys]))
    assert got["value_vector"] == [-5, -5, 5, 5, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError):
        ptx.generate_value_and_account_vector([], n=0)


def test_insufficient_balance_detected():
    """A sender balance of 3 sending 5: the claimed remainder 2^64 - 2 is out
    of range, and the transaction's self-verification refuses it."""
    req = request(PORT, b"tx-bad", 1, balance=3)
    req["sender_updated_balance"] = [2**64 - 2]
    with pytest.raises((ValueError, AssertionError)):
        ptx.create_transaction(**req)


def test_batch_verify_host_with_workers_and_rejects_one_bad_transaction():
    """The serial host replay into one combined MSM ("host"; "auto" takes it
    too) accepts two honest transactions and rejects a batch with one bad
    one; the combined MSM on the device's plain versions ("device") gives
    the same verdicts. (The JAX package's threaded ``workers=`` replay is
    not ported.)"""
    items = [ptx.create_transaction(**request(PORT, b"tx-batch-%d" % i, 1)) for i in range(2)]
    bad = [(_reversed_outputs(items[0][0]), items[0][1]), items[1]]
    for backend in ("host", "auto", "device"):
        ptx.batch_verify_transactions(items, backend=backend, seed=b"w", device="cpu")
        with pytest.raises(ValueError):
            ptx.batch_verify_transactions(bad, backend=backend, seed=b"w", device="cpu")


def test_collector_advance_matches_full_replay():
    """The advance-only replay leaves the verifier transcript byte for byte
    where the full host replay leaves it, and the sigma checks that follow
    it pass: the collected proofs then wait for the device."""
    tx, proof = ptx.create_transaction(**request(PORT, b"tx-collect", 1))
    ptx.verify_transaction(tx, proof, backend="host")
    full = Verifier(b"QuisQuis", Transcript(b"QuisQuisProof"))
    proof.input_shuffle_proof.verify(full, proof.input_shuffle_statement,
                                     tx.input_account_vector, tx.updated_account_vector)
    advanced = Verifier(b"QuisQuis", Transcript(b"QuisQuisProof"))
    proof.input_shuffle_proof.advance_transcript(advanced, proof.input_shuffle_statement,
                                                 tx.input_account_vector)
    assert snapshot_host_strobe(advanced.transcript.strobe) == \
        snapshot_host_strobe(full.transcript.strobe)
    collector = DeviceBatchCollector()
    defer = DeferredPointChecks(b"\x11" * 32)
    ptx.verify_transaction(tx, proof, defer=defer, collector=collector)
    defer.verify(backend="host")
    assert len(collector.shuffle_entries) == 2
    assert sum(len(v) for v in collector.range_instances.values()) == 1


def test_multi_gpu_waits_for_its_port():
    tx, proof = ptx.create_transaction(**request(PORT, b"tx-mesh", 1))
    r1cs = ptx.create_transaction_r1cs(**request(PORT, b"tx-mesh-r1cs", 1))
    for call, (t, p) in ((ptx.verify_transaction, (tx, proof)),
                         (ptx.verify_transaction_r1cs, r1cs)):
        with pytest.raises(ValueError, match="sharded backend requires a mesh"):
            call(t, p, backend="sharded")
    with pytest.raises(ValueError, match="sharded backend requires a mesh"):
        ptx.batch_verify_transactions([(tx, proof)], backend="sharded")
    # as in the JAX package, only the sharded backend reads a mesh
    ptx.batch_verify_transactions([(tx, proof)], backend="host", mesh=object())
    with pytest.raises(ValueError, match="unknown backend"):
        ptx.batch_verify_transactions([(tx, proof)], backend="tpu", device="cpu")
    # the conservation law: the epsilon accounts' d points sum to the identity
    total = ex.IDENTITY
    for e in tx.account_epsilon_vector:
        total = ex.pt_add(total, e.comm.d_point)
    assert ex.ristretto_encode(total) == b"\x00" * 32
