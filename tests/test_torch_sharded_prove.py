"""The sharded device provers on the CPU, the counterpart of
tests/test_sharded_prove.py: ``DeviceRangeProver.prove_sharded`` at n = 8,
m = 1, B = 2 equals the JAX host ``RangeProof.prove_multiple`` and the
port's single-device ``prove()`` byte for byte on every lane, and
``DeviceShuffleProver.prove_sharded`` at m = 2, B = 2 equals the JAX host
``create_shuffle_proof`` field for field, on two ranks of
``parallel.launch(..., device="cpu")`` (gloo); a rejected input raises the
prover's ValueError on both ranks. And the multi-GPU dry run, ``python -m
quisquis_tpu_torch.entry --dryrun 2 --device cpu``, ends in OK. The ranks
and the dry run run once, at the same time, in a module fixture with hard
time limits, while this process runs the references."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from quisquis_tpu.accounts.accounts import Account as JaxAccount
from quisquis_tpu.accounts.prover import Prover as JaxProver
from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.bulletproofs.range_proof import RangeProof as JaxRangeProof
from quisquis_tpu.primitives.keys import RistrettoPublicKey as JaxPk
from quisquis_tpu.primitives.keys import RistrettoSecretKey as JaxSk
from quisquis_tpu.shuffle.shuffle import Shuffle as JaxShuffle
from quisquis_tpu.shuffle.shuffle import ShuffleProof as JaxShuffleProof
from quisquis_tpu_torch import parallel
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.transcript import SeededRng
from quisquis_tpu_torch.bulletproofs import device_prove as rdp
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from quisquis_tpu_torch.shuffle.shuffle import Shuffle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "quisquis_tpu_torch.parallel.programs:run_calls"
N_BITS, B = 8, 2
VALUES = [[3], [250]]
RANGE_SEEDS = [b"torch-sharded-prove-range-%d" % i for i in range(B)]
SHUFFLE_SEEDS = [b"torch-sharded-prove-shuffle-%d" % i for i in range(B)]
DRYRUN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _accounts(account_cls, pk_cls, sk_cls, rng_cls):
    rng = rng_cls(seed=b"torch-sharded-prove-accounts")
    return [account_cls.generate_account(pk_cls.from_secret_key(sk_cls.random(rng), rng), rng)[0]
            for _ in range(4)]


def _shuffles(shuffle_cls, accounts, rng_cls):
    return [shuffle_cls.input_shuffle(accounts, rng=rng_cls(seed=b"s%d" % i)) for i in range(B)]


@pytest.fixture(scope="module")
def runs():
    """(the ranks' reports, the dry run's process result, the references)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    dryrun = subprocess.Popen([sys.executable, "-m", "quisquis_tpu_torch.entry", "--dryrun", "2",
                               "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    try:
        blinds = [[SeededRng(seed=b"blind-%d" % i).random_scalar()] for i in range(B)]
        shuffles = _shuffles(Shuffle, _accounts(Account, RistrettoPublicKey, RistrettoSecretKey,
                                                SeededRng), SeededRng)
        first = shuffles[0]
        bad_pk = RistrettoPublicKey(b"\xff" * 32, first.outputs[0].pk.grsk)
        bad_shuffle = Shuffle(first.inputs,
                              [Account(bad_pk, first.outputs[0].comm)] + first.outputs[1:],
                              first.shuffled_tau, first.rho, first.pi)
        range_rngs = [SeededRng(seed=s) for s in RANGE_SEEDS]
        shuffle_rngs = [SeededRng(seed=s) for s in SHUFFLE_SEEDS]
        calls = [("range", "range_prove", (N_BITS, 1, VALUES, blinds, range_rngs)),
                 ("shuffle", "shuffle_prove", (2, shuffles, shuffle_rngs)),
                 ("range value out of range on rank 1", "range_prove",
                  (N_BITS, 1, [VALUES[0], [256]], blinds, range_rngs)),
                 ("shuffle undecodable on rank 0", "shuffle_prove",
                  (2, [bad_shuffle, shuffles[1]], shuffle_rngs))]
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(parallel.launch, PROGRAM, 2, device="cpu", timeout_s=150,
                                args=(calls,))
            refs = {"jax range": [
                JaxRangeProof.prove_multiple(JaxTranscript(b"RangeProof"), VALUES[i], blinds[i],
                                             N_BITS, rng=JaxSeededRng(seed=RANGE_SEEDS[i]))
                for i in range(B)]}
            jax_shuffles = _shuffles(JaxShuffle, _accounts(JaxAccount, JaxPk, JaxSk, JaxSeededRng),
                                     JaxSeededRng)
            refs["jax shuffle"] = []
            for i, sh in enumerate(jax_shuffles):
                lane = JaxSeededRng(seed=SHUFFLE_SEEDS[i])
                refs["jax shuffle"].append(JaxShuffleProof.create_shuffle_proof(
                    JaxProver(b"Shuffle", JaxTranscript(b"ShuffleProof"), rng=lane), sh,
                    rng=lane))
            refs["prove"] = rdp.get_device_range_prover(N_BITS, 1, B, device="cpu").prove(
                VALUES, blinds, [SeededRng(seed=s) for s in RANGE_SEEDS])
            reports = ranks.result()
        out, _ = dryrun.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.wait()
    return reports, (dryrun.returncode, out), refs


def _outcomes(runs, label):
    reports = runs[0]
    assert [r["backend"] for r in reports] == ["gloo"] * 2
    return [r[label]["outcome"] for r in reports]


def test_range_prove_sharded_equals_jax_host_and_prove(runs):
    refs = runs[2]
    outs = _outcomes(runs, "range")
    assert outs[0] == outs[1] and outs[0][0] == "ok"
    blobs, vlists = outs[0][1]
    for i in range(B):
        jax_proof, jax_v = refs["jax range"][i]
        assert blobs[i] == jax_proof.to_bytes(), f"lane {i}: bytes differ from the JAX host"
        assert vlists[i] == list(jax_v)
        assert blobs[i] == refs["prove"][0][i].to_bytes() and vlists[i] == refs["prove"][1][i]


def test_shuffle_prove_sharded_equals_jax_host_field_for_field(runs):
    outs = _outcomes(runs, "shuffle")
    assert outs[0] == outs[1] and outs[0][0] == "ok"
    for i, (proof, statement) in enumerate(outs[0][1]):
        jax_proof, jax_statement = runs[2]["jax shuffle"][i]
        assert proof == host_object_from_jax(jax_proof), f"lane {i}: proof differs"
        assert statement == host_object_from_jax(jax_statement), f"lane {i}: statement differs"


def test_rejected_input_raises_on_both_ranks(runs):
    assert _outcomes(runs, "range value out of range on rank 1") == \
        [("ValueError", "value out of range for 8-bit proof")] * 2
    assert _outcomes(runs, "shuffle undecodable on rank 0") == \
        [("ValueError", "invalid account point in shuffle prover input")] * 2


def test_dryrun_at_world_2_ends_ok(runs):
    rc, out = runs[1]
    assert rc == 0, out
    assert out.strip().splitlines()[-1].startswith("dryrun_multichip(2): OK"), out
    for stage in ("sharded MSM", "range verify_sharded", "shuffle verify_sharded",
                  "range prove_sharded", "shuffle prove_sharded"):
        assert stage in out, out
