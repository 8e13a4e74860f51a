"""The port's sigma proofs and their device verifiers on the CPU.

The port's host Prover makes the same proof bytes as the JAX package's
under the same SeededRng; both device functions of
``quisquis_tpu_torch.accounts.device_verifier`` give the verdict of the port's
host Verifier and of the JAX host Verifier on honest and tampered proofs at
n = 4, and their first-message encodings equal the host recomputation byte
for byte. Exact: equal bytes, equal verdicts, equal transcript challenges.
"""

import pytest
import torch

from quisquis_tpu.accounts.accounts import Account as JaxAccount
from quisquis_tpu.accounts.prover import Prover as JaxProver
from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.accounts.verifier import Verifier as JaxVerifier
from quisquis_tpu.primitives.keys import RistrettoPublicKey as JaxPk
from quisquis_tpu.primitives.keys import RistrettoSecretKey as JaxSk
from quisquis_tpu_torch.accounts import device_verifier as dvf
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.prover import Prover
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.accounts.verifier import Verifier
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey

L = ex.L
N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_accounts(r, n=N):
    out = []
    for _ in range(n):
        pk = JaxPk.from_secret_key(JaxSk.random(r), r)
        acc, _ = JaxAccount.generate_account(pk, r)
        out.append(JaxAccount.update_account(acc, 0, r.random_scalar(), r.random_scalar()))
    return out


@pytest.fixture(scope="module")
def delta_case():
    """(port delta, port epsilon, (zv, zr1, zr2, x)) made by both packages'
    host provers from the same seed; the bytes must agree."""
    values = [(-5) % L, 5, 0, 0]
    jr = JaxSeededRng(seed=b"torch-sigma-delta")
    accounts = _jax_accounts(jr)
    seed_state = jr.fill_bytes(32)
    jr, pr = JaxSeededRng(seed=seed_state), SeededRng(seed=seed_state)
    base = JaxPk.generate_base_pk()
    jd, je, jrs = JaxAccount.create_delta_and_epsilon_accounts(accounts, values, base, jr)
    pd, pe, prs = Account.create_delta_and_epsilon_accounts(
        host_object_from_jax(accounts), values, RistrettoPublicKey.generate_base_pk(), pr)
    assert [a.as_bytes() for a in pd] == [a.as_bytes() for a in jd]
    assert [a.as_bytes() for a in pe] == [a.as_bytes() for a in je] and prs == jrs
    jproof = JaxProver.verify_delta_compact_prover(
        jd, je, jrs, values, JaxProver(b"DLEQProof", JaxTranscript(b"DeltaCompact"), rng=jr))
    proof = Prover.verify_delta_compact_prover(
        pd, pe, prs, values, Prover(b"DLEQProof", Transcript(b"DeltaCompact"), rng=pr))
    assert proof == host_object_from_jax(jproof)
    return pd, pe, proof.get_dleq()


@pytest.fixture(scope="module")
def zero_case():
    jr = JaxSeededRng(seed=b"torch-sigma-zero")
    key = JaxPk.update_public_key(JaxPk.generate_base_pk(), jr.random_scalar())
    accounts, rscalars = [], []
    for _ in range(N):
        acc, cr = JaxAccount.generate_account(
            JaxPk.update_public_key(key, jr.random_scalar()), jr)
        accounts.append(acc)
        rscalars.append(cr)
    seed_state = jr.fill_bytes(32)
    jproof = JaxProver.zero_balance_account_vector_prover(
        accounts, rscalars,
        JaxProver(b"DLOGProof", JaxTranscript(b"ZB"), rng=JaxSeededRng(seed=seed_state)))
    port_accounts = host_object_from_jax(accounts)
    proof = Prover.zero_balance_account_vector_prover(
        port_accounts, rscalars,
        Prover(b"DLOGProof", Transcript(b"ZB"), rng=SeededRng(seed=seed_state)))
    assert proof == host_object_from_jax(jproof)
    return accounts, port_accounts, proof.get_dlog()


def _verdict(fn, *args):
    """(accepted?, a challenge drawn afterwards): the challenge commits to
    every encoding the verifier appended, accepted or not."""
    verifier = args[-1]
    try:
        fn(*args)
        ok = True
    except ValueError:
        ok = False
    return ok, verifier.transcript.get_challenge(b"after")


def _tamper(zs, which):
    out = list(zs)
    i, k = which
    if k == "x":
        out[-1] = (out[-1] + 1) % L
    else:
        out[i] = list(out[i])
        out[i][k] = (out[i][k] + 1) % L
    return out


DELTA_CASES = {"honest": None, "zv + 1": (0, 1), "zr1 + 1": (1, 2), "zr2 + 1": (2, 0),
               "x + 1": (None, "x")}


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_delta_compact_device_equals_host(delta_case, case):
    delta, eps, zs = delta_case
    if DELTA_CASES[case] is not None:
        zs = _tamper(zs, DELTA_CASES[case])
    zv, zr1, zr2, x = zs
    dev = _verdict(lambda *a: dvf.verify_delta_compact_verifier_device(*a, device="cpu"),
                   delta, eps, zv, zr1, zr2, x, Verifier(b"DLEQProof", Transcript(b"DeltaCompact")))
    host = _verdict(Verifier.verify_delta_compact_verifier, delta, eps, zv, zr1, zr2, x,
                    Verifier(b"DLEQProof", Transcript(b"DeltaCompact")))
    jdelta, jeps = ([JaxAccount.from_bytes(a.as_bytes()) for a in accs] for accs in (delta, eps))
    jax = _verdict(JaxVerifier.verify_delta_compact_verifier, jdelta, jeps, zv, zr1, zr2, x,
                   JaxVerifier(b"DLEQProof", JaxTranscript(b"DeltaCompact")))
    assert dev == host == jax
    assert dev[0] == (case == "honest")


@pytest.mark.parametrize("case", ["honest", "z + 1", "x + 1"])
def test_zero_balance_device_equals_host(zero_case, case):
    jaccounts, accounts, (z, x) = zero_case
    if case == "z + 1":
        z = [(z[0] + 1) % L] + list(z[1:])
    elif case == "x + 1":
        x = (x + 1) % L
    dev = _verdict(lambda *a: dvf.zero_balance_account_vector_verifier_device(*a, device="cpu"),
                   accounts, z, x, Verifier(b"DLOGProof", Transcript(b"ZB")))
    host = _verdict(Verifier.zero_balance_account_vector_verifier, accounts, z, x,
                    Verifier(b"DLOGProof", Transcript(b"ZB")))
    jax = _verdict(JaxVerifier.zero_balance_account_vector_verifier, jaccounts, z, x,
                   JaxVerifier(b"DLOGProof", JaxTranscript(b"ZB")))
    assert dev == host == jax
    assert dev[0] == (case == "honest")


def test_encodings_equal_host_recomputation(delta_case, zero_case):
    delta, eps, (zv, zr1, zr2, x) = delta_case
    enc = dvf.delta_compact_encodings(delta, eps, zv, zr1, zr2, x, device="cpu")
    rows = []
    for i, (d, e) in enumerate(zip(delta, eps)):
        rows += [([zr1[i], x], [d.pk.gr_point, d.comm.c_point]),
                 ([zr1[i], x, zv[i]], [d.pk.grsk_point, d.comm.d_point, ex.BASEPOINT]),
                 ([zr2[i], x], [e.pk.gr_point, e.comm.c_point]),
                 ([zr2[i], x, zv[i]], [e.pk.grsk_point, e.comm.d_point, ex.BASEPOINT])]
    want = ex.ristretto_encode_batch(ex.pt_msm_many(rows))
    assert enc.shape == (N, 4, 32) and [bytes(r) for r in enc.reshape(-1, 32)] == want
    _, accounts, (z, x) = zero_case
    enc = dvf.zero_balance_encodings(accounts, z, x, device="cpu")
    rows = []
    for i, a in enumerate(accounts):
        rows += [([z[i], x], [a.pk.gr_point, a.comm.c_point]),
                 ([z[i], x], [a.pk.grsk_point, a.comm.d_point])]
    assert [bytes(r) for r in enc.reshape(-1, 32)] == ex.ristretto_encode_batch(
        ex.pt_msm_many(rows))
    # an account that does not decode is rejected, as the host does
    bad = list(accounts)
    bad[1] = Account.from_bytes(b"\xff" * 32 + bad[1].as_bytes()[32:])
    with pytest.raises(ValueError):
        dvf.zero_balance_encodings(bad, z, x, device="cpu")
    with pytest.raises(ValueError, match="length"):
        dvf.zero_balance_encodings(accounts, z[:-1], x, device="cpu")
