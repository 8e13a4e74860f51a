"""The port's host shuffle modules against the JAX package's, on the CPU.

Under the same SeededRng the port's host prover makes the JAX host
prover's shuffle proofs and statements field for field (m = 2 and m = 3),
and the port's host verifier gives the JAX host verifier's verdict on
honest, tampered and swapped proofs. Exact: equal fields, equal verdicts.
The helpers here make the proofs for the port's other shuffle tests too.
"""

import dataclasses

import pytest
import torch

from quisquis_tpu.accounts.accounts import Account as JaxAccount
from quisquis_tpu.accounts.prover import Prover as JaxProver
from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.accounts.verifier import Verifier as JaxVerifier
from quisquis_tpu.primitives.keys import RistrettoPublicKey as JaxPk
from quisquis_tpu.primitives.keys import RistrettoSecretKey as JaxSk
from quisquis_tpu.shuffle.shuffle import Shuffle as JaxShuffle
from quisquis_tpu.shuffle.shuffle import ShuffleProof as JaxShuffleProof
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.prover import Prover
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.accounts.verifier import Verifier
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from quisquis_tpu_torch.shuffle import shuffle as sh
from quisquis_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_entries(tag: bytes, m: int, count: int, transcripts=None):
    """(proof, statement, inputs, outputs) per proof from the JAX host
    prover; `transcripts`: the provers' transcripts (default: fresh)."""
    rng = JaxSeededRng(seed=tag)
    accounts = []
    for _ in range(m * m):
        pk = JaxPk.from_secret_key(JaxSk.random(rng), rng)
        accounts.append(JaxAccount.generate_account(pk, rng)[0])
    entries = []
    for i in range(count):
        shuffle = JaxShuffle.input_shuffle(accounts, rng=rng)
        t = transcripts[i] if transcripts else JaxTranscript(b"ShuffleProof")
        proof, statement = JaxShuffleProof.create_shuffle_proof(
            JaxProver(b"Shuffle", t, rng=rng), shuffle, rng=rng)
        entries.append((proof, statement, shuffle.get_inputs_vector(),
                        shuffle.get_outputs_vector()))
    return entries


def flip(b: bytes) -> bytes:
    return bytes([b[0] ^ 1]) + b[1:]


def _svp_b_plus_one(p, s):
    ps = dataclasses.replace(s.product_statement, svp_statement=dataclasses.replace(
        s.product_statement.svp_statement, b=s.product_statement.svp_statement.b + 1))
    return p, dataclasses.replace(s, product_statement=ps)


#: the tamperings of tests/test_device_shuffle_verify.py, on (proof,
#: statement) of either package
TAMPERS = {
    "c_A point": lambda p, s: (dataclasses.replace(p, c_A=[flip(p.c_A[0])] + p.c_A[1:]), s),
    "hadamard a_bar": lambda p, s: (dataclasses.replace(p, hadamard_proof=dataclasses.replace(
        p.hadamard_proof, a_bar=[p.hadamard_proof.a_bar[0] + 1] + p.hadamard_proof.a_bar[1:])),
        s),
    "ddh z": lambda p, s: (dataclasses.replace(p, ddh_proof=dataclasses.replace(
        p.ddh_proof, z=p.ddh_proof.z + 1)), s),
    "multiexpo E_k_0": lambda p, s: (dataclasses.replace(
        p, multi_exponen_commit=dataclasses.replace(
            p.multi_exponen_commit, E_k_0=[flip(p.multi_exponen_commit.E_k_0[0])]
            + p.multi_exponen_commit.E_k_0[1:])), s),
    "svp statement b": _svp_b_plus_one,
}


def tampered(entries, what, lane=1):
    """entries with lane `lane` tampered: a TAMPERS key, or "swapped"
    (input and output vectors exchanged)."""
    out = list(entries)
    p, s, ins, outs = out[lane]
    out[lane] = (p, s, outs, ins) if what == "swapped" else TAMPERS[what](p, s) + (ins, outs)
    return out


def host_accepts(entry, port: bool, transcript=None) -> bool:
    p, s, ins, outs = entry
    if port:
        v = Verifier(b"Shuffle", transcript or Transcript(b"ShuffleProof"))
    else:
        v = JaxVerifier(b"Shuffle", transcript or JaxTranscript(b"ShuffleProof"))
    try:
        p.verify(v, s, ins, outs)
    except ValueError:
        return False
    return True


@pytest.fixture(scope="module", params=[2, 3])
def pair(request):
    """(m, JAX entries, port entries made by the port's prover)."""
    m = request.param
    tag = b"torch-shuffle-%d" % m
    jax = jax_entries(tag, m, 1)
    rng = SeededRng(seed=tag)
    accounts = []
    for _ in range(m * m):
        pk = RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(rng), rng)
        accounts.append(Account.generate_account(pk, rng)[0])
    shuffle = sh.Shuffle.input_shuffle(accounts, rng=rng)
    proof, statement = sh.ShuffleProof.create_shuffle_proof(
        Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=rng), shuffle, rng=rng)
    return m, jax, [(proof, statement, shuffle.get_inputs_vector(),
                     shuffle.get_outputs_vector())]


def test_port_prover_equals_jax_field_for_field(pair):
    m, jax, port = pair
    converted = host_object_from_jax(jax[0])
    for got, want in zip(port[0], converted):
        assert got == want
    assert len(port[0][0].c_A) == m and len(port[0][2]) == m * m


@pytest.mark.parametrize("what", ["honest", "swapped"] + sorted(TAMPERS))
def test_host_verdicts_equal_jax(pair, what):
    _, jax, port = pair
    if what != "honest":
        jax, port = tampered(jax, what, lane=0), tampered(port, what, lane=0)
    assert host_accepts(port[0], True) == host_accepts(jax[0], False) == (what == "honest")


def test_advance_transcript_ends_where_verify_ends(pair):
    _, _, port = pair
    p, s, ins, outs = port[0]
    full = Verifier(b"Shuffle", Transcript(b"ShuffleProof"))
    p.verify(full, s, ins, outs)
    short = Verifier(b"Shuffle", Transcript(b"ShuffleProof"))
    p.advance_transcript(short, s, ins)
    assert short.transcript.get_challenge(b"next") == full.transcript.get_challenge(b"next")


def test_batch_create_and_backends(pair):
    m, _, port = pair
    metrics.reset()
    tag = b"torch-shuffle-batch"
    shuffles = [sh.Shuffle.input_shuffle(port[0][2], rng=SeededRng(seed=tag + bytes([i])))
                for i in range(2)]
    out = sh.batch_create_shuffle_proofs(shuffles, [SeededRng(seed=tag + b"p%d" % i)
                                                    for i in range(2)], backend="host")
    for shuffle, (proof, statement), i in zip(shuffles, out, range(2)):
        rng = SeededRng(seed=tag + b"p%d" % i)
        want = sh.ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=rng), shuffle, rng=rng)
        assert (proof, statement) == want
    assert metrics.timers["shuffle.prove"] and len(metrics.timers["shuffle.prove"]) == 4
    # "auto" keeps a group of a few small shuffles on the host prover
    assert sh.batch_create_shuffle_proofs(
        shuffles, [SeededRng(seed=tag + b"p%d" % i) for i in range(2)], device="cpu") == out
    # the device-batched prover exists now (shuffle/device_prove.py; its
    # bytes are held in tests/test_torch_shuffle_prove*.py): an empty batch
    # proves nothing
    assert sh.batch_create_shuffle_proofs([], backend="device-batched", device="cpu") == []
    with pytest.raises(ValueError, match="unknown backend"):
        sh.batch_create_shuffle_proofs(shuffles, backend="tpu")
    # "sharded" needs a mesh once there is a term to check (the JAX order)
    sh.batch_verify_shuffle_proofs([], backend="sharded")
    entries = [(p, Verifier(b"Shuffle", Transcript(b"ShuffleProof")), s, x.get_inputs_vector(),
                x.get_outputs_vector()) for x, (p, s) in zip(shuffles, out)]
    with pytest.raises(ValueError, match="sharded backend requires a mesh"):
        sh.batch_verify_shuffle_proofs(entries, backend="sharded")
    with pytest.raises(ValueError, match="unknown backend"):
        sh.batch_verify_shuffle_proofs([], backend="tpu")
