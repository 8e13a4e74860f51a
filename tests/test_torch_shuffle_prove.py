"""The port's DeviceShuffleProver on the CPU (m = 2, B = 2): under the same
SeededRng streams its proofs and statements equal, field for field, the
port's host ``ShuffleProof.create_shuffle_proof`` and the JAX package's
host prover (carried across by interop.host_object_from_jax), and the
port's host verifier accepts them; an account that does not decode is
refused. m = 3 is in tests/test_torch_shuffle_prove_m3.py and the
bucketed ``batch_create_shuffle_proofs`` in
tests/test_torch_shuffle_prove_batch.py (each file a share of the CPU
time: one prove at B = 2 costs 15-25 s here, most of it the plain MSM
stages of the DDH and multi-exponentiation rows). The JAX one-program
device prover is not compiled here."""

import copy
import dataclasses

import pytest
import torch

from quisquis_tpu.accounts.accounts import Account as JaxAccount
from quisquis_tpu.accounts.prover import Prover as JaxProver
from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.primitives.keys import RistrettoPublicKey as JaxPk
from quisquis_tpu.primitives.keys import RistrettoSecretKey as JaxSk
from quisquis_tpu.shuffle.shuffle import Shuffle as JaxShuffle
from quisquis_tpu.shuffle.shuffle import ShuffleProof as JaxShuffleProof
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.prover import Prover
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.accounts.verifier import Verifier
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.primitives.elgamal import ElGamalCommitment
from quisquis_tpu_torch.shuffle import device_prove as sdp
from quisquis_tpu_torch.shuffle.shuffle import Shuffle, ShuffleProof

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def lanes(tag: bytes, m: int, count: int, jax: bool = True):
    """Per lane: the port's Shuffle, a copy of its rng just before the
    proof, the port's host (proof, statement) and the JAX host one (None
    without ``jax``), both made from that point of the same stream."""
    jrng = JaxSeededRng(seed=tag)
    jax_accounts = [JaxAccount.generate_account(JaxPk.from_secret_key(JaxSk.random(jrng), jrng),
                                                jrng)[0] for _ in range(m * m)]
    accounts = host_object_from_jax(jax_accounts)
    out = []
    for i in range(count):
        jr, r = JaxSeededRng(seed=tag + b"%d" % i), SeededRng(seed=tag + b"%d" % i)
        jsh, shuffle = JaxShuffle.input_shuffle(jax_accounts, rng=jr), \
            Shuffle.input_shuffle(accounts, rng=r)
        before = copy.deepcopy(r)
        host = ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=r), shuffle, rng=r)
        theirs = host_object_from_jax(JaxShuffleProof.create_shuffle_proof(
            JaxProver(b"Shuffle", JaxTranscript(b"ShuffleProof"), rng=jr), jsh, rng=jr)) \
            if jax else None
        out.append((shuffle, before, host, theirs))
    return out


def host_verifies(shuffle, proof, statement) -> None:
    """The port's host verifier; raises ValueError on a bad proof."""
    proof.verify(Verifier(b"Shuffle", Transcript(b"ShuffleProof")), statement,
                 shuffle.get_inputs_vector(), shuffle.get_outputs_vector())


def assert_same_fields(got, want) -> None:
    """Field for field, naming the first that differs."""
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), f"{type(w).__name__}.{f.name}"
    assert got == want


def test_device_prove_equals_host_m2():
    batch = lanes(b"dsp-2", 2, B)
    dsp = sdp.get_device_shuffle_prover(2, B, device="cpu")
    got = dsp.prove([s for s, *_ in batch], [copy.deepcopy(r) for _, r, *_ in batch])
    for (shuffle, _, host, jax), out in zip(batch, got):
        assert_same_fields(out, host)
        assert_same_fields(out, jax)
        host_verifies(shuffle, *out)
    # an output account whose point does not decode is refused
    bad_shuffle = copy.copy(batch[1][0])
    acc = bad_shuffle.outputs[0]
    bad_shuffle.outputs = [Account(acc.pk, ElGamalCommitment(b"\xff" * 32, acc.comm.d))] \
        + bad_shuffle.outputs[1:]
    with pytest.raises(ValueError, match="invalid account point"):
        dsp.prove([batch[0][0], bad_shuffle], [copy.deepcopy(r) for _, r, *_ in batch])
    with pytest.raises(ValueError, match="lane count"):
        dsp.prove([batch[0][0]], [batch[0][1]])
