"""The port's DeviceShuffleVerifier on the CPU (B = 2): its verdict equals
the JAX package's host ShuffleProof.verify on an honest batch (m = 3), on a
batch with one lane's input and output accounts swapped and on one with a
tampered statement (m = 2). The proofs come from the JAX host prover and
cross to the port through interop.host_object_from_jax. Exact: accept or
reject. The JAX one-program device verifier is not compiled here;
tests/test_device_shuffle_verify.py holds it to the same host verifier.
Tampered proofs are in tests/test_torch_shuffle_tamper.py, embedded
transcripts and the bucketed dispatch in tests/test_torch_shuffle_embedded.py
(each file a share of the CPU time)."""

import pytest
import torch

from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.shuffle import device_verify as sdv
from tests.test_torch_shuffle import host_accepts, jax_entries, tampered

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def device_accepts(m, entries, transcripts=None, seed=b"w") -> bool:
    dsv = sdv.get_device_shuffle_verifier(m, len(entries), device="cpu")
    try:
        dsv.verify(host_object_from_jax(entries), transcripts=transcripts,
                   rng=SeededRng(seed=seed))
    except ValueError:
        return False
    return True


def test_accepts_honest_batch():
    entries = jax_entries(b"torch-dsv-3", 3, B)
    assert all(host_accepts(e, port=False) for e in entries)
    assert device_accepts(3, entries)


@pytest.mark.parametrize("what", ["swapped", "svp statement b"])
def test_rejects_mismatched_statement(what):
    entries = tampered(jax_entries(b"torch-dsv-stmt", 2, B), what, lane=0)
    assert not host_accepts(entries[0], port=False) and host_accepts(entries[1], port=False)
    assert not device_accepts(2, entries, seed=b"w2-" + what.encode())


def test_pack_checks_shapes_and_framing():
    """The host-side checks run before any device work."""
    entries = host_object_from_jax(jax_entries(b"torch-dsv-pack", 2, 1))
    dsv = sdv.DeviceShuffleVerifier(2, B, device="cpu")
    with pytest.raises(ValueError, match="batch size"):
        dsv.verify(entries)
    diverged = [Transcript(b"ShuffleProof") for _ in range(B)]
    diverged[1].append_message(b"more", b"x" * 200)
    with pytest.raises(ValueError, match="framing"):
        dsv.verify(entries * 2, transcripts=diverged)
    with pytest.raises(ValueError, match="length"):
        dsv.verify([entries[0], entries[0][:2] + (entries[0][2][:3], entries[0][3])])
    with pytest.raises(ValueError, match="m >= 2"):
        sdv.DeviceShuffleVerifier(1, B, device="cpu")
    assert sdv.get_device_shuffle_verifier(2, B, device="cpu") is \
        sdv.get_device_shuffle_verifier(2, B, device="cpu")
