"""The port's DeviceShuffleVerifier on the CPU with shuffles embedded in a
larger protocol, and batch_verify_shuffle_proofs' bucketed dispatch (m = 2):
the verdict equals the JAX package's host ShuffleProof.verify. Exact:
accept or reject."""

import pytest
import torch

from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.accounts.verifier import Verifier
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.shuffle import device_verify as sdv
from quisquis_tpu_torch.shuffle.shuffle import batch_verify_shuffle_proofs
from tests.test_torch_shuffle import host_accepts, jax_entries
from tests.test_torch_shuffle_verify import device_accepts

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prefix(cls, i, shift=0):
    t = cls(b"QuisQuisProof")
    t.append_message(b"ctx", bytes([i + shift]) * 16)
    return t


def _port_transcripts(shift=0):
    out = []
    for i in range(B):
        t = _prefix(Transcript, i, shift)
        Verifier(b"Shuffle", t)  # the proof's dom-sep, as the caller's Verifier appends it
        out.append(t)
    return out


def test_embedded_transcripts():
    """Shuffles inside a larger protocol: the host replays the prefix, the
    device goes on from the shipped STROBE states (m = 2)."""
    entries = jax_entries(b"torch-dsv-embed", 2, B,
                          transcripts=[_prefix(JaxTranscript, i) for i in range(B)])
    assert all(host_accepts(e, False, _prefix(JaxTranscript, i)) for i, e in enumerate(entries))
    assert device_accepts(2, entries, _port_transcripts(), seed=b"w3")
    assert not host_accepts(entries[0], False, _prefix(JaxTranscript, 0, 1))
    assert not device_accepts(2, entries, _port_transcripts(shift=1), seed=b"w4")


def test_batch_verify_pads_odd_batch():
    """batch_verify_shuffle_proofs(backend="device-batched"): three proofs
    run as a bucket of four lanes, the last lane repeating the first."""
    entries = jax_entries(b"torch-dsv-pad", 2, 3)
    assert all(host_accepts(e, port=False) for e in entries)
    wrapped = [(p, Verifier(b"Shuffle", Transcript(b"ShuffleProof")), st, ins, outs)
               for p, st, ins, outs in host_object_from_jax(entries)]
    sdv._VERIFIER_CACHE.clear()
    batch_verify_shuffle_proofs(wrapped, backend="device-batched", seed=b"pad", device="cpu")
    assert [k[1] for k in sdv._VERIFIER_CACHE] == [4]
