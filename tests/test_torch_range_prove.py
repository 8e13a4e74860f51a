"""The port's DeviceRangeProver on the CPU (n = 8, m = 2, B = 3, the size of
tests/test_device_prove.py): under the same SeededRng streams its proofs
are byte-identical to the port's host ``prove_multiple`` and to the JAX
package's host ``prove_multiple``, with fresh and with prefixed
transcripts; out-of-range values are refused; ``RangeProof.prove_batch``
"device-batched" equals "host" (padded buckets, mixed shapes, advanced
transcripts); the port's host and device verifiers accept the proofs.
Exact: bytes and verdicts. The JAX one-program device prover is not
compiled here."""

import pytest
import torch

from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.bulletproofs.range_proof import RangeProof as JaxRangeProof
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.bulletproofs import device_prove as dp
from quisquis_tpu_torch.bulletproofs import device_verify as dv
from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.ops.device_strobe import snapshot_host_strobe

N_BITS, M, B = 8, 2, 3
VALUES = [[i + 1, 200 + i] for i in range(B)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def drp():
    return dp.get_device_range_prover(N_BITS, M, B, device="cpu")


def _blindings(tag: bytes):
    rng = SeededRng(seed=tag)
    return [[rng.random_scalar() for _ in range(M)] for _ in range(B)]


def _transcript(cls, i: int, prefix: bool):
    """A fresh transcript of either package; with ``prefix`` it carries
    lane i's context message first (a proof inside a larger protocol)."""
    t = cls(b"RangeProof")
    if prefix:
        t.append_message(b"ctx", bytes([i]) * 40)
    return t


def _host(tag: bytes, prefix: bool = False):
    """The port's and the JAX package's host proofs (bytes, V) per lane."""
    blind = _blindings(tag)
    port, jax = [], []
    for i in range(B):
        proof, V = RangeProof.prove_multiple(_transcript(Transcript, i, prefix), VALUES[i],
                                             blind[i], N_BITS, rng=SeededRng(seed=tag + b"%d" % i))
        port.append((proof.to_bytes(), list(V)))
        jproof, jV = JaxRangeProof.prove_multiple(_transcript(JaxTranscript, i, prefix),
                                                  VALUES[i], blind[i], N_BITS,
                                                  rng=JaxSeededRng(seed=tag + b"%d" % i))
        jax.append((host_object_from_jax(jproof).to_bytes(), list(jV)))
    return port, jax


def _device(drp, tag: bytes, transcripts=None):
    proofs, vlists = drp.prove(VALUES, _blindings(tag),
                               [SeededRng(seed=tag + b"%d" % i) for i in range(B)],
                               transcripts=transcripts)
    return [(p.to_bytes(), list(v)) for p, v in zip(proofs, vlists)]


def test_device_prove_equals_host_bytes_and_verifies(drp):
    port, jax = _host(b"drp-plain")
    got = _device(drp, b"drp-plain")
    assert got == port == jax
    for blob, V in got:
        RangeProof.from_bytes(blob).verify_multiple(Transcript(b"RangeProof"), V, N_BITS)
    drv = dv.get_device_range_verifier(N_BITS, M, B, device="cpu")
    drv.verify([RangeProof.from_bytes(b) for b, _ in got], [V for _, V in got],
               rng=SeededRng(seed=b"w"))
    bad = bytearray(got[1][0])
    bad[3] ^= 1  # a flipped byte in A
    with pytest.raises(ValueError):
        drv.verify([RangeProof.from_bytes(b) for b, _ in got[:1]]
                   + [RangeProof.from_bytes(bytes(bad))]
                   + [RangeProof.from_bytes(b) for b, _ in got[2:]], [V for _, V in got],
                   rng=SeededRng(seed=b"w"))


def test_device_prove_prefixed_transcripts(drp):
    """Lanes whose transcripts carry a prefix of one shape (a proof inside a
    larger protocol) continue from their snapshots; the host transcripts
    are not advanced."""
    port, jax = _host(b"drp-prefix", prefix=True)
    transcripts = [_transcript(Transcript, i, True) for i in range(B)]
    before = [snapshot_host_strobe(t.strobe) for t in transcripts]
    assert _device(drp, b"drp-prefix", transcripts) == port == jax
    assert [snapshot_host_strobe(t.strobe) for t in transcripts] == before
    for i, (blob, V) in enumerate(port):
        RangeProof.from_bytes(blob).verify_multiple(_transcript(Transcript, i, True), V,
                                                    N_BITS)
    transcripts[1].append_message(b"more", b"x")  # another frame
    with pytest.raises(ValueError, match="diverged"):
        _device(drp, b"drp-prefix", transcripts)


def test_device_prove_rejects_out_of_range(drp):
    values = [list(v) for v in VALUES]
    values[2][1] = 1 << N_BITS
    with pytest.raises(ValueError, match="out of range"):
        drp.prove(values, _blindings(b"x"), [SeededRng(seed=b"x")] * B)
    with pytest.raises(ValueError, match="count"):
        drp.prove([v[:1] for v in VALUES], _blindings(b"x"), [SeededRng(seed=b"x")] * B)
    with pytest.raises(ValueError):
        dp.DeviceRangeProver(N_BITS, 3, B, device="cpu")


def test_prove_batch_device_equals_host():
    """Three m = 2 lanes run as a bucket of 4 (the pad lane draws from its
    own stream) and one m = 1 lane as a bucket of 2: the proofs, the value
    commitments and the advanced transcripts equal the host backend's."""
    def lanes():
        out = []
        for i, vals in enumerate([[10, 20], [11], [12, 22], [13, 23]]):
            rng = SeededRng(seed=b"pb-%d" % i)
            out.append((Transcript(b"RangeProof"), vals,
                        [rng.random_scalar() for _ in vals], rng))
        return out

    host_lanes, dev_lanes = lanes(), lanes()
    host = RangeProof.prove_batch(host_lanes, N_BITS, backend="host")
    dev = RangeProof.prove_batch(dev_lanes, N_BITS, backend="device-batched", device="cpu")
    assert [(p.to_bytes(), list(v)) for p, v in dev] == \
        [(p.to_bytes(), list(v)) for p, v in host]
    for (th, *_), (td, *_) in zip(host_lanes, dev_lanes):
        assert snapshot_host_strobe(td.strobe) == snapshot_host_strobe(th.strobe)
        assert td.challenge_bytes(b"next", 32) == th.challenge_bytes(b"next", 32)
    with pytest.raises(ValueError, match="unknown backend"):
        RangeProof.prove_batch(lanes(), N_BITS, backend="tpu")
