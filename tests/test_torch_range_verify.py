"""The slice as a whole on the CPU: the port's ``DeviceRangeVerifier`` gives
the verdict of the JAX package's host ``RangeProof.verify_multiple`` on honest
and tampered batches (n = 8, m = 2, B = 3, the size of
tests/test_device_range_verify.py). Proofs come from the JAX package's host
prover; their bytes go to both packages. Exact: accept or reject, and bytes.
The JAX one-program device verifier is not compiled here."""

import numpy as np
import pytest
import torch

from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.bulletproofs.range_proof import RangeProof as JaxRangeProof
from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.bulletproofs import device_verify as dv
from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
from quisquis_tpu_torch.ops import exact as ex

N_BITS, M, B = 8, 2, 3
VALUES = [[i + 1, 200 + i] for i in range(B)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_batch(tag: bytes, transcripts=None):
    """(proof bytes, value commitments) per lane, from the JAX host prover."""
    rng = JaxSeededRng(seed=tag)
    out = []
    for i in range(B):
        blind = [rng.random_scalar() for _ in range(M)]
        t = transcripts[i] if transcripts else JaxTranscript(b"RangeProof")
        proof, V = JaxRangeProof.prove_multiple(t, VALUES[i], blind, N_BITS, rng=rng)
        out.append((proof.to_bytes(), list(V)))
    return out


def _jax_host_accepts(batch, make_transcript=lambda i: JaxTranscript(b"RangeProof")) -> bool:
    try:
        for i, (blob, V) in enumerate(batch):
            JaxRangeProof.from_bytes(blob).verify_multiple(make_transcript(i), V, N_BITS)
    except ValueError:
        return False
    return True


def _port_accepts(drv, batch, transcripts=None, seed=b"w") -> bool:
    try:
        drv.verify([RangeProof.from_bytes(blob) for blob, _ in batch], [V for _, V in batch],
                   transcripts=transcripts, rng=SeededRng(seed=seed))
    except ValueError:
        return False
    return True


@pytest.fixture(scope="module")
def drv():
    return dv.DeviceRangeVerifier(N_BITS, M, B, device="cpu")


@pytest.fixture(scope="module")
def honest():
    return _jax_batch(b"drv-ok")


def test_port_prover_bytes_equal_jax(honest):
    rng = SeededRng(seed=b"drv-ok")
    for i, (blob, V) in enumerate(honest):
        blind = [rng.random_scalar() for _ in range(M)]
        proof, got_v = RangeProof.prove_multiple(Transcript(b"RangeProof"), VALUES[i], blind,
                                                 N_BITS, rng=rng)
        assert proof.to_bytes() == blob and list(got_v) == V
        assert RangeProof.from_bytes(blob) == proof
        proof.verify_multiple(Transcript(b"RangeProof"), V, N_BITS)
    single, v1 = RangeProof.prove_single(Transcript(b"RangeProof"), 77, 5, N_BITS, rng=rng)
    single.verify_single(Transcript(b"RangeProof"), v1, N_BITS)
    with pytest.raises(ValueError):
        RangeProof.prove_multiple(Transcript(b"RangeProof"), [256], [1], N_BITS, rng=rng)
    RangeProof.batch_verify([], N_BITS, backend="host")  # an empty batch holds
    assert RangeProof.prove_batch([], N_BITS, backend="host") == []
    # the device-batched prover exists now (bulletproofs/device_prove.py):
    # an empty batch proves nothing
    assert RangeProof.prove_batch([], N_BITS, backend="device-batched", device="cpu") == []
    with pytest.raises(ValueError, match="unknown backend"):
        RangeProof.prove_batch([], N_BITS, backend="sharded")


def test_accepts_honest_batch(drv, honest):
    assert _jax_host_accepts(honest)
    assert _port_accepts(drv, honest)
    # scalar bytes at or above l reach the program as they are; it must
    # reduce them as the host's from_bytes does
    proofs = [RangeProof.from_bytes(blob) for blob, _ in honest]
    comp, scal, states, frame = drv._pack(proofs, [V for _, V in honest], None)
    for j in range(3):
        v = int.from_bytes(scal[1, j].tobytes(), "little") + ex.L
        scal[1, j] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    weights = np.frombuffer(SeededRng(seed=b"w9").fill_bytes(B * 128), np.uint8)
    assert drv._run(comp, scal, weights.reshape(B, 2, 64).copy(), states, frame)
    blob = bytearray(honest[1][0])
    t_x = int.from_bytes(blob[128:160], "little") + ex.L
    blob[128:160] = t_x.to_bytes(32, "little")
    assert RangeProof.from_bytes(bytes(blob)) == proofs[1]
    with pytest.raises(ValueError, match="batch size"):
        drv.verify(proofs[:2], [V for _, V in honest][:2])
    with pytest.raises(ValueError, match="shape"):
        drv.verify(proofs, [V[:1] for _, V in honest])


TAMPERS = {
    "point A": lambda blob, V: blob.__setitem__(3, blob[3] ^ 1),
    "scalar t_x": lambda blob, V: blob.__setitem__(130, blob[130] ^ 1),
    "ipp L point": lambda blob, V: blob.__setitem__(226, blob[226] ^ 1),
    "value commitment": lambda blob, V: V.__setitem__(0, bytes([V[0][0] ^ 1]) + V[0][1:]),
}


@pytest.mark.parametrize("what", sorted(TAMPERS))
def test_rejects_tampered_lane(drv, honest, what):
    blob, V = bytearray(honest[1][0]), list(honest[1][1])
    TAMPERS[what](blob, V)
    batch = [honest[0], (bytes(blob), V), honest[2]]
    assert not _jax_host_accepts(batch)
    assert not _port_accepts(drv, batch, seed=b"w2")


def test_rejects_swapped_commitments(drv, honest):
    swapped = [(honest[0][0], honest[1][1]), (honest[1][0], honest[0][1]), honest[2]]
    assert not _jax_host_accepts(swapped)
    assert not _port_accepts(drv, swapped, seed=b"w3")


def test_prefixed_transcripts(drv):
    """Proofs inside a larger protocol: the host replays the prefix, the
    device goes on from the shipped STROBE states."""
    def prefix(cls, i, shift=0):
        t = cls(b"QuisQuisProof")
        t.append_message(b"ctx", bytes([i + shift]) * 16)
        return t

    batch = _jax_batch(b"drv-prefix", [prefix(JaxTranscript, i) for i in range(B)])
    assert _jax_host_accepts(batch, lambda i: prefix(JaxTranscript, i))
    assert _port_accepts(drv, batch, [prefix(Transcript, i) for i in range(B)], b"w4")
    assert not _jax_host_accepts(batch, lambda i: prefix(JaxTranscript, i, 1))
    assert not _port_accepts(drv, batch, [prefix(Transcript, i, 1) for i in range(B)], b"w5")
    diverged = [prefix(Transcript, i) for i in range(B)]
    diverged[2].append_message(b"more", b"x" * 200)
    with pytest.raises(ValueError, match="framing"):
        drv.verify([RangeProof.from_bytes(blob) for blob, _ in batch], [V for _, V in batch],
                   transcripts=diverged)


def test_batch_verify_groups_by_width(honest):
    """RangeProof.batch_verify(backend="device-batched"): three m = 2 proofs
    (padded to 4 lanes) and one m = 1 proof (its own bucket)."""
    rng = JaxSeededRng(seed=b"disp")
    p1, v1 = JaxRangeProof.prove_multiple(JaxTranscript(b"RangeProof"), [42],
                                          [rng.random_scalar()], N_BITS, rng=rng)
    single = (p1.to_bytes(), list(v1))

    def instances(batch):
        return [(RangeProof.from_bytes(blob), V, Transcript(b"RangeProof")) for blob, V in batch]

    wrng = SeededRng(seed=b"disp-w")
    RangeProof.batch_verify(instances(honest + [single]), N_BITS, rng=wrng, device="cpu")
    assert dv.get_device_range_verifier(N_BITS, 1, 4, device="cpu") is \
        dv.get_device_range_verifier(N_BITS, 1, 4, device="cpu")
    blob = bytearray(single[0])
    blob[130] ^= 1
    bad = (bytes(blob), single[1])
    assert not _jax_host_accepts([bad])
    with pytest.raises(ValueError):
        dv.device_batch_verify(instances([bad]), N_BITS, rng=wrng, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        RangeProof.batch_verify([], N_BITS, backend="tpu")


def test_batch_verify_host_equals_device_batched(honest):
    """RangeProof.batch_verify's "host" backend (transcripts replayed here,
    one deferred MSM), with and without a caller's accumulator, gives the
    verdict of "device-batched" and of the JAX host backend."""
    blob = bytearray(honest[2][0])
    blob[130] ^= 1
    bad = honest[:2] + [(bytes(blob), honest[2][1])]
    for batch, want in ((honest, True), (bad, False)):
        def port(backend, defer=None):
            inst = [(RangeProof.from_bytes(b), V, Transcript(b"RangeProof")) for b, V in batch]
            try:
                RangeProof.batch_verify(inst, N_BITS, rng=SeededRng(seed=b"hb"), defer=defer,
                                        backend=backend, device="cpu")
                if defer is not None:
                    defer.verify(backend="device", device="cpu")
            except ValueError:
                return False
            return True

        def jax():
            inst = [(JaxRangeProof.from_bytes(b), V, JaxTranscript(b"RangeProof"))
                    for b, V in batch]
            try:
                JaxRangeProof.batch_verify(inst, N_BITS, rng=JaxSeededRng(seed=b"hb"),
                                           backend="host")
            except ValueError:
                return False
            return True

        got = [port("host"), port("device-batched"), port("auto", DeferredPointChecks(b"d")),
               jax()]
        assert got == [want] * 4, got
    with pytest.raises(ValueError, match="deferred accumulator"):
        RangeProof.batch_verify([], N_BITS, defer=DeferredPointChecks(b"d"),
                                backend="device-batched")
