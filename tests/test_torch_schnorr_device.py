"""The batched zkSchnorr verifier (``primitives/device_schnorr.py``), its
wire record (``utils/serde.py``) and ``serving.SignatureVerificationService``
on the CPU (the codec and MSM kernels' plain versions, ``device="cpu"``),
against the host ``Signature.verify`` and ``ops/exact.py``: the device
challenges equal the host transcript's lane by lane; an honest batch is
accepted and each tampering (s + 1, a flipped message bit, a non-canonical
R, a swapped key, an invalid g) rejected, as the host rejects that lane;
an ``s + l`` encoding gets the host's verdict; the service's "host" and
"device-batched" backends agree; ``Signature.batch_verify("device-batched")``
takes host transcripts of several framings. Everything is exact."""

import numpy as np
import pytest
import torch

from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.primitives import device_schnorr as ds
from quisquis_tpu_torch.primitives.schnorr import Signature, VerificationKey
from quisquis_tpu_torch.serving import SignatureVerificationService
from quisquis_tpu_torch.utils import serde

LABEL = b"valueSign"
LANES = 12
TAMPERINGS = ("forged_s", "message_bit", "R_noncanonical", "swapped_key", "invalid_g")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def signed():
    """LANES (vk, signature, message) by distinct keys, from the host signer."""
    r = SeededRng(seed=b"device-schnorr")
    out = []
    for _ in range(LANES):
        sk = r.random_scalar()
        vk = VerificationKey.from_secret(sk, r.random_scalar())
        msg = r.fill_bytes(32)
        out.append((vk, Signature.sign_message(LABEL, msg, vk, sk, rng=r), msg))
    return out


def _records(signed) -> list:
    return [serde.signed_message_to_bytes(vk, sig, msg) for vk, sig, msg in signed]


def _tampered(blob: bytes, kind: str, other: bytes) -> bytes:
    out = bytearray(blob)
    if kind == "forged_s":
        out[96:128] = ex.sc_to_bytes((ex.sc_from_bytes_mod_order(blob[96:128]) + 1) % ex.L)
    elif kind == "message_bit":
        out[128] ^= 1
    elif kind == "R_noncanonical":   # the same point's negative encoding
        out[64:96] = (ex.P - ex.fe_from_bytes(blob[64:96])).to_bytes(32, "little")
    elif kind == "swapped_key":
        out[0:64] = other[0:64]
    elif kind == "invalid_g":
        out[0:32] = b"\xff" * 32
    return bytes(out)


def _columns(blobs):
    rec = np.frombuffer(b"".join(blobs), np.uint8).reshape(len(blobs), -1)
    return rec[:, 0:32], rec[:, 32:64], rec[:, 64:96], rec[:, 96:128], rec[:, 128:]


def _device(blobs) -> bool:
    return ds.verify_messages(LABEL, *_columns(blobs), seed=b"w", device="cpu")


def _host(blob) -> bool:
    vk, sig, msg = serde.signed_message_from_bytes(blob)
    try:
        sig.verify_message(LABEL, msg, vk)
    except ValueError:
        return False
    return True


def test_challenges_equal_the_host_transcripts(signed):
    g, h, R, _, msgs = _columns(_records(signed))
    got = ds.message_challenges(LABEL, g, h, R, msgs, device="cpu")
    want = []
    for vk, sig, msg in signed:
        t = Signature._transcript_for_message(LABEL, msg)
        t.domain_sep(b"zkschnorr")
        for label, p in ((b"G", vk.g), (b"H", vk.h), (b"R", sig.R)):
            t.append_point_var(label, p)
        want.append(t.get_challenge(b"c"))
    assert got == want
    # each lane's identity s g == R + c h on the exact curve
    for (vk, sig, _), c in zip(signed, got):
        g_pt, h_pt, R_pt = (ex.ristretto_decode(p) for p in (vk.g, vk.h, sig.R))
        assert ex.pt_eq(ex.pt_mul(sig.s, g_pt), ex.pt_add(R_pt, ex.pt_mul(c, h_pt)))


def test_an_honest_batch_is_accepted(signed):
    blobs = _records(signed)
    assert all(_host(b) for b in blobs)
    assert _device(blobs)


@pytest.mark.parametrize("kind", TAMPERINGS)
def test_a_tampered_lane_rejects_the_batch(signed, kind):
    blobs = _records(signed)
    blobs[5] = _tampered(blobs[5], kind, blobs[6])
    assert not _host(blobs[5])
    assert not _device(blobs)


def test_s_plus_l_gets_the_host_verdict(signed):
    """The host reads s modulo l (Signature.from_bytes, no canonical check),
    and so does the program: s + l verifies on both."""
    blobs = _records(signed)
    s = int.from_bytes(blobs[2][96:128], "little")
    blobs[2] = blobs[2][:96] + (s + ex.L).to_bytes(32, "little") + blobs[2][128:]
    assert Signature.from_bytes(blobs[2][96:128] + blobs[2][64:96]).s == s
    assert _host(blobs[2])
    assert _device(blobs)


def test_the_wire_record_round_trips_and_rejects(signed):
    vk, sig, msg = signed[0]
    blob = serde.signed_message_to_bytes(vk, sig, msg)
    assert len(blob) == serde.SIGNED_MESSAGE_HEAD + 32
    assert blob == vk.g + vk.h + sig.R + ex.sc_to_bytes(sig.s) + msg
    assert serde.signed_message_from_bytes(blob) == (vk, sig, msg)
    assert serde.signed_message_from_bytes(blob + b"\0" * 8, message_len=40)[2] == msg + b"\0" * 8
    with pytest.raises(ValueError, match="trailing"):
        serde.signed_message_from_bytes(blob + b"\0")
    with pytest.raises(ValueError, match="truncated"):
        serde.signed_message_from_bytes(blob[:-1])


@pytest.mark.parametrize("kind", [None, "forged_s"])
def test_the_service_backends_agree(signed, kind):
    blobs = _records(signed)
    if kind is not None:
        blobs[9] = _tampered(blobs[9], kind, blobs[0])
    verdicts = []
    for backend in ("host", "device-batched"):
        with SignatureVerificationService(backend, label=LABEL, seed=b"s", device="cpu") as svc:
            try:
                verdicts.append(svc.verify_wire(blobs))
            except ValueError:
                verdicts.append("rejected")
            with pytest.raises(ValueError, match="not 160 bytes"):
                svc.verify_wire(blobs[:3] + [blobs[3] + b"\0"])
    assert verdicts == ([LANES, LANES] if kind is None else ["rejected", "rejected"])


def test_batch_verify_device_batched_takes_host_transcripts(signed):
    """Transcripts whose labels differ in length sit at other sponge
    positions: the program groups them and joins their terms in one MSM."""
    r = SeededRng(seed=b"device-schnorr-transcripts")
    items = []
    for i, (vk, _, _) in enumerate(signed[:6]):
        sk = r.random_scalar()
        vk = VerificationKey.from_secret(sk, r.random_scalar())
        t = Transcript(b"t" * (1 + i % 3))
        items.append((Signature.sign(t.clone(), vk, sk, rng=r), t, vk))
    Signature.batch_verify(items, backend="device-batched", seed=b"w", device="cpu")
    sig, t, vk = items[4]
    items[4] = (Signature((sig.s + 1) % ex.L, sig.R), t, vk)
    with pytest.raises(ValueError):
        Signature.batch_verify(items, backend="device-batched", seed=b"w", device="cpu")
