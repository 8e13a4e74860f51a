"""``verify_schnorr_wire``: groups of zkSchnorr signed messages verified by
the port's signature service (``SignatureVerificationService.verify_wire``).

The inputs are made by the reference alone: ``signatures`` wire records
``g || h || R || s || message``, each signed by its own seeded key (a
dual-point key (g, h) = (r G, sk r G), a fresh one a signature, as QuisQuis
updates keys on every use) over its own seeded message of
``message_bytes`` under the configuration's ``label``, as zkSchnorr signs
a message (reference src/transaction/signature.rs:83-137 and
src/ristretto/keys.rs:208-236), with the reference's STROBE transcripts and
curve; and, for one record picked by the seed, one tampered copy for each
kind in the mix's ``tampered`` list. The reference's verdict on every
record (:func:`ref_verify`, each signature checked alone, ``s g == R + c
h``) is part of the inputs, and inputs in which it accepts a tampered copy
or rejects an honest record are refused.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from .. import gen
from .verify_wire import VerifyWire

#: s + 1; one flipped bit of the message; R's negative, non-canonical encoding
TAMPER_KINDS = ("forged_s", "message_bit", "R_noncanonical")
#: the record's bytes before the message: g, h, R, s
HEAD = 128


def _transcript(config: dict, message: bytes):
    """The reference's ``Transcript(b"ZkSchnorr.sign_message")`` with the
    message appended under the configuration's label."""
    from ..ref.accounts.transcript import Transcript

    t = Transcript(b"ZkSchnorr.sign_message")
    t.append_message(config["label"].encode(), message)
    return t


def _challenge(t, g: bytes, h: bytes, R: bytes) -> int:
    t.domain_sep(b"zkschnorr")
    t.append_point_var(b"G", g)
    t.append_point_var(b"H", h)
    t.append_point_var(b"R", R)
    return t.get_challenge(b"c")


def ref_sign(tag: bytes, config: dict, i: int) -> bytes:
    """Record i of a tag: a fresh key, a seeded message and the key's
    zkSchnorr signature of it, the nonce from the transcript's rng rekeyed
    with the secret key, as the reference signs."""
    from ..ref.accounts.transcript import SeededRng
    from ..ref.ops import exact as ex

    rng = SeededRng(seed=tag + b"-s%d" % i)
    sk = rng.random_scalar()
    g_pt = ex.pt_base_mul(rng.random_scalar())
    g, h = ex.ristretto_encode(g_pt), ex.ristretto_encode(ex.pt_mul(sk, g_pt))
    message = rng.fill_bytes(int(config["message_bytes"]))
    t = _transcript(config, message)
    nonce = (t.clone().build_rng().rekey_with_witness_bytes(b"x", ex.sc_to_bytes(sk))
             .finalize(entropy=rng.fill_bytes(32)).random_scalar())
    R = ex.ristretto_encode(ex.pt_mul(nonce, g_pt))
    s = (nonce + _challenge(t, g, h, R) * sk) % ex.L
    return g + h + R + ex.sc_to_bytes(s) + message


def ref_verify(blob: bytes, config: dict, point_check: bool = True) -> bool:
    """The reference's verdict on one record, checked alone: True where it
    has the configuration's length, its three points decode and s g == R +
    c h. With `point_check` False that identity is never evaluated: the
    control's verdict."""
    from ..ref.ops import exact as ex

    if len(blob) != HEAD + int(config["message_bytes"]):
        return False
    g, h, R = blob[0:32], blob[32:64], blob[64:96]
    s = ex.sc_from_bytes_mod_order(blob[96:128])
    c = _challenge(_transcript(config, blob[HEAD:]), g, h, R)
    g_pt, h_pt, R_pt = (ex.ristretto_decode(p) for p in (g, h, R))
    if g_pt is None or h_pt is None or R_pt is None:
        return False
    return not point_check or ex.pt_eq(ex.pt_mul(s, g_pt), ex.pt_add(R_pt, ex.pt_mul(c, h_pt)))


def _sign_and_verify(tag: bytes, config: dict, n: int, indices: list) -> list:
    """Worker: the records `indices` of a tag, with the reference's verdicts."""
    out = []
    for i in indices:
        blob = ref_sign(tag, config, i)
        out.append((i, blob, ref_verify(blob, config)))
    return out


def tamper(blob: bytes, kind: str) -> bytes:
    """A copy of a record with one value changed: ``s`` plus one (a valid
    scalar), the message's lowest bit flipped, or R replaced by the
    encoding of its field element's negative, which encodes the same point
    but is not canonical (its low bit is set), so the decoder rejects it."""
    from ..ref.ops import exact as ex

    out = bytearray(blob)
    if kind == "forged_s":
        out[96:128] = ex.sc_to_bytes((ex.sc_from_bytes_mod_order(blob[96:128]) + 1) % ex.L)
    elif kind == "message_bit":
        out[HEAD] ^= 1
    elif kind == "R_noncanonical":
        out[64:96] = (ex.P - ex.fe_from_bytes(blob[64:96])).to_bytes(32, "little")
    else:
        raise ValueError(f"unknown tampering {kind!r}")
    return bytes(out)


def schnorr_inputs(config: dict, mix: dict, seed: int, workers: int = gen.POOL_WORKERS):
    """``gen.checked_inputs`` of a signature mix: ``signatures`` records as
    "records"."""
    return gen.checked_inputs("schnorr", config, seed, int(mix["signatures"]), mix["tampered"],
                              "records", _sign_and_verify, tamper,
                              lambda blob, weight_seed: ref_verify(blob, config),
                              owner=Path(__file__), workers=workers)


class VerifySchnorrWire(VerifyWire):
    """``SignatureVerificationService(backend=<mix backend>, label=<config
    label>, message_len=<config message_bytes>).verify_wire`` on groups of
    ``group_size`` records, sent and judged as :class:`VerifyWire` sends
    and judges its groups: each group's verdict must equal the
    reference's, and an accepted call must return the group's size. Its
    kind stays "verify", so ``verify_device_ms_per_tx`` reads it, per
    signature."""

    members, member = "records", "signatures"

    @staticmethod
    def inputs(config: dict, mix: dict, seed: int):
        # a port without the service fails here, before any input is made
        if importlib.util.find_spec("quisquis_tpu_torch.primitives.device_schnorr") is None:
            raise RuntimeError("the port has no device_schnorr program")
        return schnorr_inputs(config, mix, seed)

    @staticmethod
    def install_spans(spans) -> None:
        """None: the port's own spans (``serving.schnorr.decode`` and the
        program's) split a call."""

    def __init__(self, config: dict, mix: dict, inputs: dict, seed: int, device: str):
        super().__init__(config, mix, inputs, seed, device)
        records = inputs[self.members]
        self.group_records = [records[g[0]:g[-1] + 1] for g in self.groups]

    def service(self, device: str):
        from quisquis_tpu_torch.serving import SignatureVerificationService

        return SignatureVerificationService(backend=self.mix["backend"],
                                            label=self.config["label"].encode(),
                                            message_len=int(self.config["message_bytes"]),
                                            device=device)

    def payload(self, item):
        """The group's records (a slice made once), with the tampered copy
        in place of its record on a tampered call."""
        g, kind = item
        if kind is None:
            return self.group_records[g]
        records = list(self.group_records[g])
        records[self.inputs["tampered_index"] - self.groups[g][0]] = self.inputs["tampered"][kind]
        return records


Entry = VerifySchnorrWire
