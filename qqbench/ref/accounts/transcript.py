"""Merlin transcripts and the Quisquis transcript protocol.

Bit-exact reimplementation of merlin v2's `Transcript` / `TranscriptRng`
(STROBE-128 over Keccak-f[1600]) plus the Quisquis-specific
`TranscriptProtocol` extension mirroring
reference src/accounts/transcript.rs:16-82 (domain_sep,
append_scalar_var, append_point_var, append_account_var, get_challenge).

The transcript is host-side by design: every operation is tiny and strictly
sequential; the TPU design batches all heavy algebra (MSMs, point ops) on
device and appends only compressed byte digests here, minimizing
host<->device ping-pong.
"""

from __future__ import annotations

import os
import struct

from ..ops import exact as ex
from ..ops import host_strobe as _native
from ..ops.strobe import Strobe128 as PyStrobe128

#: the host STROBE: the C++ one (ops/host_strobe.py) where g++ built it,
#: else the pure-Python one; both give the same bytes
Strobe128 = _native.NativeStrobe128 if _native.available() else PyStrobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _u32le(n: int) -> bytes:
    return struct.pack("<I", n)


class Transcript:
    """merlin::Transcript equivalent."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        t = object.__new__(Transcript)
        t.strobe = self.strobe.clone()
        return t

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(message)), True)
        self.strobe.ad(message, False)

    def append_messages(self, items) -> None:
        """Run of append_message (label, message) pairs: one native call
        when the C++ STROBE is in use."""
        am = getattr(self.strobe, "append_messages", None)
        if am is not None:
            am(items)
            return
        for label, message in items:
            self.append_message(label, message)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, struct.pack("<Q", x))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        return self.strobe.prf(n, False)

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())

    # ---- Quisquis TranscriptProtocol extension ---------------------------

    def domain_sep(self, label: bytes) -> None:
        self.append_message(b"dom-sep", label)

    def append_scalar_var(self, label: bytes, scalar: int) -> None:
        self.append_message(label, ex.sc_to_bytes(scalar))

    def append_point_var(self, label: bytes, point_bytes: bytes) -> None:
        self.append_messages([(b"ptvar", label), (b"val", point_bytes)])

    def append_account_var(self, label: bytes, account) -> None:
        """account exposes .pk.gr/.pk.grsk/.comm.c/.comm.d as 32-byte values."""
        self.append_messages([
            (b"acvar", label), (b"gr", account.pk.gr),
            (b"grsk", account.pk.grsk), (b"commc", account.comm.c),
            (b"commd", account.comm.d)])

    def get_challenge(self, label: bytes) -> int:
        return ex.sc_from_bytes_mod_order_wide(self.challenge_bytes(label, 64))


class TranscriptRngBuilder:
    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness: bytes) -> "TranscriptRngBuilder":
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(witness)), True)
        self.strobe.key(witness, False)
        return self

    def rekey_with_witness_batch(self, label: bytes, witnesses: bytes,
                                 wlen: int) -> "TranscriptRngBuilder":
        """rekey_with_witness_bytes over count fixed-size witnesses packed
        in one buffer: one native call when the C++ STROBE is in use."""
        count = len(witnesses) // wlen
        rk = getattr(self.strobe, "rekey_witnesses", None)
        if rk is not None:
            rk(label, witnesses, wlen, count)
            return self
        for i in range(count):
            self.rekey_with_witness_bytes(
                label, witnesses[i * wlen:(i + 1) * wlen])
        return self

    def finalize(self, entropy: bytes | None = None) -> "TranscriptRng":
        """Finalize with 32 bytes of external entropy.

        The reference finalizes with `thread_rng()` (non-deterministic,
        reference src/accounts/prover.rs:71). Here entropy is injectable
        so proofs are reproducible on device; defaults to os.urandom.
        """
        if entropy is None:
            entropy = os.urandom(32)
        assert len(entropy) == 32
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(entropy, False)
        return TranscriptRng(self.strobe)


class TranscriptRng:
    """merlin::TranscriptRng equivalent (witness-rekeyed PRF stream)."""

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def fill_bytes(self, n: int) -> bytes:
        self.strobe.meta_ad(_u32le(n), False)
        return self.strobe.prf(n, False)

    def random_scalar(self) -> int:
        """Scalar::random(rng) equivalent: 64 bytes reduced mod l."""
        return ex.sc_from_bytes_mod_order_wide(self.fill_bytes(64))


class SeededRng:
    """Deterministic stand-in for OsRng: a private Merlin-based PRF stream.

    Used wherever the reference calls `OsRng`/`thread_rng` so that tests can
    pin witnesses and compare prover outputs bit-exactly across backends.
    """

    def __init__(self, seed: bytes | None = None):
        if seed is None:
            seed = os.urandom(32)
        t = Transcript(b"quisquis-tpu-seeded-rng")
        t.append_message(b"seed", seed)
        self._rng = t.build_rng().finalize(entropy=b"\x00" * 32)

    def fill_bytes(self, n: int) -> bytes:
        return self._rng.fill_bytes(n)

    def random_scalar(self) -> int:
        return self._rng.random_scalar()
