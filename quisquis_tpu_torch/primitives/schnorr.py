"""zkSchnorr signatures over dual-point verification keys.

Functional re-implementation of the `zkschnorr` dependency used by the
reference (mirrored in-tree at reference src/transaction/signature.rs:
25-168): Merlin-transcript Schnorr with vk = (g, h) = (r*G, sk*r*G),
signature (s, R) with R = r_nonce * g, c = FS challenge, s = r_nonce + c*sk,
verify s*g == R + c*h.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..ops import exact as ex
from ..accounts.transcript import Transcript, SeededRng

#: the fewest signatures that Signature.batch_verify's "auto" sends to the
#: "device-batched" program (see its docstring)
AUTO_DEVICE_BATCHED_MIN = 256


@dataclass(frozen=True)
class VerificationKey:
    """(g, h) as compressed bytes; matches zkschnorr::VerificationKey."""

    g: bytes
    h: bytes

    @classmethod
    def from_secret(cls, privkey: int, r: int) -> "VerificationKey":
        g = ex.pt_base_mul(r)
        h = ex.pt_mul(privkey, g)
        return cls(ex.ristretto_encode(g), ex.ristretto_encode(h))

    def to_bytes(self) -> bytes:
        return self.g + self.h


@dataclass(frozen=True)
class Signature:
    s: int
    R: bytes

    @staticmethod
    def sign(transcript: Transcript, pubkey: VerificationKey, privkey: int,
             rng: Optional[SeededRng] = None) -> "Signature":
        trng = (transcript.clone()
                .build_rng()
                .rekey_with_witness_bytes(b"x", ex.sc_to_bytes(privkey))
                .finalize(entropy=rng.fill_bytes(32) if rng else None))
        r = trng.random_scalar()
        g_pt = ex.ristretto_decode(pubkey.g)
        if g_pt is None:
            raise ValueError("Error::Decompression Failed")
        R = ex.ristretto_encode(ex.pt_mul(r, g_pt))
        transcript.domain_sep(b"zkschnorr")
        transcript.append_point_var(b"G", pubkey.g)
        transcript.append_point_var(b"H", pubkey.h)
        transcript.append_point_var(b"R", R)
        c = transcript.get_challenge(b"c")
        s = (r + c * privkey) % ex.L
        return Signature(s, R)

    def verify(self, transcript: Transcript, pubkey: VerificationKey) -> None:
        transcript.domain_sep(b"zkschnorr")
        transcript.append_point_var(b"G", pubkey.g)
        transcript.append_point_var(b"H", pubkey.h)
        transcript.append_point_var(b"R", self.R)
        c = transcript.get_challenge(b"c")
        g_pt = ex.ristretto_decode(pubkey.g)
        h_pt = ex.ristretto_decode(pubkey.h)
        R_pt = ex.ristretto_decode(self.R)
        if g_pt is None or h_pt is None or R_pt is None:
            raise ValueError("Error::Decompression Failed")
        lhs = ex.pt_mul(self.s, g_pt)
        rhs = ex.pt_add(R_pt, ex.pt_mul(c, h_pt))
        if not ex.pt_eq(lhs, rhs):
            raise ValueError("Error::InvalidSignature")

    def verify_deferred(self, transcript: Transcript,
                        pubkey: VerificationKey, defer) -> None:
        """Transcript replay now; the point identity
        s·g − R − c·h == 0 joins the cross-proof batch MSM."""
        transcript.domain_sep(b"zkschnorr")
        transcript.append_point_var(b"G", pubkey.g)
        transcript.append_point_var(b"H", pubkey.h)
        transcript.append_point_var(b"R", self.R)
        c = transcript.get_challenge(b"c")
        g_pt = ex.ristretto_decode(pubkey.g)
        h_pt = ex.ristretto_decode(pubkey.h)
        R_pt = ex.ristretto_decode(self.R)
        if g_pt is None or h_pt is None or R_pt is None:
            raise ValueError("Error::Decompression Failed")
        defer.check([self.s, ex.L - 1, (-c) % ex.L], [g_pt, R_pt, h_pt],
                    "Error::InvalidSignature")

    @staticmethod
    def batch_verify(items, backend: str = "auto", mesh=None,
                     seed: Optional[bytes] = None, device="cuda") -> None:
        """Verify many (signature, transcript, vk) triples with one MSM
        (BASELINE config 3: batched Schnorr verification; three terms a
        signature, coalesced on the shared points).

        backend: "device-batched" (``primitives.device_schnorr``: the
        transcripts, decodes, scalar arithmetic and the MSM of every
        signature as one program on ``device``, the host transcripts' states
        carried over), or that of ``DeferredPointChecks.verify`` after a
        host replay: "device" (the MSM kernels on ``device``), "host" (the
        C++ curve's Pippenger), "sharded" (the MSM's point axis split over
        the ranks of ``mesh``, a ``parallel.Mesh``; every rank replays every
        transcript) or "auto" (``device`` resolved first, so the default
        raises without a GPU; "device-batched" from
        :data:`AUTO_DEVICE_BATCHED_MIN` signatures, else
        ``DeferredPointChecks.verify``'s rule on the coalesced term
        count). On the H100 (host / device / device-batched ms a call, one
        distinct key a signature, ``auto_rules.read_schnorr``, median of
        two after a warm call) the three were even at 64 signatures
        (10.9 / 10.6 / 10.7), and "device-batched" led from 256 (29.1 /
        23.1 / 8.8), 1,024 (192.1 / 99.2 / 9.2), 4,096 (492.9 / 404.2 /
        19.3) and 21,845 (2,376.0 / 2,592.2 / 39.7; PERF.md §6)."""
        from ..accounts.deferred import DeferredPointChecks
        from ..device import resolve_device

        items = list(items)
        if backend in ("auto", "device", "device-batched"):
            resolve_device(device)   # before the transcript replay
        if backend == "auto" and len(items) >= AUTO_DEVICE_BATCHED_MIN:
            backend = "device-batched"
        if backend == "device-batched":
            from .device_schnorr import verify_transcripts

            if not verify_transcripts(items, seed=seed, device=device):
                raise ValueError("Error::InvalidSignature (device-batched)")
            return
        defer = DeferredPointChecks(seed)
        for sig, transcript, vk in items:
            sig.verify_deferred(transcript, vk, defer)
        defer.verify(backend=backend, device=device, mesh=mesh)

    # -- message-oriented API ------------------------------------------------

    @staticmethod
    def _transcript_for_message(label: bytes, message: bytes) -> Transcript:
        t = Transcript(b"ZkSchnorr.sign_message")
        t.append_message(label, message)
        return t

    @staticmethod
    def sign_message(label: bytes, message: bytes, pubkey: VerificationKey,
                     privkey: int, rng: Optional[SeededRng] = None) -> "Signature":
        return Signature.sign(Signature._transcript_for_message(label, message),
                              pubkey, privkey, rng=rng)

    def verify_message(self, label: bytes, message: bytes,
                       pubkey: VerificationKey) -> None:
        self.verify(Signature._transcript_for_message(label, message), pubkey)

    def to_bytes(self) -> bytes:
        return ex.sc_to_bytes(self.s) + self.R

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        assert len(data) == 64
        return cls(ex.sc_from_bytes_mod_order(data[:32]), data[32:])
