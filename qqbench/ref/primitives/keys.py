"""Quisquis dual-point Ristretto keys.

Mirrors the reference API surface (reference src/keys.rs:11-126 and
reference src/ristretto/keys.rs:30-282) re-designed for this framework:
host objects carry canonical compressed bytes (wire format identical to the
reference: pk = gr_bytes || grsk_bytes, 64 bytes) and cached decompressed
exact points; batch/device variants live in :mod:`quisquis_tpu_torch.ops`.

Notable reference quirks preserved for parity:
* `PublicKey + PublicKey` is defined as point *subtraction*
  (src/ristretto/keys.rs:251-264) — kept, with a clearer `sub_keys` alias.
* `SecretKey::from_bytes` is SHA-512 hash-to-scalar (src/keys.rs + keys.rs:44-46).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..ops import exact as ex


@dataclass(frozen=True)
class RistrettoSecretKey:
    """Secret key: a scalar mod l."""

    scalar: int

    @classmethod
    def random(cls, rng) -> "RistrettoSecretKey":
        return cls(rng.random_scalar())

    @classmethod
    def from_bytes(cls, data: bytes) -> "RistrettoSecretKey":
        """Hash-to-scalar via SHA-512 (Scalar::hash_from_bytes::<Sha512>)."""
        return cls(ex.sc_hash_from_bytes_sha512(data))

    def as_bytes(self) -> bytes:
        return ex.sc_to_bytes(self.scalar)

    @staticmethod
    def key_length() -> int:
        return 32


class RistrettoPublicKey:
    """Dual-point public key pk = (gr, grsk) with gr = r*G, grsk = sk*r*G."""

    __slots__ = ("gr", "grsk", "_gr_pt", "_grsk_pt")

    def __init__(self, gr: bytes, grsk: bytes,
                 gr_pt: Optional[ex.Point] = None,
                 grsk_pt: Optional[ex.Point] = None):
        assert len(gr) == 32 and len(grsk) == 32
        self.gr = gr
        self.grsk = grsk
        self._gr_pt = gr_pt
        self._grsk_pt = grsk_pt

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_points(cls, gr_pt: ex.Point, grsk_pt: ex.Point) -> "RistrettoPublicKey":
        return cls(ex.ristretto_encode(gr_pt), ex.ristretto_encode(grsk_pt),
                   gr_pt, grsk_pt)

    @classmethod
    def from_secret_key(cls, sk: RistrettoSecretKey, rng) -> "RistrettoPublicKey":
        r = rng.random_scalar()
        gr = ex.pt_base_mul(r)
        grsk = ex.pt_mul(sk.scalar, gr)
        return cls.from_points(gr, grsk)

    @classmethod
    def from_bytes(cls, data: bytes) -> "RistrettoPublicKey":
        if len(data) != 64:
            raise ValueError("slice with incorrect length. Should be 64 bytes")
        return cls(data[:32], data[32:])

    # -- point access (lazy decompress) ------------------------------------

    @property
    def gr_point(self) -> ex.Point:
        if self._gr_pt is None:
            p = ex.ristretto_decode(self.gr)
            if p is None:
                raise ValueError("Error::Decompression Failed")
            self._gr_pt = p
        return self._gr_pt

    @property
    def grsk_point(self) -> ex.Point:
        if self._grsk_pt is None:
            p = ex.ristretto_decode(self.grsk)
            if p is None:
                raise ValueError("Error::Decompression Failed")
            self._grsk_pt = p
        return self._grsk_pt

    # -- API parity with the reference -------------------------------------

    def as_bytes(self) -> bytes:
        return self.gr + self.grsk

    @staticmethod
    def key_length() -> int:
        return 32

    @staticmethod
    def update_public_key(p: "RistrettoPublicKey", rscalar: int) -> "RistrettoPublicKey":
        """pk' = rscalar * pk (both points)."""
        return RistrettoPublicKey.from_points(
            ex.pt_mul(rscalar, p.gr_point), ex.pt_mul(rscalar, p.grsk_point))

    @staticmethod
    def verify_public_key_update(u: "RistrettoPublicKey", p: "RistrettoPublicKey",
                                 rscalar: int) -> bool:
        grr = ex.pt_mul(rscalar, p.gr_point)
        grrsk = ex.pt_mul(rscalar, p.grsk_point)
        return ex.pt_eq(grr, u.gr_point) and ex.pt_eq(grrsk, u.grsk_point)

    @staticmethod
    def generate_base_pk() -> "RistrettoPublicKey":
        """The hard-coded base pk (src/ristretto/constants.rs:12-21)."""
        return RistrettoPublicKey(BASE_PK_BTC[0], BASE_PK_BTC[1])

    def verify_keypair(self, sk: RistrettoSecretKey) -> None:
        if ex.ristretto_encode(ex.pt_mul(sk.scalar, self.gr_point)) != self.grsk:
            raise ValueError("Invalid Account::Keypair Verification Failed")

    # -- operators ----------------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, RistrettoPublicKey) and \
            self.gr == other.gr and self.grsk == other.grsk

    def __hash__(self):
        return hash((self.gr, self.grsk))

    def __add__(self, other: "RistrettoPublicKey") -> "RistrettoPublicKey":
        """Reference quirk: `Add` is point subtraction (keys.rs:251-264)."""
        return self.sub_keys(other)

    def sub_keys(self, other: "RistrettoPublicKey") -> "RistrettoPublicKey":
        return RistrettoPublicKey.from_points(
            ex.pt_sub(self.gr_point, other.gr_point),
            ex.pt_sub(self.grsk_point, other.grsk_point))

    def __mul__(self, scalar: int) -> "RistrettoPublicKey":
        return RistrettoPublicKey.from_points(
            ex.pt_mul(scalar, self.gr_point), ex.pt_mul(scalar, self.grsk_point))

    def __repr__(self):
        return f"RistrettoPublicKey(gr={self.gr.hex()[:16]}.., grsk={self.grsk.hex()[:16]}..)"


#: Hard-coded base pk bytes (== reference BASE_PK_BTC_COMPRESSED; [0] is the
#: ristretto basepoint, [1] is bulletproofs' default B_blinding)
BASE_PK_BTC = (
    bytes([226, 242, 174, 10, 106, 188, 78, 113, 168, 132, 169, 97, 197, 0, 81, 95,
           88, 227, 11, 106, 165, 130, 221, 141, 182, 166, 89, 69, 224, 141, 45, 118]),
    bytes([140, 146, 64, 180, 86, 169, 230, 220, 101, 195, 119, 161, 4, 141, 116, 95,
           148, 160, 140, 219, 127, 68, 203, 205, 123, 70, 243, 64, 72, 135, 17, 52]),
)
