"""ElGamal commitments (host objects + reference semantics).

Mirrors reference src/elgamal/elgamal.rs:19-255:
commitment (c, d) = (r*gr, v*G + r*grsk); homomorphic add/sub/scalar-mul;
verify d == v*G + sk*c; decommit d - sk*c; value recovery by discrete-log
search (the reference brute-forces 0..2^64 linearly,
elgamal.rs:169-182 — here a baby-step/giant-step search with identical
semantics for values in range, plus the same bounded behavior).

Wire format: 64 bytes c||d (elgamal.rs:135-156). Batched device kernels for
commitment generation/addition live in :mod:`quisquis_tpu_torch.ops.batch`.
"""

from __future__ import annotations

from typing import Optional

from ..ops import exact as ex
from .keys import RistrettoPublicKey, RistrettoSecretKey


class ElGamalCommitment:
    __slots__ = ("c", "d", "_c_pt", "_d_pt")

    def __init__(self, c: bytes, d: bytes,
                 c_pt: Optional[ex.Point] = None, d_pt: Optional[ex.Point] = None):
        assert len(c) == 32 and len(d) == 32
        self.c = c
        self.d = d
        self._c_pt = c_pt
        self._d_pt = d_pt

    @classmethod
    def from_points(cls, c_pt: ex.Point, d_pt: ex.Point) -> "ElGamalCommitment":
        return cls(ex.ristretto_encode(c_pt), ex.ristretto_encode(d_pt), c_pt, d_pt)

    @property
    def c_point(self) -> ex.Point:
        if self._c_pt is None:
            p = ex.ristretto_decode(self.c)
            if p is None:
                raise ValueError("Error::Decompression Failed")
            self._c_pt = p
        return self._c_pt

    @property
    def d_point(self) -> ex.Point:
        if self._d_pt is None:
            p = ex.ristretto_decode(self.d)
            if p is None:
                raise ValueError("Error::Decompression Failed")
            self._d_pt = p
        return self._d_pt

    # -- core operations ----------------------------------------------------

    @staticmethod
    def generate_commitment(p: RistrettoPublicKey, rscalar: int,
                            bl_scalar: int) -> "ElGamalCommitment":
        c = ex.pt_mul(rscalar, p.gr_point)
        gv = ex.pt_base_mul(bl_scalar)
        kh = ex.pt_mul(rscalar, p.grsk_point)
        return ElGamalCommitment.from_points(c, ex.pt_add(gv, kh))

    @staticmethod
    def add_commitments(a: "ElGamalCommitment",
                        b: "ElGamalCommitment") -> "ElGamalCommitment":
        return ElGamalCommitment.from_points(
            ex.pt_add(a.c_point, b.c_point), ex.pt_add(a.d_point, b.d_point))

    def verify_commitment(self, sk: RistrettoSecretKey, bl_scalar: int) -> None:
        rhs = ex.pt_add(ex.pt_base_mul(bl_scalar),
                        ex.pt_mul(sk.scalar, self.c_point))
        if ex.ristretto_encode(rhs) != self.d:
            raise ValueError("Invalid Account::Commitment Verification Failed")

    def decommit(self, sk: RistrettoSecretKey) -> bytes:
        """Returns compressed G*v = d - sk*c."""
        return ex.ristretto_encode(
            ex.pt_sub(self.d_point, ex.pt_mul(sk.scalar, self.c_point)))

    def decommit_value(self, sk: RistrettoSecretKey,
                       max_value: int = 1 << 40) -> Optional[int]:
        """Recover v with v*G == d - sk*c by discrete-log search.

        The reference scans 0..2^64 linearly (elgamal.rs:169-182); here a
        baby-step/giant-step search over [0, max_value) with the same
        found/None semantics.
        """
        target = ex.pt_sub(self.d_point, ex.pt_mul(sk.scalar, self.c_point))
        return discrete_log(target, max_value)

    # -- serde --------------------------------------------------------------

    def to_bytes(self) -> bytes:
        return self.c + self.d

    @classmethod
    def from_bytes(cls, data: bytes) -> "ElGamalCommitment":
        if len(data) != 64:
            raise ValueError("Invalid Encryption Length")
        c, d = data[:32], data[32:]
        if ex.ristretto_decode(c) is None or ex.ristretto_decode(d) is None:
            raise ValueError("InvalidPoint")
        return cls(c, d)

    # -- operators -----------------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, ElGamalCommitment) and \
            self.c == other.c and self.d == other.d

    def __hash__(self):
        return hash((self.c, self.d))

    def __sub__(self, other: "ElGamalCommitment") -> "ElGamalCommitment":
        return ElGamalCommitment.from_points(
            ex.pt_sub(self.c_point, other.c_point),
            ex.pt_sub(self.d_point, other.d_point))

    def __mul__(self, scalar: int) -> "ElGamalCommitment":
        return ElGamalCommitment.from_points(
            ex.pt_mul(scalar, self.c_point), ex.pt_mul(scalar, self.d_point))

    def __repr__(self):
        return f"ElGamalCommitment(c={self.c.hex()[:16]}.., d={self.d.hex()[:16]}..)"


_BABY_TABLE: dict = {}
_BABY_STEPS = 0


def _baby_table(baby_steps: int) -> dict:
    global _BABY_TABLE, _BABY_STEPS
    if _BABY_STEPS < baby_steps:
        p = ex.pt_mul(_BABY_STEPS, ex.BASEPOINT)
        for j in range(_BABY_STEPS, baby_steps):
            _BABY_TABLE[ex.ristretto_encode(p)] = j
            p = ex.pt_add(p, ex.BASEPOINT)
        _BABY_STEPS = baby_steps
    return _BABY_TABLE


def discrete_log(target: ex.Point, max_value: int, baby_steps: int = 1 << 12) -> Optional[int]:
    """Baby-step/giant-step: find v in [0, max_value) with v*G == target."""
    enc_target = ex.ristretto_encode(target)
    # baby table: j -> j*G for j in [0, m), cached across calls
    table = _baby_table(baby_steps)
    if enc_target in table:
        v = table[enc_target]
        return v if v < max_value else None
    # giant steps: target - i*m*G
    giant = ex.pt_neg(ex.pt_mul(baby_steps, ex.BASEPOINT))
    cur = target
    num_giants = -(-max_value // baby_steps)
    for i in range(1, num_giants + 1):
        cur = ex.pt_add(cur, giant)
        j = table.get(ex.ristretto_encode(cur))
        if j is not None:
            v = i * baby_steps + j
            return v if v < max_value else None
    return None
