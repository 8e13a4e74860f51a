"""Pedersen generators and vector-Pedersen commitments.

`PedersenGens` mirrors bulletproofs' defaults: B = ristretto basepoint,
B_blinding = SHA3-512 hash-to-group of B's bytes (pinned by the golden
BASE_PK_BTC_COMPRESSED[1] vector). `VectorPedersenGens` reproduces the
reference's generator chain exactly
(reference src/pedersen/vectorpedersen.rs:45-85):
G_vec = [B, hash(H), hash(hash(H)), ...], H = hash(B),
commit(values, blinding) = blinding*H + sum(v_i * G_i).
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops import exact as ex


class PedersenGens:
    """bulletproofs::PedersenGens equivalent."""

    def __init__(self):
        self.B = ex.BASEPOINT
        self.B_blinding = ex.hash_to_point_sha3_512(ex.ristretto_encode(ex.BASEPOINT))

    def commit(self, value: int, blinding: int) -> ex.Point:
        return ex.pt_add(ex.pt_mul(value, self.B), ex.pt_mul(blinding, self.B_blinding))

    def commit_many(self, values: Sequence[int],
                    blindings: Sequence[int]) -> List[ex.Point]:
        """Independent commits value_i * B + blinding_i * B_blinding."""
        n = len(values)
        return ex.pt_fold_batch(list(values), list(blindings),
                                [self.B] * n, [self.B_blinding] * n)


_PC_GENS = None


def default_pedersen_gens() -> PedersenGens:
    global _PC_GENS
    if _PC_GENS is None:
        _PC_GENS = PedersenGens()
    return _PC_GENS


class VectorPedersenGens:
    """Extended Pedersen generators for vector commitments."""

    def __init__(self, gens_capacity: int):
        pc = default_pedersen_gens()
        self.H = pc.B_blinding
        self.G_vec: List[ex.Point] = []
        self.gens_capacity = 0
        self.increase_capacity(gens_capacity)

    def increase_capacity(self, new_capacity: int) -> None:
        """Chain construction per the reference (vectorpedersen.rs:61-75)."""
        if self.gens_capacity >= new_capacity:
            return
        self.G_vec.append(ex.BASEPOINT)
        other = [self.H]
        for i in range(new_capacity - 2):
            other.append(ex.hash_to_point_sha3_512(ex.ristretto_encode(other[i])))
        self.G_vec.extend(other[1:])
        self.gens_capacity = new_capacity

    def commit(self, values: Sequence[int], blinding: int) -> ex.Point:
        """blinding*H + sum(values_i * G_i)."""
        assert len(values) <= len(self.G_vec)
        return ex.pt_msm([blinding] + list(values),
                         [self.H] + self.G_vec[:len(values)])

    def commit_rows(self, rows: Sequence[Sequence[int]],
                    blindings: Sequence[int]) -> List[ex.Point]:
        """Independent row commits."""
        items = [([b] + list(vals), [self.H] + self.G_vec[:len(vals)])
                 for vals, b in zip(rows, blindings)]
        return ex.pt_msm_many(items)


_VEC_GENS_CACHE: dict = {}


def vector_pedersen_gens(capacity: int) -> VectorPedersenGens:
    """Cached generator sets (chain prefix property makes caching safe)."""
    if capacity not in _VEC_GENS_CACHE:
        _VEC_GENS_CACHE[capacity] = VectorPedersenGens(capacity)
    return _VEC_GENS_CACHE[capacity]
