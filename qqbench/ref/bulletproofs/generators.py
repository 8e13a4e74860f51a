"""Bulletproofs generator chains.

Reproduces the dalek-bulletproofs `BulletproofGens` construction used by the
reference (Cargo.toml:52-55 dependency; used at
reference src/accounts/prover.rs:565,575): per-party G/H generator
vectors drawn from a SHAKE-256 `GeneratorsChain` seeded with
b"GeneratorsChain" || label, where the party labels are [b'G'|b'H'] ||
LE32(party index); each 64-byte read maps to a point via
ristretto255 from_uniform_bytes.

Note this chain is distinct from the reference's own `VectorPedersenGens`
SHA3-512 chain (src/pedersen/vectorpedersen.rs:61-75); both are implemented
separately and exactly.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List

from ..ops import exact as ex


def generators_chain(label: bytes, count: int) -> List[ex.Point]:
    """SHAKE-256 XOF chain of ristretto points."""
    xof = hashlib.shake_256(b"GeneratorsChain" + label).digest(64 * count)
    return [ex.ristretto_from_uniform_bytes(xof[64 * i:64 * (i + 1)])
            for i in range(count)]


class BulletproofGens:
    """Per-party G/H generator vectors."""

    def __init__(self, gens_capacity: int, party_capacity: int):
        self.gens_capacity = gens_capacity
        self.party_capacity = party_capacity
        self.G_vec: List[List[ex.Point]] = []
        self.H_vec: List[List[ex.Point]] = []
        for i in range(party_capacity):
            label = struct.pack("<I", i)
            self.G_vec.append(generators_chain(b"G" + label, gens_capacity))
            self.H_vec.append(generators_chain(b"H" + label, gens_capacity))

    def G(self, n: int, m: int) -> List[ex.Point]:
        """Interleaved: for each generator index, cycle over parties? No —
        dalek's GensIter yields party-major blocks: all n gens of party 0,
        then party 1, ... (AggregatedGensIter chunks by party)."""
        return [self.G_vec[j][i] for j in range(m) for i in range(n)]

    def H(self, n: int, m: int) -> List[ex.Point]:
        return [self.H_vec[j][i] for j in range(m) for i in range(n)]


_BP_GENS_CACHE: dict = {}


def bulletproof_gens(gens_capacity: int, party_capacity: int) -> BulletproofGens:
    key = (gens_capacity, party_capacity)
    if key not in _BP_GENS_CACHE:
        _BP_GENS_CACHE[key] = BulletproofGens(gens_capacity, party_capacity)
    return _BP_GENS_CACHE[key]
