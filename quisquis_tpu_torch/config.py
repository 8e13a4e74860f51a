"""Protocol configuration.

The reference has no config system: N = 9 (3x3), 64-bit ranges, the
generator capacities and the base pk are compile-time constants. The JAX
package makes them configuration with the reference's values as defaults;
this is the port's copy of its protocol fields. The JAX package's tile sizes
are TPU settings and have no counterpart here: each CUDA kernel's block size
is a constant in its source. Its mesh axis name has none either: a mesh of
the port is a torch.distributed group of ranks (``parallel.Mesh``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class QuisQuisConfig:
    #: anonymity-set size (must be a perfect square); reference: 9 (3x3)
    anonymity_set_size: int = 9
    #: range-proof bit width; reference: 64
    range_bits: int = 64
    #: bulletproof generator capacity for aggregated proofs; reference: (64, 16)
    bp_gens_capacity: int = 64
    bp_party_capacity: int = 16
    #: r1cs generator capacity; reference: 512
    r1cs_gens_capacity: int = 512

    @property
    def rows(self) -> int:
        m = math.isqrt(self.anonymity_set_size)
        if m * m != self.anonymity_set_size:
            raise ValueError("anonymity_set_size must be a perfect square")
        return m

    @property
    def columns(self) -> int:
        return self.rows


#: process-wide default configuration
DEFAULT = QuisQuisConfig()
