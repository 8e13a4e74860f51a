"""The yardstick of the MSM roofline: the least time a multiscalar
multiplication could take on the card, whatever implements it.

For one MSM of n terms with 253-bit scalars, the bound is the larger of two
times:

- bytes: its input points (four coordinates of ten 32-bit limbs, 160 bytes,
  the form the port hands its MSM) and scalars (32 bytes) read once, and
  one such point written, at the card's memory rate;
- operations: the point additions and doublings of the cheaper of two
  methods, each at its best width for that n, in 32x32-bit limb products
  at today's field contract (100 a multiply, 55 a square), at the card's
  int32 rate:
  - Pippenger's bucket method with signed digits, window c: w =
    ceil(253 / c) windows, each n additions to fill its 2^(c-1) buckets
    and 2^c to sum them, joined by (w - 1) * c doublings;
  - Straus's interleaved windows with signed digits, width v: 2^(v-1) - 1
    additions a point for its multiples, n additions in each of
    ceil(253 / v) windows, and 252 doublings shared by all terms (the
    cheaper method at a few terms, where the buckets cost more than the
    terms).
  An addition is costed as a mixed one (7 multiplies, the cheapest in
  extended coordinates), a doubling as 4 multiplies and 4 squares.

The counts err low, so neither method, nor the port's windowed kernels,
can read above 100% against it. The count is frozen here; ``tests/`` checks
it against counts by hand.
"""

from __future__ import annotations

import json
import math

from .paths import PKG

SCALAR_BITS = 253
PRODUCTS_PER_MUL = 100
PRODUCTS_PER_SQ = 55
ADD_PRODUCTS = 7 * PRODUCTS_PER_MUL
DOUBLE_PRODUCTS = 4 * PRODUCTS_PER_MUL + 4 * PRODUCTS_PER_SQ
POINT_BYTES = 4 * 10 * 4
SCALAR_BYTES = 32
MAX_WINDOW = 24


def pippenger_products(n: int) -> int:
    """Limb products of Pippenger's bucket method for n terms at its best
    window."""
    if n <= 0:
        return 0
    costs = []
    for c in range(1, MAX_WINDOW + 1):
        w = math.ceil(SCALAR_BITS / c)
        costs.append(w * (n + (1 << c)) * ADD_PRODUCTS + (w - 1) * c * DOUBLE_PRODUCTS)
    return min(costs)


def straus_products(n: int) -> int:
    """Limb products of Straus's interleaved windows for n terms at their
    best width."""
    if n <= 0:
        return 0
    costs = []
    for v in range(1, MAX_WINDOW + 1):
        adds = n * ((1 << (v - 1)) - 1) + n * math.ceil(SCALAR_BITS / v)
        costs.append(adds * ADD_PRODUCTS + (SCALAR_BITS - 1) * DOUBLE_PRODUCTS)
    return min(costs)


def msm_products(n: int) -> int:
    """Limb products of the bound: the cheaper method for n terms."""
    return min(pippenger_products(n), straus_products(n))


def msm_bytes(n: int) -> int:
    return n * (POINT_BYTES + SCALAR_BYTES) + POINT_BYTES if n > 0 else 0


def peaks(card: str):
    """The card's peaks from ``peaks.json`` by its name (as
    ``torch.cuda.get_device_name`` gives it), or None for a card the table
    does not hold."""
    with open(PKG / "peaks.json") as f:
        table = json.load(f)
    return table.get(card)


def msm_bound_s(n: int, card_peaks: dict) -> float:
    """Seconds of the bound for one MSM of n terms on a card."""
    ops_s = msm_products(n) / card_peaks["int32_ops_per_s"]
    bytes_s = msm_bytes(n) / card_peaks["memory_bytes_per_s"]
    return max(ops_s, bytes_s)
