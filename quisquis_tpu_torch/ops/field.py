"""Batched GF(2^255-19) arithmetic in PyTorch: the plain versions of the
CUDA field library (``csrc/field25519.cuh``), limb for limb.

Representation (dalek's 32-bit backend layout, FieldElement2625)
-----------------------------------------------------------------
A field element is an int32 tensor ``[..., 10]``: limb ``i`` has weight
``2^OFF[i]`` with ``OFF = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]``,
so even limbs hold 26 bits and odd limbs 25 bits. Arithmetic runs in int64.
A product of limbs ``i`` and ``j`` lands in column ``(i + j) mod 10`` times
2 when both are odd (the half bit of radix 2^25.5) and times 19 when
``i + j >= 10`` (``2^255 = 19 mod p``); the factors are applied before the
column sums, so the multiply needs no carry chain inside it.

Bounds (checked at import by exact interval arithmetic, below)
---------------------------------------------------------------
* Every operation takes and returns limbs in ``[0, CONTRACT[i]]`` with
  ``CONTRACT[i] = 2^26-1`` (even i) or ``2^25-1`` (odd i), plus ``SLACK =
  2^9`` on limbs 1 and 5: the carry chain :data:`CARRY_ORDER` (dalek's
  ``reduce``) leaves at most 191 and 119 there. The value may be >= p.
* ``mul``/``square``: each product is < 2^57.3, each column < 2^59 (<
  2^63), then the carry chain.
* ``add``: limbs < 2^27.01 before the chain. ``sub``/``neg``: ``a + BIAS - b``
  with ``BIAS = 2p`` in this radix (limbs 2^27-38, 2^26-2, 2^27-2, ...), which
  dominates CONTRACT limb by limb, so no limb goes negative; < 2^28.01
  before the chain. This is the counterpart of the JAX package's ``BIAS``.
* ``mul_small(a, c)`` for ``0 <= c <= 2^30``: limbs < 2^56.01 before the
  chain, which then leaves at most 304 on limb 1.
* ``canonicalize`` maps CONTRACT limbs (value < 2p) to the unique limbs of
  ``value mod p`` with every limb below its mask.
* In the CUDA multiply, ``19*b_j`` and ``2*a_i`` (odd i) are formed in int32:
  both < 2^31, asserted below.

Compared with the JAX package only at canonical values (ints mod p, bytes).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from . import exact as ex

P = ex.P
NLIMBS = 10
BITS = [26, 25] * 5
OFF = [sum(BITS[:i]) for i in range(NLIMBS)]
MASKS = [(1 << b) - 1 for b in BITS]
SLACK = 1 << 9
CONTRACT = [m + (SLACK if i in (1, 5) else 0) for i, m in enumerate(MASKS)]
CARRY_ORDER = (0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0)
INT64_MAX = 2**63 - 1
INT32_MAX = 2**31 - 1
MAX_SMALL = 1 << 30

_P_LIMBS = [(P >> o) & m for o, m in zip(OFF, MASKS)]
BIAS = [2 * v for v in _P_LIMBS]


def _factor(i: int, j: int) -> int:
    return (19 if i + j >= NLIMBS else 1) * (2 if i % 2 and j % 2 else 1)


def _reduce_bounds(bounds):
    """Upper bounds after the carry chain, asserting no int64 overflow."""
    b = list(bounds)
    for i in CARRY_ORDER:
        c = b[i] >> BITS[i]
        b[i] = min(b[i], MASKS[i])
        if i == NLIMBS - 1:
            b[0] += 19 * c
        else:
            b[i + 1] += c
        assert max(b) <= INT64_MAX, b
    return b


def _mul_col_bounds(a, b):
    cols = [0] * NLIMBS
    for i in range(NLIMBS):
        for j in range(NLIMBS):
            cols[(i + j) % NLIMBS] += a[i] * b[j] * _factor(i, j)
    return cols


def _within(bounds) -> bool:
    return all(x <= c for x, c in zip(bounds, CONTRACT))


# the contract is closed under every operation
assert sum(c << o for c, o in zip(CONTRACT, OFF)) < 2 * P
assert all(b >= c for b, c in zip(BIAS, CONTRACT))
assert sum(b << o for b, o in zip(BIAS, OFF)) == 2 * P
assert max(_mul_col_bounds(CONTRACT, CONTRACT)) <= INT64_MAX
assert _within(_reduce_bounds(_mul_col_bounds(CONTRACT, CONTRACT)))
assert _within(_reduce_bounds([2 * c for c in CONTRACT]))
assert _within(_reduce_bounds([c + b for c, b in zip(CONTRACT, BIAS)]))
assert _within(_reduce_bounds([c * MAX_SMALL for c in CONTRACT]))
assert max(19 * c for c in CONTRACT) <= INT32_MAX
assert max(4 * c for c in CONTRACT) <= INT32_MAX  # the CUDA square's 4*a_i


# ---------------------------------------------------------------------------
# constants per device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mul_tables(device: torch.device):
    """(factor [10,10], row index [10,10], col index [10,10]): column k sums
    prod[i, (k - i) mod 10] over i."""
    f = torch.tensor([[_factor(i, j) for j in range(NLIMBS)] for i in range(NLIMBS)],
                     dtype=torch.int64, device=device)
    ii = torch.arange(NLIMBS, device=device).expand(NLIMBS, NLIMBS)
    jj = (torch.arange(NLIMBS, device=device)[:, None] - ii) % NLIMBS
    return f, ii, jj


@functools.lru_cache(maxsize=None)
def _limb_const(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def _bias(device) -> torch.Tensor:
    return _limb_const(tuple(BIAS), torch.device(device))


# ---------------------------------------------------------------------------
# host <-> tensor conversion
# ---------------------------------------------------------------------------

def _limbs_from_le_bytes(b: np.ndarray) -> np.ndarray:
    """[..., 32] uint8 LE (bit 255 already cleared) -> int32 [..., 10]."""
    b = np.asarray(b, dtype=np.int64)
    pad = np.zeros(b.shape[:-1] + (4,), dtype=np.int64)
    b = np.concatenate([b, pad], axis=-1)
    out = np.empty(b.shape[:-1] + (NLIMBS,), dtype=np.int32)
    for i, (o, m) in enumerate(zip(OFF, MASKS)):
        j, r = divmod(o, 8)
        window = sum(b[..., j + k] << (8 * k) for k in range(5))
        out[..., i] = (window >> r) & m
    return out


def from_int(x: int) -> np.ndarray:
    return from_int_batch([x])[0]


def from_int_batch(xs) -> np.ndarray:
    """Python ints -> canonical int32 limbs [n, 10] (numpy)."""
    buf = b"".join((int(x) % P).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(len(xs), 32)
    return _limbs_from_le_bytes(arr)


def to_int(limbs) -> int:
    return to_int_batch(np.asarray(limbs).reshape(1, NLIMBS))[0]


def to_int_batch(limbs) -> list:
    """Limbs [..., 10] (tensor or array) -> flat list of ints mod p."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    flat = np.asarray(limbs, dtype=np.int64).reshape(-1, NLIMBS)
    return [sum(int(v) << o for v, o in zip(row, OFF)) % P for row in flat]


def zeros(shape=(), device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (NLIMBS,), dtype=torch.int32,
                       device=resolve_device(device))


def ones(shape=(), device="cuda") -> torch.Tensor:
    o = zeros(shape, device)
    o[..., 0] = 1
    return o


def const(x: int, shape=(), device="cuda") -> torch.Tensor:
    c = torch.as_tensor(from_int(x), device=resolve_device(device))
    return c.expand(tuple(shape) + (NLIMBS,)).contiguous()


def to_tensor(limbs: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(limbs, dtype=np.int32), device=device)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _reduce_(z: torch.Tensor) -> torch.Tensor:
    """Carry chain on nonnegative int64 limbs [..., 10] -> CONTRACT int32.

    In place, as the trailing underscore says: z is overwritten. Pass only a
    temporary that an arithmetic expression has just made (a sum, a product),
    never a tensor anyone else holds and never the bare result of ``.long()``,
    which is its own argument when that is int64 already.

    The chain's steps (i, i + 4) touch different limbs, so each pair is one
    strided step: the same integers as carrying limb by limb in CARRY_ORDER."""
    for i in range(5):
        pair = z[..., i:i + 5:4]              # limbs i and i + 4, of equal width
        c = pair >> BITS[i]
        pair &= MASKS[i]
        z[..., i + 1:i + 6:4] += c            # limbs i + 1 and i + 5
    top, low = z[..., NLIMBS - 1], z[..., 0]
    c = top >> BITS[-1]
    top &= MASKS[-1]
    low += 19 * c
    c = low >> BITS[0]
    low &= MASKS[0]
    z[..., 1] += c
    return z.to(torch.int32)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce_(a.long() + b.long())


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce_(a.long() + _bias(a.device) - b.long())


def neg(a: torch.Tensor) -> torch.Tensor:
    return _reduce_(_bias(a.device) - a.long())


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    if not 0 <= c <= MAX_SMALL:
        raise ValueError(f"mul_small constant {c} outside [0, 2^30]")
    return _reduce_(a.long() * c)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    f, ii, jj = _mul_tables(a.device)
    prod = a.long()[..., :, None] * b.long()[..., None, :] * f
    return _reduce_(prod[..., ii, jj].sum(-1))


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        a = square(a)
    return a


def _pow22501(z: torch.Tensor):
    """(z^(2^250-1), z^11): the shared head of the inversion chains."""
    t0 = square(z)
    t2 = mul(z, pow2k(t0, 2))          # z^9
    t3 = mul(t0, t2)                   # z^11
    t5 = mul(t2, square(t3))           # z^(2^5-1)
    t7 = mul(pow2k(t5, 5), t5)         # z^(2^10-1)
    t9 = mul(pow2k(t7, 10), t7)        # z^(2^20-1)
    t11 = mul(pow2k(t9, 20), t9)       # z^(2^40-1)
    t13 = mul(pow2k(t11, 10), t7)      # z^(2^50-1)
    t15 = mul(pow2k(t13, 50), t13)     # z^(2^100-1)
    t17 = mul(pow2k(t15, 100), t15)    # z^(2^200-1)
    t19 = mul(pow2k(t17, 50), t13)     # z^(2^250-1)
    return t19, t3


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) (maps 0 to 0)."""
    t19, t3 = _pow22501(z)
    return mul(pow2k(t19, 5), t3)


def pow_p58(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252-3)."""
    t19, _ = _pow22501(z)
    return mul(pow2k(t19, 2), z)


# ---------------------------------------------------------------------------
# canonicalization, comparison, serialization
# ---------------------------------------------------------------------------

def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """CONTRACT limbs -> the canonical limbs of value mod p."""
    h = list(a.long().unbind(-1))
    q = (h[0] + 19) >> BITS[0]
    for i in range(1, NLIMBS):
        q = (h[i] + q) >> BITS[i]
    # q = floor((value + 19) / 2^255), 1 iff value >= p (value < 2p)
    h[0] = h[0] + 19 * q
    for i in range(NLIMBS - 1):
        h[i + 1] = h[i + 1] + (h[i] >> BITS[i])
        h[i] = h[i] & MASKS[i]
    h[-1] = h[-1] & MASKS[-1]  # drops 2^255 when q == 1
    return torch.stack(h, dim=-1).to(torch.int32)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(canonicalize(a) == canonicalize(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonicalize(a) == 0, dim=-1)


def is_negative(a: torch.Tensor) -> torch.Tensor:
    """'Negative' = canonical encoding is odd (RFC 9496 convention)."""
    return (canonicalize(a)[..., 0] & 1) == 1


def select(cond: torch.Tensor, t: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """cond: bool[...]; t/f: [..., NLIMBS]."""
    return torch.where(cond[..., None], t, f)


def cabs(a: torch.Tensor) -> torch.Tensor:
    return select(is_negative(a), neg(a), a)


def to_bytes(x: torch.Tensor) -> np.ndarray:
    """Canonical little-endian encodings [..., 32] uint8; packed on x's
    device so only the wire bytes cross to the host."""
    return to_bytes_tensor(x).cpu().numpy()


def to_bytes_tensor(x: torch.Tensor) -> torch.Tensor:
    """Canonical little-endian encodings, uint8 [..., 32] on x's device."""
    c = canonicalize(x).long()
    cols = []
    for j in range(32):
        bit = 8 * j
        lim = max(i for i in range(NLIMBS) if OFF[i] <= bit)
        off = bit - OFF[lim]
        v = c[..., lim] >> off
        if off + 8 > BITS[lim] and lim + 1 < NLIMBS:
            v = v | (c[..., lim + 1] << (BITS[lim] - off))
        cols.append(v & 0xFF)
    return torch.stack(cols, dim=-1).to(torch.uint8)


def from_bytes(b, device="cuda") -> torch.Tensor:
    """[..., 32] uint8 LE (top bit ignored) -> limbs [..., 10] on device."""
    if isinstance(b, torch.Tensor):
        b = b.cpu().numpy()
    b = np.array(b, dtype=np.uint8)
    b[..., 31] &= 0x7F
    return to_tensor(_limbs_from_le_bytes(b), resolve_device(device))


@functools.lru_cache(maxsize=None)
def _byte_maps(device: torch.device):
    """Limb i is bits OFF[i] .. OFF[i] + BITS[i] - 1 of the 256-bit value:
    five bytes from OFF[i] // 8 (past the end: byte 31 again, shifted out of
    the 40-bit window), then a right shift by OFF[i] % 8 and the limb's mask."""
    idx = np.array([[o // 8 + k for k in range(5)] for o in OFF])
    shift = np.where(idx < 32, 8 * np.arange(5)[None, :], 63)
    return (torch.as_tensor(np.minimum(idx, 31), device=device),
            torch.as_tensor(shift, device=device),
            torch.tensor([o % 8 for o in OFF], device=device),
            _limb_const(tuple(MASKS), device))


def from_bytes_tensor(b: torch.Tensor):
    """Byte values [..., 32] on any device -> (canonical, limbs [..., 10])
    without leaving it. ``canonical`` is true where the 256-bit value is
    below p (bit 255 clear included); the limbs ignore bit 255, as
    :func:`from_bytes` does."""
    idx, shift, r, masks = _byte_maps(b.device)
    v = b.long()
    window = ((v[..., idx] << shift) & 0xFFFFFFFFFF).sum(-1)
    limbs = ((window >> r) & masks).to(torch.int32)
    # value mod 2^255 >= p = 2^255 - 19: bytes 1..30 are 0xFF, byte 31 is
    # 0x7F and byte 0 is at least 0xED
    ge_p = ((v[..., 0] >= 0xED) & (v[..., 1:31] == 0xFF).all(-1)
            & ((v[..., 31] & 0x7F) == 0x7F))
    return ~ge_p & (v[..., 31] < 0x80), limbs


# ---------------------------------------------------------------------------
# sqrt_ratio (RFC 9496 §4.2), batched
# ---------------------------------------------------------------------------

SQRT_M1_LIMBS = from_int(ex.SQRT_M1)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    sqrt_m1 = to_tensor(SQRT_M1_LIMBS, u.device)
    v3 = mul(square(v), v)
    v7 = mul(square(v3), v)
    r = mul(mul(u, v3), pow_p58(mul(u, v7)))
    check = mul(v, square(r))
    neg_u = neg(u)
    correct_sign = eq(check, u)
    flipped_sign = eq(check, neg_u)
    flipped_sign_i = eq(check, mul(neg_u, sqrt_m1))
    r = select(flipped_sign | flipped_sign_i, mul(r, sqrt_m1), r)
    return correct_sign | flipped_sign, cabs(r)


def invsqrt(x: torch.Tensor):
    return sqrt_ratio_m1(ones(x.shape[:-1], x.device), x)
