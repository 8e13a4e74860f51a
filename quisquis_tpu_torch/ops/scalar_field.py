"""Batched scalar-field (mod l) arithmetic in PyTorch.

l = 2^252 + 27742317777372353535851937790883648493 is the ristretto255 group
order. The range verifier needs challenge arithmetic (products, powers,
Fermat inversion) on the device between the transcript and the MSM; the
host equivalents are ``sc_*`` in :mod:`quisquis_tpu_torch.ops.exact`.

Representation (a layout for int64 tensors, not the JAX package's int32 one)
---------------------------------------------------------------------------
A scalar is an int64 tensor ``[..., 10]``: limb ``i`` has weight ``2^(28 i)``
(280 bits of capacity). Limb 9 starts at bit 252, where ``2^252 = l - delta``
with ``delta`` the 125-bit tail of l, so the top limb folds down as
``t * 2^252 = -t * delta (mod l)``.

* **Loose contract**: every operation takes and returns limbs in
  ``[0, LOOSE]``, ``LOOSE = 2^29 + 2^16``, whose value is congruent mod l to
  the result; it need not be below l. Exact digits of the value in ``[0, l)``
  are made only at the boundaries (:func:`canonicalize`, :func:`eq`,
  :func:`to_bytes_array`, :func:`to_nibbles`).
* **Products** are schoolbook columns (19 of them, each at most
  ``10 * LOOSE^2 < 2^61.4``) followed by carry passes and *fold* steps that
  contract the limbs from 10 up through the constant matrix
  ``CMAT[h, j] = digit_j(2^(28 (10 + h)) mod l)``: a broadcast multiply and a
  sum, because integer matrix products have no CUDA kernel in torch.
* **Bounds**: :func:`_schedule` picks the passes from exact integer interval
  arithmetic and asserts that no intermediate passes ``2^63 - 1``; the
  schedules of mul, add, sub, the byte readers and a sum of 4,096 terms are
  computed at import, so a bound that does not close fails the import.

Compared with the JAX package at canonical ints mod l only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import exact as ex

BITS = 28
NLIMBS = 10
MASK = (1 << BITS) - 1
#: per-limb inclusive bound of the loose contract
LOOSE = (1 << (BITS + 1)) + (1 << 16)
L = ex.L
INT64_MAX = 2**63 - 1
#: limb 9 starts at bit 252 = l's top bit
TOP = NLIMBS - 1
assert BITS * TOP == 252 and BITS % 4 == 0

DELTA = L - (1 << 252)
_TD_NLIMBS = (DELTA.bit_length() + BITS - 1) // BITS  # 5


def _digits(v: int, n: int = NLIMBS) -> list:
    assert 0 <= v < 1 << (BITS * n)
    return [(v >> (BITS * i)) & MASK for i in range(n)]


# ---------------------------------------------------------------------------
# host <-> tensor
# ---------------------------------------------------------------------------

def from_int_batch(xs) -> np.ndarray:
    """Python ints -> canonical int64 limbs [n, 10] (numpy)."""
    return np.array([_digits(int(x) % L) for x in xs], dtype=np.int64).reshape(-1, NLIMBS)


def from_int(x: int) -> np.ndarray:
    return from_int_batch([x])[0]


def to_int_batch(limbs) -> list:
    """Limbs [..., 10] (tensor or array, loose allowed) -> flat list of ints mod l."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    flat = np.asarray(limbs, dtype=np.int64).reshape(-1, NLIMBS)
    return [sum(int(v) << (BITS * i) for i, v in enumerate(row)) % L for row in flat]


def to_int(limbs) -> int:
    return to_int_batch(limbs)[0]


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def zeros(shape=(), device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (NLIMBS,), dtype=torch.int64,
                       device=resolve_device(device))


def const(x: int, shape=(), device="cuda") -> torch.Tensor:
    c = _const(tuple(_digits(x % L)), resolve_device(device))
    return c.expand(tuple(shape) + (NLIMBS,)).contiguous()


def one(shape=(), device="cuda") -> torch.Tensor:
    return const(1, shape, device)


def scalars_to_dev(xs, device="cuda") -> torch.Tensor:
    """Python ints -> canonical limbs [n, 10] on the device."""
    return torch.as_tensor(from_int_batch(xs), device=resolve_device(device))


def dev_to_scalars(x: torch.Tensor) -> list:
    """Loose limbs -> python ints mod l (a host fetch)."""
    return to_int_batch(x)


# ---------------------------------------------------------------------------
# certified carry/fold reduction
# ---------------------------------------------------------------------------

_CMAT_ROWS = NLIMBS + 4
_CMAT_INT = [_digits(pow(2, BITS * (NLIMBS + h), L)) for h in range(_CMAT_ROWS)]


def _carry_bounds(bounds):
    w = len(bounds)
    return tuple((min(bounds[k], MASK) if k < w else 0)
                 + ((bounds[k - 1] >> BITS) if k else 0) for k in range(w + 1))


def _fold_bounds(bounds):
    """Bounds after contracting limbs >= 10 through CMAT, or None if a
    column could pass 2^63 - 1."""
    rows = len(bounds) - NLIMBS
    if not 0 < rows <= _CMAT_ROWS:
        return None
    out = tuple(bounds[j] + sum(bounds[NLIMBS + h] * _CMAT_INT[h][j] for h in range(rows))
                for j in range(NLIMBS))
    return out if max(out) <= INT64_MAX else None


@functools.lru_cache(maxsize=None)
def _schedule(bounds: tuple) -> tuple:
    """The passes ("carry" or "fold") that take nonnegative limbs within
    ``bounds`` to 10 limbs within LOOSE, chosen greedily from exact interval
    arithmetic; every intermediate bound is asserted to fit int64."""
    assert max(bounds) <= INT64_MAX, bounds
    steps = []
    for _ in range(64):
        while len(bounds) > NLIMBS and bounds[-1] == 0:
            bounds = bounds[:-1]
            steps.append("trim")
        if len(bounds) <= NLIMBS and all(b <= LOOSE for b in bounds):
            return tuple(steps)
        folded = _fold_bounds(bounds)
        if folded is not None:
            steps.append("fold")
            bounds = folded
        else:
            steps.append("carry")
            bounds = _carry_bounds(bounds)
        assert max(bounds) <= INT64_MAX, bounds
    raise AssertionError(f"scalar reduction did not converge: bounds={bounds}")


def _reduce(x: torch.Tensor, bounds: tuple) -> torch.Tensor:
    """Nonnegative int64 limbs [..., len(bounds)] -> loose limbs [..., 10]."""
    for step in _schedule(tuple(bounds)):
        if step == "trim":
            x = x[..., :-1]
        elif step == "carry":
            x = F.pad(x & MASK, (0, 1)) + F.pad(x >> BITS, (1, 0))
        else:
            rows = x.shape[-1] - NLIMBS
            cmat = _const(tuple(map(tuple, _CMAT_INT[:rows])), x.device)
            x = x[..., :NLIMBS] + (x[..., NLIMBS:, None] * cmat).sum(-2)
    if x.shape[-1] < NLIMBS:
        x = F.pad(x, (0, NLIMBS - x.shape[-1]))
    return x


# ---------------------------------------------------------------------------
# ring operations on loose limbs
# ---------------------------------------------------------------------------

_W = 2 * NLIMBS - 1  # 19 product columns
_SCHOOL_BOUNDS = tuple(min(k + 1, NLIMBS, _W - k) * LOOSE * LOOSE for k in range(_W))


@functools.lru_cache(maxsize=None)
def _school_index(device: torch.device):
    """Column k sums prod[i, k - i]: (row index, column index, validity),
    each [19, 10]."""
    k = torch.arange(_W, device=device)[:, None]
    i = torch.arange(NLIMBS, device=device)[None, :].expand(_W, NLIMBS)
    j = k - i
    valid = (j >= 0) & (j < NLIMBS)
    return i, j.clamp(0, NLIMBS - 1), valid.long()


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    i, j, valid = _school_index(a.device)
    prod = a[..., :, None] * b[..., None, :]
    return _reduce((prod[..., i, j] * valid).sum(-1), _SCHOOL_BOUNDS)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(a + b, (2 * LOOSE,) * NLIMBS)


def sum_over(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over one batch dimension (not the limb axis)."""
    return _reduce(x.sum(dim), (x.shape[dim] * LOOSE,) * NLIMBS)


def _neg_bias() -> tuple:
    """Digits of a multiple of l (11 limbs), rebalanced so that limbs 0..9
    are at least LOOSE: a - b + bias has no negative limb."""
    v = (1 << 32) * L
    digits = _digits(v, NLIMBS + 1)
    for i in range(NLIMBS):
        if digits[i] < LOOSE:
            k = -(-(LOOSE - digits[i]) // (1 << BITS))
            digits[i] += k << BITS
            digits[i + 1] -= k
    assert all(d >= LOOSE for d in digits[:NLIMBS]) and digits[NLIMBS] >= 0, digits
    assert sum(d << (BITS * i) for i, d in enumerate(digits)) == v
    return tuple(digits)


_NEG_BIAS = _neg_bias()
_NEG_BOUNDS = tuple(d + LOOSE for d in _NEG_BIAS[:NLIMBS]) + (_NEG_BIAS[NLIMBS],)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(F.pad(a - b, (0, 1)) + _const(_NEG_BIAS, a.device), _NEG_BOUNDS)


def neg(b: torch.Tensor) -> torch.Tensor:
    return _reduce(_const(_NEG_BIAS, b.device) - F.pad(b, (0, 1)), _NEG_BOUNDS)


# ---------------------------------------------------------------------------
# canonicalization: exact digits of the value in [0, l)
# ---------------------------------------------------------------------------

def _exact_carry(x: torch.Tensor):
    """Sequential carry over signed limbs: (digits in [0, 2^28), carry out)."""
    out, carry = [], torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        v = x[..., i] + carry
        out.append(v & MASK)
        carry = v >> BITS  # arithmetic: floors, so negative limbs borrow
    return torch.stack(out, dim=-1), carry


def _lex_ge(x: torch.Tensor, c: tuple) -> torch.Tensor:
    """x (exact digits) >= the constant digits c. The sign of
    sum_i sign(x_i - c_i) 2^i is the sign of the most significant limb that
    differs."""
    weights = _const(tuple(1 << i for i in range(NLIMBS)), x.device)
    return (torch.sign(x - _const(c, x.device)) * weights).sum(-1) >= 0


_TD_LIMBS = tuple(_digits(DELTA, _TD_NLIMBS))
_L_DIGITS = tuple(_digits(L))
_2L_DIGITS = tuple(_digits(2 * L))
#: the most that bits 252 and up of a loose value can hold
_TOP_MAX = sum(LOOSE << (BITS * i) for i in range(NLIMBS)) >> (BITS * TOP)


def _top_bias() -> tuple:
    """Digits of 2l, rebalanced so that limbs 0..4 dominate _TOP_MAX * delta's
    and no limb is negative: the value stays 2l."""
    digits = _digits(2 * L)
    for i in range(NLIMBS - 1):
        lim = _TOP_MAX * _TD_LIMBS[i] if i < _TD_NLIMBS else 0
        if digits[i] < lim:
            k = -(-(lim - digits[i]) // (1 << BITS))
            digits[i] += k << BITS
            digits[i + 1] -= k
    assert all(d >= 0 for d in digits), digits
    assert all(_TOP_MAX * _TD_LIMBS[i] <= digits[i] for i in range(_TD_NLIMBS))
    assert max(digits) + MASK <= INT64_MAX
    assert sum(d << (BITS * i) for i, d in enumerate(digits)) == 2 * L
    return tuple(digits)


_TOP_BIAS = _top_bias()
assert _TOP_MAX * DELTA < 2 * L  # so 2l - t * delta is positive for every top part t


def canonicalize(x: torch.Tensor) -> torch.Tensor:
    """Loose limbs [..., 10] -> the exact digits of value mod l."""
    dev = x.device
    # 1. exact carry. The top part t, limb 9 and the carry out of it, holds
    #    bits 252 and up, and 2^252 = -delta (mod l).
    digits, carry = _exact_carry(x)
    top = digits[..., TOP] + (carry << BITS)
    # 2. add 2l - t * delta to the low 252 bits, with no negative limb; the
    #    value is now below 2^252 + 2l < 3l
    low = torch.cat([digits[..., :TOP], torch.zeros_like(digits[..., :1])], dim=-1)
    fold = F.pad(top[..., None] * _const(_TD_LIMBS, dev), (0, NLIMBS - _TD_NLIMBS))
    digits, _ = _exact_carry(low + _const(_TOP_BIAS, dev) - fold)
    # 3. subtract l once for each of l, 2l that the value reaches
    k = _lex_ge(digits, _L_DIGITS).long() + _lex_ge(digits, _2L_DIGITS).long()
    digits, _ = _exact_carry(digits - k[..., None] * _const(_L_DIGITS, dev))
    return digits


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(canonicalize(a) == canonicalize(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonicalize(a) == 0, dim=-1)


# ---------------------------------------------------------------------------
# byte I/O on the device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _split_maps(nlimbs: int, nbytes: int, device: torch.device):
    """Limb i is bits 28 i .. 28 i + 27: four bytes from 28 i // 8, shifted
    right by 28 i % 8 (0 or 4). Bytes past the end read as 0."""
    q = np.array([BITS * i // 8 for i in range(nlimbs)])
    idx = q[:, None] + np.arange(4)[None, :]
    inside = idx < nbytes
    shift = 8 * np.arange(4)[None, :] * np.ones_like(idx)
    return (torch.as_tensor(np.minimum(idx, nbytes - 1), device=device),
            torch.as_tensor(np.where(inside, shift, 63), device=device),
            torch.as_tensor(np.array([BITS * i % 8 for i in range(nlimbs)]), device=device))


def _limbs_from_bytes(b: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """[..., k] byte values (any integer dtype) -> [..., nlimbs] 28-bit limbs."""
    idx, shift, r = _split_maps(nlimbs, b.shape[-1], b.device)
    # a byte shifted by 63 contributes nothing below bit 32
    window = ((b.long()[..., idx] << shift) & 0xFFFFFFFF).sum(-1)
    return (window >> r) & MASK


_WIDE_LIMBS = (512 + BITS - 1) // BITS  # 19


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] little-endian byte values -> loose limbs of the value."""
    return _reduce(_limbs_from_bytes(b, NLIMBS), (MASK,) * NLIMBS)


def from_bytes_wide(b: torch.Tensor) -> torch.Tensor:
    """[..., 64] little-endian byte values -> loose limbs of value mod l (the
    shape of a challenge: Scalar::from_bytes_mod_order_wide)."""
    return _reduce(_limbs_from_bytes(b, _WIDE_LIMBS), (MASK,) * _WIDE_LIMBS)


@functools.lru_cache(maxsize=None)
def _pack_maps(width: int, count: int, device: torch.device):
    """Piece j is bits width j .. width (j + 1) - 1 of the digits."""
    lim = np.array([width * j // BITS for j in range(count)])
    off = np.array([width * j % BITS for j in range(count)])
    spill = (off + width > BITS) & (lim + 1 < NLIMBS)
    return (torch.as_tensor(lim, device=device), torch.as_tensor(off, device=device),
            torch.as_tensor(np.minimum(lim + 1, NLIMBS - 1), device=device),
            torch.as_tensor(np.where(spill, BITS - off, 63), device=device))


def _pack(digits: torch.Tensor, width: int, count: int) -> torch.Tensor:
    lim, off, lim1, up = _pack_maps(width, count, digits.device)
    v = (digits[..., lim] >> off) | ((digits[..., lim1] << up) & MASK)
    return v & ((1 << width) - 1)


def to_bytes_array(x: torch.Tensor) -> torch.Tensor:
    """Loose limbs -> uint8 [..., 32]: the canonical value, little-endian."""
    return _pack(canonicalize(x), 8, 32).to(torch.uint8)


def to_nibbles(x: torch.Tensor) -> torch.Tensor:
    """Loose limbs -> int32 [..., 64]: the canonical value's 4-bit MSM digits."""
    return _pack(canonicalize(x), 4, 64).to(torch.int32)


# ---------------------------------------------------------------------------
# higher operations
# ---------------------------------------------------------------------------

def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e mod l for a constant exponent e >= 0, by square and multiply."""
    if e == 0:
        return one(a.shape[:-1], a.device)
    acc = a
    for bit in bin(e)[3:]:
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


def invert(a: torch.Tensor) -> torch.Tensor:
    """a^(l-2) mod l (maps 0 to 0)."""
    return pow_const(a, L - 2)


def batch_invert_rows(a: torch.Tensor) -> torch.Tensor:
    """Montgomery's trick along the second-to-last axis: [..., n, 10] (all
    nonzero) -> the inverses, with one inversion and 3 (n - 1) products."""
    n = a.shape[-2]
    prefix = [a[..., 0, :]]
    for i in range(1, n):
        prefix.append(mul(prefix[-1], a[..., i, :]))
    inv_all = invert(prefix[-1])
    out = [None] * n
    for i in range(n - 1, 0, -1):
        out[i] = mul(inv_all, prefix[i - 1])
        inv_all = mul(inv_all, a[..., i, :])
    out[0] = inv_all
    return torch.stack(out, dim=-2)


def powers(x: torch.Tensor, n: int) -> torch.Tensor:
    """[..., 10] -> [..., n, 10]: 1, x, ..., x^(n-1), doubling the run of
    known powers at each step."""
    cur = torch.stack([one(x.shape[:-1], x.device), x], dim=-2)
    step = mul(x, x)
    while cur.shape[-2] < n:
        cur = torch.cat([cur, mul(cur, step[..., None, :])], dim=-2)
        step = mul(step, step)
    return cur[..., :n, :]


# every schedule the module uses closes within int64 (computed once, here)
for _bounds in (_SCHOOL_BOUNDS, (2 * LOOSE,) * NLIMBS, _NEG_BOUNDS, (MASK,) * NLIMBS,
                (MASK,) * _WIDE_LIMBS, (4096 * LOOSE,) * NLIMBS):
    _schedule(_bounds)
