"""Batched Edwards/ristretto255 point operations in PyTorch.

Extended twisted-Edwards coordinates (X, Y, Z, T) over the port's field
(:mod:`quisquis_tpu_torch.ops.field`): four int32 ``[..., 10]`` tensors.
Complete (unified) a=-1 formulas, no branches.

This module is the plain version of the CUDA point library
(``csrc/point25519.cuh``, and ``csrc/quad25519.cuh``'s four-thread
operations on cached addends) and of the two scalar-multiplication kernels
(``csrc/scalar_mul.cu``, ``csrc/base_mul.cu``): the same formulas, the same
``need_t`` elision, the same table schedules, so the kernels and these
functions agree limb for limb. :mod:`quisquis_tpu_torch.ops.cuda_point`
launches the kernels for CUDA tensors and calls these for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.metrics import span
from . import exact as ex
from . import field as fe


class ExtPoint(NamedTuple):
    """Batched extended Edwards point; each field is int32 [..., NLIMBS]."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor

    @property
    def shape(self):
        return self.x.shape[:-1]

    @property
    def device(self):
        return self.x.device


D_LIMBS = fe.from_int(ex.D)
D2_LIMBS = fe.from_int(ex.D2)


def identity(shape=(), device="cuda") -> ExtPoint:
    z, o = fe.zeros(shape, device), fe.ones(shape, device)
    return ExtPoint(z, o, o.clone(), z.clone())


def basepoint(shape=(), device="cuda") -> ExtPoint:
    return from_exact(ex.BASEPOINT, shape, device)


# ---------------------------------------------------------------------------
# host <-> tensor
# ---------------------------------------------------------------------------

def from_exact(p: ex.Point, shape=(), device="cuda") -> ExtPoint:
    return ExtPoint(*(fe.const(c, shape, device) for c in p))


def from_exact_batch(points, device="cuda") -> ExtPoint:
    dev = resolve_device(device)
    return ExtPoint(*(fe.to_tensor(fe.from_int_batch([p[i] for p in points]), dev)
                      for i in range(4)))


def to_exact_batch(p: ExtPoint):
    return list(zip(*(fe.to_int_batch(c) for c in p)))


# ---------------------------------------------------------------------------
# group law
# ---------------------------------------------------------------------------

def add(p: ExtPoint, q: ExtPoint, need_t: bool = True) -> ExtPoint:
    m, a, s = fe.mul, fe.add, fe.sub
    d2 = fe.to_tensor(D2_LIMBS, p.device)
    A = m(s(p.y, p.x), s(q.y, q.x))
    B = m(a(p.y, p.x), a(q.y, q.x))
    C = m(m(p.t, d2), q.t)
    Dv = fe.mul_small(m(p.z, q.z), 2)
    E = s(B, A)
    F = s(Dv, C)
    G = a(Dv, C)
    H = a(B, A)
    t = m(E, H) if need_t else p.t
    return ExtPoint(m(E, F), m(G, H), m(F, G), t)


def double(p: ExtPoint, need_t: bool = True) -> ExtPoint:
    m, a, s, sq = fe.mul, fe.add, fe.sub, fe.square
    A = sq(p.x)
    B = sq(p.y)
    C = fe.mul_small(sq(p.z), 2)
    H = a(A, B)
    E = s(H, sq(a(p.x, p.y)))
    G = s(A, B)
    F = a(C, G)
    t = m(E, H) if need_t else p.t  # T only needed when an addition follows
    return ExtPoint(m(E, F), m(G, H), m(F, G), t)


def add_niels(p: ExtPoint, yx: torch.Tensor, ymx: torch.Tensor,
              td2: torch.Tensor, need_t: bool = True) -> ExtPoint:
    """Mixed addition with an affine niels point (y+x, y-x, 2d*x*y), z2=1."""
    m, a, s = fe.mul, fe.add, fe.sub
    A = m(s(p.y, p.x), ymx)
    B = m(a(p.y, p.x), yx)
    C = m(p.t, td2)
    Dv = fe.mul_small(p.z, 2)
    E = s(B, A)
    F = s(Dv, C)
    G = a(Dv, C)
    H = a(B, A)
    t = m(E, H) if need_t else p.t
    return ExtPoint(m(E, F), m(G, H), m(F, G), t)


def neg(p: ExtPoint) -> ExtPoint:
    return ExtPoint(fe.neg(p.x), p.y, p.z, fe.neg(p.t))


def sub(p: ExtPoint, q: ExtPoint) -> ExtPoint:
    return add(p, neg(q))


def select(cond: torch.Tensor, p: ExtPoint, q: ExtPoint) -> ExtPoint:
    """cond: bool[...] broadcastable against the batch shape."""
    return ExtPoint(*(fe.select(cond, a, b) for a, b in zip(p, q)))


def eq(p: ExtPoint, q: ExtPoint) -> torch.Tensor:
    """Ristretto (coset-aware) equality: X1Y2==Y1X2 or X1X2==Y1Y2."""
    m = fe.mul
    return fe.eq(m(p.x, q.y), m(p.y, q.x)) | fe.eq(m(p.x, q.x), m(p.y, q.y))


def is_identity(p: ExtPoint) -> torch.Tensor:
    """Identity coset: X == 0 or Y == 0 (covers all 4-torsion reps)."""
    return fe.is_zero(p.x) | fe.is_zero(p.y)


# ---------------------------------------------------------------------------
# scalar multiplication (plain versions of the two kernels)
# ---------------------------------------------------------------------------

WINDOW_BITS = 4
NWINDOWS = 256 // WINDOW_BITS  # 64 nibbles cover 256 bits (top always < 2^253)


def scalar_to_nibbles(s_bytes: np.ndarray) -> np.ndarray:
    """[..., 32] uint8 LE scalar bytes -> [..., 64] int32 nibble digits."""
    b = np.asarray(s_bytes, dtype=np.uint8)
    lo = (b & 0x0F).astype(np.int32)
    hi = (b >> 4).astype(np.int32)
    return np.stack([lo, hi], axis=-1).reshape(b.shape[:-1] + (64,))


def scalars_to_nibbles(scalars) -> np.ndarray:
    """List of python ints mod l -> [n, 64] nibble digits."""
    buf = b"".join(ex.sc_to_bytes(s) for s in scalars)
    return scalar_to_nibbles(np.frombuffer(buf, dtype=np.uint8).reshape(-1, 32))


def _stack(points, dim: int) -> ExtPoint:
    return ExtPoint(*(torch.stack(cs, dim=dim) for cs in zip(*points)))


def window_table(p: ExtPoint) -> ExtPoint:
    """[B, 16, NL] coords of 0..15 * p: doublings for even entries, one
    addition of p's cached form for odd ones (msm_table's schedule and
    formulas: ``quad_double`` and ``quad_add``)."""
    c1 = to_cached(p)
    table = [identity(p.shape, p.device), p]
    for k in range(2, 16):
        table.append(double(table[k // 2]) if k % 2 == 0 else add_cached(table[k - 1], c1))
    return _stack(table, dim=1)


class CachedPoint(NamedTuple):
    """An addend kept as (Y-X, Y+X, Z, 2d T): the cached form of
    ``csrc/quad25519.cuh``, whose role r holds field r."""

    ymx: torch.Tensor
    ypx: torch.Tensor
    z: torch.Tensor
    t2d: torch.Tensor


def to_cached(p: ExtPoint) -> CachedPoint:
    return CachedPoint(fe.sub(p.y, p.x), fe.add(p.y, p.x), p.z,
                       fe.mul(p.t, fe.to_tensor(D2_LIMBS, p.device)))


def add_cached(p: ExtPoint, c: CachedPoint) -> ExtPoint:
    """p + c: :func:`add` with 2d T2 computed beforehand; the addition of
    the kernels' quads (``quad_add``)."""
    m, a, s = fe.mul, fe.add, fe.sub
    A = m(s(p.y, p.x), c.ymx)
    B = m(a(p.y, p.x), c.ypx)
    Dv = fe.mul_small(m(p.z, c.z), 2)
    C = m(p.t, c.t2d)
    E = s(B, A)
    F = s(Dv, C)
    G = a(Dv, C)
    H = a(B, A)
    return ExtPoint(m(E, F), m(G, H), m(F, G), m(E, H))


def horner16(shape, device, top: int, addend) -> ExtPoint:
    """From the identity, for w = top .. 0: four doublings (3 without T, 1
    with T; none before the first addition), then the cached addend(w)
    added (``quad_horner16``)."""
    acc = add_cached(identity(shape, device), addend(top))
    for w in range(top - 1, -1, -1):
        for k in range(WINDOW_BITS):
            acc = double(acc, need_t=(k == WINDOW_BITS - 1))
        acc = add_cached(acc, addend(w))
    return acc


SIGNED_DIGITS = NWINDOWS + 1


def signed_digits(nibbles: torch.Tensor) -> torch.Tensor:
    """nibbles int [..., 64] (0..15, little-endian) -> int32 [..., 65] in
    -8..8 with the same value sum 16^w e_w (``signed_radix16``: dalek's
    ``Scalar::as_radix_16`` with a 65th digit for a top nibble >= 8)."""
    carry = torch.zeros(nibbles.shape[:-1], dtype=torch.int32, device=nibbles.device)
    out = []
    for w in range(NWINDOWS):
        v = nibbles[..., w].int() + carry
        carry = (v + 8) >> 4
        out.append(v - (carry << 4))
    out.append(carry)
    return torch.stack(out, dim=-1)


def cached_table(p: ExtPoint) -> CachedPoint:
    """Fields [B, 9, NL] of the cached multiples 0..8 of p, entry 0 the
    identity's (1, 1, 1, 0); 2 = 2(1), 3 = 2+1, 4 = 2(2), 5 = 4+1,
    6 = 2(3), 7 = 6+1, 8 = 2(4) (``quad_table8``)."""
    c1 = to_cached(p)
    p2 = double(p)
    p3 = add_cached(p2, c1)
    p4 = double(p2)
    p6 = double(p3)
    multiples = [p2, p3, p4, add_cached(p4, c1), p6, add_cached(p6, c1), double(p4)]
    one = fe.ones(p.shape, p.device)
    ident = CachedPoint(one, one, one, fe.zeros(p.shape, p.device))
    entries = [ident, c1] + [to_cached(m) for m in multiples]
    return CachedPoint(*(torch.stack(cs, dim=1) for cs in zip(*entries)))


def select_cached(table: CachedPoint, digit: torch.Tensor) -> CachedPoint:
    """table fields [B, 9, NL], digit int [B] in -8..8 -> entry |digit|,
    negated where digit < 0 (Y-X and Y+X swapped, 2d T negated)."""
    idx = digit.abs().long()[:, None, None].expand(-1, 1, fe.NLIMBS)
    e = CachedPoint(*(torch.gather(c, 1, idx)[:, 0] for c in table))
    neg = digit < 0
    return CachedPoint(fe.select(neg, e.ypx, e.ymx), fe.select(neg, e.ymx, e.ypx), e.z,
                       fe.select(neg, fe.neg(e.t2d), e.t2d))


def scalar_mul(nibbles: torch.Tensor, p: ExtPoint) -> ExtPoint:
    """Variable-base s*P: nibbles [B, 64] little-endian, any values 0..15,
    P coords [B, NL]. The kernel's schedule (``csrc/scalar_mul.cu``): 65
    signed digits, the cached multiples 1..8, Horner's rule from the
    identity."""
    table = cached_table(p)
    digits = signed_digits(nibbles)
    return horner16(p.shape, p.device, SIGNED_DIGITS - 1,
                    lambda w: select_cached(table, digits[:, w]))


#: threads a lane of csrc/base_mul.cu: part t adds windows t, t + 4, ...
BASE_PARTS = 4
#: int32 of one fixed-base table entry: y+x, y-x, 2dxy and two of padding
BASE_ENTRY_INTS = 32


def niels_base_table_np() -> np.ndarray:
    """int32 [65, 8, 32]: entry k - 1 of window w is (16^w * k) * B for
    k = 1..8 in affine niels form, y+x, y-x, 2d*x*y in ints 0..29; ints 30
    and 31 are zero (an entry is eight 16-byte loads in the kernel)."""
    rows = []
    base = ex.BASEPOINT
    for _ in range(SIGNED_DIGITS):
        entry = base
        for _ in range(8):
            X, Y, Z, _t = entry
            zi = ex.fe_invert(Z)
            x, y = X * zi % ex.P, Y * zi % ex.P
            rows += [(y + x) % ex.P, (y - x) % ex.P, x * y % ex.P * ex.D2 % ex.P]
            entry = ex.pt_add(entry, base)
        for _ in range(WINDOW_BITS):
            base = ex.pt_double(base)
    table = fe.from_int_batch(rows).reshape(SIGNED_DIGITS, 8, 3 * fe.NLIMBS)
    pad = np.zeros((SIGNED_DIGITS, 8, BASE_ENTRY_INTS - 3 * fe.NLIMBS), dtype=table.dtype)
    return np.ascontiguousarray(np.concatenate([table, pad], axis=-1))


@functools.lru_cache(maxsize=None)
def _niels_np() -> np.ndarray:
    return niels_base_table_np()


@functools.lru_cache(maxsize=None)
def niels_base_table(device: torch.device) -> torch.Tensor:
    """The niels table on a device, built and uploaded once per process."""
    return fe.to_tensor(_niels_np(), device)


def select_niels(windows: torch.Tensor, digit: torch.Tensor):
    """windows int32 [a, 8, 32] (rows of the fixed-base table), digit int
    [B, a] in -8..8 -> (y+x, y-x, 2dxy), each [B, a, NL]: entry |digit| of
    each window, the identity (1, 1, 0) for 0, negated where digit < 0 (y+x
    and y-x swapped, 2dxy negated)."""
    mag = digit.abs().long()
    cols = torch.arange(windows.shape[0], device=digit.device)
    e = windows[cols, (mag - 1).clamp(min=0)]  # [B, a, 32]
    zero, neg = mag == 0, digit < 0
    one = fe.ones(digit.shape, digit.device)
    yx = fe.select(zero, one, e[..., :fe.NLIMBS])
    ymx = fe.select(zero, one, e[..., fe.NLIMBS:2 * fe.NLIMBS])
    td2 = fe.select(zero, fe.zeros(digit.shape, digit.device), e[..., 2 * fe.NLIMBS:3 * fe.NLIMBS])
    return fe.select(neg, ymx, yx), fe.select(neg, yx, ymx), fe.select(neg, fe.neg(td2), td2)


def base_mul(nibbles: torch.Tensor) -> ExtPoint:
    """Fixed-base s*B, nibbles [B, 64] little-endian, any values 0..15. The
    kernel's schedule (``csrc/base_mul.cu``): 65 signed digits; part t of
    BASE_PARTS adds windows t, t + BASE_PARTS, ... to the identity by niels
    mixed additions (no doublings); the parts are folded in a tree (part t
    takes part t + step, step = BASE_PARTS/2 .. 1) by additions of the
    cached form, the kernel's quad additions."""
    table = niels_base_table(nibbles.device)
    digits = signed_digits(nibbles)
    acc = identity((nibbles.shape[0], BASE_PARTS), nibbles.device)
    for w0 in range(0, SIGNED_DIGITS, BASE_PARTS):
        a = min(BASE_PARTS, SIGNED_DIGITS - w0)  # the parts that have window w0 + part
        head = add_niels(ExtPoint(*(c[:, :a] for c in acc)),
                         *select_niels(table[w0:w0 + a], digits[:, w0:w0 + a]))
        acc = ExtPoint(*(torch.cat([h, c[:, a:]], dim=1) for h, c in zip(head, acc)))
    step = BASE_PARTS // 2
    while step:
        acc = add_cached(ExtPoint(*(c[:, :step] for c in acc)),
                         to_cached(ExtPoint(*(c[:, step:2 * step] for c in acc))))
        step //= 2
    return ExtPoint(*(c[:, 0].contiguous() for c in acc))


# ---------------------------------------------------------------------------
# ristretto encode / decode (batched, RFC 9496 §4.3)
# ---------------------------------------------------------------------------

INVSQRT_A_MINUS_D_LIMBS = fe.from_int(ex.INVSQRT_A_MINUS_D)
SQRT_AD_MINUS_ONE_LIMBS = fe.from_int(ex.SQRT_AD_MINUS_ONE)
ONE_MINUS_D_SQ_LIMBS = fe.from_int(ex.ONE_MINUS_D_SQ)
D_MINUS_ONE_SQ_LIMBS = fe.from_int(ex.D_MINUS_ONE_SQ)


@span("ops.point.encode")
def compress(p: ExtPoint) -> torch.Tensor:
    """Ristretto encode -> canonical field element s as limbs [..., 10]."""
    m, a, s_ = fe.mul, fe.add, fe.sub
    dev = p.device
    x0, y0, z0, t0 = p
    u1 = m(a(z0, y0), s_(z0, y0))
    u2 = m(x0, y0)
    _, invsqrt = fe.invsqrt(m(u1, m(u2, u2)))
    den1 = m(invsqrt, u1)
    den2 = m(invsqrt, u2)
    z_inv = m(m(den1, den2), t0)
    sqrt_m1 = fe.to_tensor(fe.SQRT_M1_LIMBS, dev)
    ix0 = m(x0, sqrt_m1)
    iy0 = m(y0, sqrt_m1)
    ench = m(den1, fe.to_tensor(INVSQRT_A_MINUS_D_LIMBS, dev))
    rotate = fe.is_negative(m(t0, z_inv))
    x = fe.select(rotate, iy0, x0)
    y = fe.select(rotate, ix0, y0)
    den_inv = fe.select(rotate, ench, den2)
    y = fe.select(fe.is_negative(m(x, z_inv)), fe.neg(y), y)
    return fe.canonicalize(fe.cabs(m(den_inv, s_(z0, y))))


@span("ops.point.encode")
def compress_to_bytes(p: ExtPoint) -> np.ndarray:
    """[..., 32] uint8 wire encodings (only the bytes leave the device)."""
    return fe.to_bytes(compress(p))


@span("ops.point.encode")
def compress_to_bytes_tensor(p: ExtPoint) -> torch.Tensor:
    """[..., 32] uint8 wire encodings, left on the device."""
    return fe.to_bytes_tensor(compress(p))


def decompress(s: torch.Tensor):
    """Ristretto decode from canonical limbs [..., 10] -> (ok, point)."""
    m, a, s_ = fe.mul, fe.add, fe.sub
    one = fe.ones(s.shape[:-1], s.device)
    ss = m(s, s)
    u1 = s_(one, ss)
    u2 = a(one, ss)
    u2_sqr = m(u2, u2)
    d = fe.to_tensor(D_LIMBS, s.device)
    v = s_(fe.neg(m(d, m(u1, u1))), u2_sqr)
    was_square, invsqrt = fe.invsqrt(m(v, u2_sqr))
    den_x = m(invsqrt, u2)
    den_y = m(m(invsqrt, den_x), v)
    x = fe.cabs(m(fe.mul_small(s, 2), den_x))
    y = m(u1, den_y)
    t = m(x, y)
    ok = was_square & ~fe.is_negative(t) & ~fe.is_zero(y)
    ok = ok & ~fe.is_negative(s)
    return ok, ExtPoint(x, y, one, t)


@span("ops.point.decode")
def decompress_from_bytes(b, device="cuda"):
    """[..., 32] uint8 -> (ok, ExtPoint); rejects non-canonical encodings."""
    b = np.asarray(b, dtype=np.uint8)
    vals = [int.from_bytes(bytes(row), "little") for row in b.reshape(-1, 32)]
    ok_enc = np.array([v < ex.P for v in vals], dtype=bool).reshape(b.shape[:-1])
    ok, p = decompress(fe.from_bytes(b, device))
    return ok & torch.as_tensor(ok_enc, device=ok.device), p


@span("ops.point.decode")
def decompress_bytes_tensor(b: torch.Tensor):
    """Byte values [..., 32] already on a device -> (ok, ExtPoint) there:
    :func:`decompress_from_bytes` with the canonical-encoding check in
    tensor arithmetic, so nothing returns to the host."""
    ok_enc, s = fe.from_bytes_tensor(b)
    ok, p = decompress(s)
    return ok & ok_enc, p


# ---------------------------------------------------------------------------
# elligator one-way map (batched)
# ---------------------------------------------------------------------------

def map_to_point(t: torch.Tensor) -> ExtPoint:
    """ristretto255 one-way MAP on field limbs [..., 10]."""
    m, a, s_ = fe.mul, fe.add, fe.sub
    dev = t.device
    one = fe.ones(t.shape[:-1], dev)
    d = fe.to_tensor(D_LIMBS, dev)
    r = m(fe.to_tensor(fe.SQRT_M1_LIMBS, dev), m(t, t))
    u = m(a(r, one), fe.to_tensor(ONE_MINUS_D_SQ_LIMBS, dev))
    v = m(s_(fe.neg(one), m(r, d)), a(r, d))
    was_square, s = fe.sqrt_ratio_m1(u, v)
    s_prime = fe.neg(fe.cabs(m(s, t)))
    s = fe.select(was_square, s, s_prime)
    c = fe.select(was_square, fe.neg(one), r)
    n = s_(m(m(c, s_(r, one)), fe.to_tensor(D_MINUS_ONE_SQ_LIMBS, dev)), v)
    w0 = fe.mul_small(m(s, v), 2)
    w1 = m(n, fe.to_tensor(SQRT_AD_MINUS_ONE_LIMBS, dev))
    w2 = s_(one, m(s, s))
    w3 = a(one, m(s, s))
    return ExtPoint(m(w0, w3), m(w2, w1), m(w1, w3), m(w0, w2))


def from_uniform_bytes(b, device="cuda") -> ExtPoint:
    """[..., 64] uint8 -> point (sum of two elligator maps), batched."""
    b = np.asarray(b, dtype=np.uint8)
    return add(map_to_point(fe.from_bytes(b[..., :32], device)),
               map_to_point(fe.from_bytes(b[..., 32:], device)))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def sum_points(p: ExtPoint, axis: int = 0) -> ExtPoint:
    """Tree-reduce point addition along a batch axis (log2 depth)."""
    if axis < 0:
        axis = p.x.ndim - 1 + axis  # relative to batch dims
    n = p.x.shape[axis]
    while n > 1:
        if n % 2:
            pad = identity(p.x.narrow(axis, 0, 1).shape[:-1], p.device)
            p = ExtPoint(*(torch.cat([c, e], dim=axis) for c, e in zip(p, pad)))
            n += 1
        half = n // 2
        p = add(ExtPoint(*(c.narrow(axis, 0, half) for c in p)),
                ExtPoint(*(c.narrow(axis, half, half) for c in p)))
        n = half
    return ExtPoint(*(c.select(axis, 0) for c in p))
