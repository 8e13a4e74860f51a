"""Exact (host-side, arbitrary-precision) reference backend for Curve25519 / ristretto255.

This module is the framework's *bit-exactness anchor*: a from-scratch
implementation of the GF(2^255-19) field, the scalar field mod l, the twisted
Edwards curve -x^2 + y^2 = 1 + d x^2 y^2, and the ristretto255 group
(encode / decode / one-way map) following RFC 9496 and RFC 8032.

The PyTorch port's own copy of the JAX package's exact backend. Its point
functions dispatch to the C++ curve library of :mod:`.host_curve` once the
package has loaded and g++ has built it (``NATIVE_CURVE``); the
pure-Python functions stay as the plain versions (``*_py``) and where g++
is missing. Every CUDA kernel and torch function in
:mod:`quisquis_tpu_torch.ops.field` / :mod:`quisquis_tpu_torch.ops.point`
is tested against it at canonical values.

No code is ported from the Rust reference; the math follows the public RFCs.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Field GF(2^255 - 19)
# ---------------------------------------------------------------------------

P = 2**255 - 19

#: Edwards d = -121665/121666 mod p
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P


def _sqrt_m1() -> int:
    r = pow(2, (P - 1) // 4, P)
    # pick the "nonnegative" (even) square root of -1, per RFC 9496
    return r if r % 2 == 0 else P - r


SQRT_M1 = _sqrt_m1()

# ristretto255 constants (RFC 9496 §4.1), derived — not hard-coded
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = ((D - 1) * (D - 1)) % P


def fe_is_negative(x: int) -> bool:
    """A field element is 'negative' iff its canonical LE encoding has bit 0 set."""
    return (x % P) & 1 == 1


def fe_abs(x: int) -> int:
    x %= P
    return P - x if fe_is_negative(x) else x


def fe_invert(x: int) -> int:
    return pow(x, P - 2, P)


def fe_from_bytes(b: bytes) -> int:
    """Load 32 LE bytes, ignore the top bit (255-bit mask), reduce mod p."""
    assert len(b) == 32
    return (int.from_bytes(b, "little") & ((1 << 255) - 1)) % P


def fe_to_bytes(x: int) -> bytes:
    return (x % P).to_bytes(32, "little")


def sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """(was_square, r) with r = sqrt(u/v) or sqrt(SQRT_M1 * u/v); RFC 9496 §4.2."""
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = (u * v3 % P) * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct_sign = check == u
    flipped_sign = check == (P - u) % P
    flipped_sign_i = check == (P - u) * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    r = fe_abs(r)
    return (correct_sign or flipped_sign), r


def fe_invsqrt(x: int) -> Tuple[bool, int]:
    return sqrt_ratio_m1(1, x)


# sqrt(a*d - 1) = sqrt(-d-1); dalek's constant is the *negative* (odd) root,
# pinned by the B_blinding golden vector (tests/test_exact_backend.py).
SQRT_AD_MINUS_ONE = P - sqrt_ratio_m1(1, fe_invert((P - D - 1) % P))[1]
INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (P - 1 - D) % P)[1]  # 1/sqrt(-1-d)

# ---------------------------------------------------------------------------
# Scalar field mod l (l = group order of ristretto255)
# ---------------------------------------------------------------------------

L = 2**252 + 27742317777372353535851937790883648493


def sc_from_bytes_mod_order(b: bytes) -> int:
    assert len(b) == 32
    return int.from_bytes(b, "little") % L


def sc_from_bytes_mod_order_wide(b: bytes) -> int:
    assert len(b) == 64
    return int.from_bytes(b, "little") % L


def sc_to_bytes(s: int) -> bytes:
    return (s % L).to_bytes(32, "little")


def sc_invert(s: int) -> int:
    return pow(s, L - 2, L)


def sc_is_canonical(b: bytes) -> bool:
    return int.from_bytes(b, "little") < L


def sc_batch_invert(xs):
    """Montgomery batch inversion over the scalar field."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % L
    inv = sc_invert(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % L
        inv = inv * xs[i] % L
    return out


# ---------------------------------------------------------------------------
# Edwards points (extended coordinates X, Y, Z, T with x=X/Z, y=Y/Z, T=XY/Z)
# ---------------------------------------------------------------------------

Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)

# Standard Ed25519 basepoint: y = 4/5, x recovered with even sign.
_BY = 4 * pow(5, P - 2, P) % P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASEPOINT: Point = (_BX, _BY, 1, _BX * _BY % P)


def pt_add(p: Point, q: Point) -> Point:
    """Unified addition on -x^2+y^2 = 1+d x^2 y^2 (complete, a=-1 formulas)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * D2 % P * T2 % P
    Dv = 2 * Z1 * Z2 % P
    E = (B - A) % P
    F = (Dv - C) % P
    G = (Dv + C) % P
    H = (B + A) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_double(p: Point) -> Point:
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = (A + B) % P
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = (A - B) % P
    F = (C + G) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_neg(p: Point) -> Point:
    X, Y, Z, T = p
    return ((P - X) % P, Y, Z, (P - T) % P)


def pt_sub(p: Point, q: Point) -> Point:
    return pt_add(p, pt_neg(q))


def pt_mul(s: int, p: Point) -> Point:
    """Scalar multiplication (left-to-right binary)."""
    return pt_mul_int(s % L, p)


def pt_mul_int(s: int, p: Point) -> Point:
    """s*P for a nonnegative integer s, not reduced mod l: the same point
    as :func:`pt_mul` in the prime-order subgroup, and the right one for
    points with a torsion component."""
    acc = IDENTITY
    for bit in bin(s)[2:] if s else "":
        acc = pt_double(acc)
        if bit == "1":
            acc = pt_add(acc, p)
    return acc


def eight_torsion() -> Point:
    """A point of order 8: l times the curve point with y = 3, which lies
    outside the prime-order subgroup."""
    y = 3
    u = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    x = pow(u, (P + 3) // 8, P)
    if x * x % P != u:
        x = x * SQRT_M1 % P
    return pt_mul_int(L, (x, y, 1, x * y % P))


def pt_base_mul(s: int) -> Point:
    return pt_mul(s, BASEPOINT)


def pt_mul_batch(scalars, points):
    """out[i] = s_i * P_i."""
    return [pt_mul(s, p) for s, p in zip(scalars, points)]


def pt_fold_batch(a_scalars, b_scalars, ps, qs):
    """out[i] = a_i*P_i + b_i*Q_i — the IPP generator-fold / Strauss shape."""
    return [pt_add(pt_mul(a, p), pt_mul(b, q))
            for a, p, b, q in zip(a_scalars, ps, b_scalars, qs)]


def pt_msm_many(items):
    """Independent MSMs: items = [(scalars, points), ...] -> [Point, ...]."""
    return [pt_msm(s, p) for s, p in items]


def pt_msm(scalars, points) -> Point:
    """Multi-scalar multiplication (Pippenger bucket method for larger sets)."""
    scalars = [s % L for s in scalars]
    n = len(scalars)
    if n == 0:
        return IDENTITY
    if n < 16:
        acc = IDENTITY
        for s, p in zip(scalars, points):
            acc = pt_add(acc, pt_mul(s, p))
        return acc
    c = 6 if n < 500 else 8
    nbuckets = 1 << c
    windows = -(-253 // c)
    result = IDENTITY
    for w in range(windows - 1, -1, -1):
        if w != windows - 1:
            for _ in range(c):
                result = pt_double(result)
        buckets = [None] * nbuckets
        shift = w * c
        for s, p in zip(scalars, points):
            digit = (s >> shift) & (nbuckets - 1)
            if digit:
                buckets[digit] = p if buckets[digit] is None else pt_add(buckets[digit], p)
        running = None
        acc = None
        for b in reversed(buckets[1:]):
            if b is not None:
                running = b if running is None else pt_add(running, b)
            if running is not None:
                acc = running if acc is None else pt_add(acc, running)
        if acc is not None:
            result = pt_add(result, acc)
    return result


def pt_same(p: Point, q: Point) -> bool:
    """The same curve point (projective equality), not only the same
    ristretto element."""
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def pt_eq(p: Point, q: Point) -> bool:
    """Ristretto equality (coset-aware): X1Y2==Y1X2 or X1X2==Y1Y2."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    return (X1 * Y2 - Y1 * X2) % P == 0 or (X1 * X2 - Y1 * Y2) % P == 0


# ---------------------------------------------------------------------------
# ristretto255 encode / decode (RFC 9496 §4.3)
# ---------------------------------------------------------------------------


def ristretto_encode(p: Point) -> bytes:
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = fe_invsqrt(u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    ix0 = x0 * SQRT_M1 % P
    iy0 = y0 * SQRT_M1 % P
    enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
    rotate = fe_is_negative(t0 * z_inv % P)
    if rotate:
        x, y, den_inv = iy0, ix0, enchanted_denominator
    else:
        x, y, den_inv = x0, y0, den2
    if fe_is_negative(x * z_inv % P):
        y = (P - y) % P
    s = fe_abs(den_inv * ((z0 - y) % P) % P)
    return fe_to_bytes(s)


def ristretto_encode_batch(points) -> list:
    return [ristretto_encode(p) for p in points]


def ristretto_decode_batch(blobs) -> Optional[list]:
    """Decode many 32-byte encodings; None if ANY is invalid."""
    out = []
    for b in blobs:
        p = ristretto_decode(b)
        if p is None:
            return None
        out.append(p)
    return out


def ristretto_decode(b: bytes) -> Optional[Point]:
    if len(b) != 32:
        return None
    s_int = int.from_bytes(b, "little")
    if s_int >= P:  # non-canonical
        return None
    s = s_int
    if fe_is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = ((P - D) * u1 % P * u1 + (P - 1) * u2_sqr) % P  # -(d*u1^2) - u2^2
    was_square, invsqrt = fe_invsqrt(v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = fe_abs(2 * s * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or fe_is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def ristretto_map(t: int) -> Point:
    """One-way map (Elligator 2 for ristretto255), RFC 9496 §4.3.4."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = ((P - 1) - r * D) % P * ((r + D) % P) % P
    was_square, s = sqrt_ratio_m1(u, v)
    s_prime = (P - fe_abs(s * t % P)) % P
    if not was_square:
        s = s_prime
        c = r
    else:
        c = P - 1
    n = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def ristretto_from_uniform_bytes(b: bytes) -> Point:
    assert len(b) == 64
    p1 = ristretto_map(fe_from_bytes(b[:32]))
    p2 = ristretto_map(fe_from_bytes(b[32:]))
    return pt_add(p1, p2)


def hash_to_point_sha3_512(data: bytes) -> Point:
    """RistrettoPoint::hash_from_bytes::<Sha3_512> equivalent."""
    return ristretto_from_uniform_bytes(hashlib.sha3_512(data).digest())


def hash_to_point_sha512(data: bytes) -> Point:
    """RistrettoPoint::hash_from_bytes::<Sha512> equivalent."""
    return ristretto_from_uniform_bytes(hashlib.sha512(data).digest())


def sc_hash_from_bytes_sha512(data: bytes) -> int:
    """Scalar::hash_from_bytes::<Sha512> equivalent (hash-to-scalar)."""
    return sc_from_bytes_mod_order_wide(hashlib.sha512(data).digest())


# ---------------------------------------------------------------------------
# Ed25519-style encoding (for cross-validation against RFC 8032 only)
# ---------------------------------------------------------------------------


def ed25519_encode(p: Point) -> bytes:
    X, Y, Z, _ = p
    zi = fe_invert(Z)
    x = X * zi % P
    y = Y * zi % P
    b = bytearray(fe_to_bytes(y))
    if x & 1:
        b[31] |= 0x80
    return bytes(b)


# ---------------------------------------------------------------------------
# native dispatch (the C++ curve library of host_curve.py)
# ---------------------------------------------------------------------------

#: pure-Python versions kept as the plain versions (tests) and fallback
pt_add_py = pt_add
pt_double_py = pt_double
pt_mul_py = pt_mul
pt_base_mul_py = pt_base_mul
pt_msm_py = pt_msm
pt_msm_many_py = pt_msm_many
pt_mul_batch_py = pt_mul_batch
pt_fold_batch_py = pt_fold_batch
ristretto_encode_py = ristretto_encode
ristretto_decode_py = ristretto_decode
ristretto_encode_batch_py = ristretto_encode_batch
ristretto_decode_batch_py = ristretto_decode_batch

NATIVE_CURVE = False


def _try_enable_native() -> None:
    """Point this module's point functions at the C++ curve library, where
    it builds and loads; otherwise leave them pure Python."""
    global pt_add, pt_double, pt_mul, pt_base_mul, pt_msm
    global pt_mul_batch, pt_fold_batch, pt_msm_many
    global ristretto_encode, ristretto_decode, NATIVE_CURVE
    global ristretto_encode_batch, ristretto_decode_batch
    import sys

    from . import host_curve as nc

    if not nc.init_constants(sys.modules[__name__]):
        return

    def _pt_mul(s, p):
        return nc.pt_mul(s, p, L)

    def _pt_msm(scalars, points):
        return nc.pt_msm(list(scalars), list(points), L)

    def _pt_base_mul(s):
        return nc.pt_base_mul(s, L)

    def _pt_mul_batch(scalars, points):
        return nc.pt_mul_batch(list(scalars), list(points), L)

    def _pt_fold_batch(a_scalars, b_scalars, ps, qs):
        return nc.fold_batch(list(a_scalars), list(b_scalars),
                             list(ps), list(qs), L)

    def _pt_msm_many(items):
        return nc.pt_msm_many([(list(s), list(p)) for s, p in items], L)

    pt_add = nc.pt_add
    pt_double = nc.pt_double
    pt_mul = _pt_mul
    pt_base_mul = _pt_base_mul
    pt_msm = _pt_msm
    pt_mul_batch = _pt_mul_batch
    pt_fold_batch = _pt_fold_batch
    pt_msm_many = _pt_msm_many
    ristretto_encode = nc.ristretto_encode
    ristretto_decode = nc.ristretto_decode
    ristretto_encode_batch = nc.ristretto_encode_batch
    ristretto_decode_batch = nc.ristretto_decode_batch
    NATIVE_CURVE = True


# called from the package's __init__ once the package has loaded
