// ristretto255 encode and decode (RFC 9496 §4.3), one point per thread.
//
// The plain PyTorch versions are compress, decompress and
// decompress_bytes_tensor in quisquis_tpu_torch/ops/point.py, with
// sqrt_ratio_m1, pow_p58, canonicalize, is_negative, cabs, to_bytes_tensor
// and from_bytes_tensor in quisquis_tpu_torch/ops/field.py. Every function
// below issues the same field operations in the same order on the same
// limbs (a square where the plain version multiplies an element by itself:
// fe_sq forms the same columns as fe_mul(a, a)), so decoded points agree
// limb for limb, rejected encodings included, and encodings byte for byte.
//
// The constants are compile-time limbs (the canonical limbs of
// ops/exact.py's D, SQRT_M1 and INVSQRT_A_MINUS_D), not uploads.
//
// Builds as CUDA (nvcc) and as plain C++ (g++), like field25519.cuh.
#pragma once

#include "point25519.cuh"

namespace qq {

// d = -121665/121666
QQ_HD fe fe_d() {
  return fe{{56195235, 13857412, 51736253, 6949390, 114729,
             24766616, 60832955, 30306712, 48412415, 21499315}};
}

// sqrt(-1)
QQ_HD fe fe_sqrt_m1() {
  return fe{{34513072, 25610706, 9377949, 3500415, 12389472,
             33281959, 41962654, 31548777, 326685, 11406482}};
}

// 1/sqrt(a - d), a = -1
QQ_HD fe fe_invsqrt_a_minus_d() {
  return fe{{6111466, 4156064, 39310137, 12243467, 41204824,
             120896, 20826367, 26493656, 6093567, 31568420}};
}

// z^((p-5)/8) = z^(2^252-3)
QQ_HD fe fe_pow_p58(const fe& z) {
  fe t19, t3;
  fe_pow22501(z, t19, t3);
  return fe_mul(fe_sq_n(t19, 2), z);
}

// CONTRACT limbs (value < 2p) -> the canonical limbs of value mod p, every
// limb below its mask
QQ_HD fe fe_canonicalize(const fe& a) {
  int32_t h[NL];
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) h[i] = a.v[i];
  // q = floor((value + 19) / 2^255): 1 iff value >= p
  int32_t q = (h[0] + 19) >> 26;
  QQ_UNROLL
  for (int i = 1; i < NL; ++i) q = (h[i] + q) >> (26 - (i & 1));
  h[0] += 19 * q;
  QQ_UNROLL
  for (int i = 0; i < NL - 1; ++i) {
    const int b = 26 - (i & 1);
    h[i + 1] += h[i] >> b;
    h[i] &= (int32_t(1) << b) - 1;
  }
  h[NL - 1] &= (int32_t(1) << 25) - 1;  // drops 2^255 when q == 1
  fe r;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) r.v[i] = h[i];
  return r;
}

// 1 iff the canonical value is odd (RFC 9496's "negative"), else 0
QQ_HD int32_t fe_is_negative(const fe& a) { return fe_canonicalize(a).v[0] & 1; }

// 1 iff a and b are the same value mod p, else 0
QQ_HD int32_t fe_eq(const fe& a, const fe& b) {
  const fe x = fe_canonicalize(a), y = fe_canonicalize(b);
  int32_t d = 0;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) d |= x.v[i] ^ y.v[i];
  return d == 0;
}

QQ_HD int32_t fe_is_zero(const fe& a) {
  const fe x = fe_canonicalize(a);
  int32_t d = 0;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) d |= x.v[i];
  return d == 0;
}

// cond (0 or 1) ? t : f
QQ_HD fe fe_select(int32_t cond, const fe& t, const fe& f) {
  fe r = f;
  fe_cmov(r, t, -cond);
  return r;
}

// |a|: -a where a is negative
QQ_HD fe fe_cabs(const fe& a) { return fe_select(fe_is_negative(a), fe_neg(a), a); }

// (u/v is a square, or u is 0; the nonnegative root r of u/v, or of
// sqrt(-1) u/v where u/v is not a square): RFC 9496 §4.2
QQ_HD int32_t fe_sqrt_ratio_m1(const fe& u, const fe& v, fe& root) {
  const fe sqrt_m1 = fe_sqrt_m1();
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  fe r = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
  const fe check = fe_mul(v, fe_sq(r));
  const fe neg_u = fe_neg(u);
  const int32_t correct_sign = fe_eq(check, u);
  const int32_t flipped_sign = fe_eq(check, neg_u);
  const int32_t flipped_sign_i = fe_eq(check, fe_mul(neg_u, sqrt_m1));
  r = fe_select(flipped_sign | flipped_sign_i, fe_mul(r, sqrt_m1), r);
  root = fe_cabs(r);
  return correct_sign | flipped_sign;
}

QQ_HD int32_t fe_invsqrt(const fe& x, fe& root) { return fe_sqrt_ratio_m1(fe_one(), x, root); }

// ---------------------------------------------------------------------------
// bytes <-> limbs
// ---------------------------------------------------------------------------

// bit offset of limb i: ceil(25.5 i)
QQ_CE int limb_offset(int i) { return 26 * ((i + 1) / 2) + 25 * (i / 2); }

// 32 little-endian bytes -> limbs of the value with bit 255 cleared;
// returns 1 iff the encoding is canonical (the 256-bit value is below p,
// bit 255 clear included), else 0
QQ_HD int32_t fe_from_bytes(const uint8_t b[32], fe& out) {
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) {
    const int off = limb_offset(i), j = off / 8;
    uint64_t window = 0;
    QQ_UNROLL
    for (int k = 0; k < 5; ++k)
      if (j + k < 32) window |= (uint64_t)b[j + k] << (8 * k);
    out.v[i] = (int32_t)((window >> (off % 8)) & ((1u << (26 - (i & 1))) - 1));
  }
  // value mod 2^255 >= p = 2^255 - 19: bytes 1..30 are 0xFF, byte 31 is
  // 0x7F and byte 0 is at least 0xED
  int32_t all_ff = 1;
  QQ_UNROLL
  for (int k = 1; k < 31; ++k) all_ff &= b[k] == 0xFF;
  const int32_t ge_p = (b[0] >= 0xED) & all_ff & ((b[31] & 0x7F) == 0x7F);
  return (1 - ge_p) & (b[31] < 0x80);
}

// canonical limbs -> 32 little-endian bytes
QQ_HD void fe_to_bytes(const fe& c, uint8_t out[32]) {
  QQ_UNROLL
  for (int j = 0; j < 32; ++j) {
    const int bit = 8 * j;
    int lim = 0;
    QQ_UNROLL
    for (int i = 1; i < NL; ++i)
      if (limb_offset(i) <= bit) lim = i;
    const int off = bit - limb_offset(lim), bits = 26 - (lim & 1);
    uint32_t v = (uint32_t)c.v[lim] >> off;
    if (off + 8 > bits && lim + 1 < NL) v |= (uint32_t)c.v[lim + 1] << (bits - off);
    out[j] = (uint8_t)(v & 0xFF);
  }
}

// ---------------------------------------------------------------------------
// the codec
// ---------------------------------------------------------------------------

// Decode 32 bytes: returns 1 iff they are a valid ristretto255 encoding,
// else 0; p holds the limbs the plain version computes either way (Z = 1).
QQ_HD int32_t ristretto_decode(const uint8_t b[32], ge& p) {
  fe s;
  const int32_t canonical = fe_from_bytes(b, s);
  const fe one = fe_one();
  const fe ss = fe_sq(s);
  const fe u1 = fe_sub(one, ss);
  const fe u2 = fe_add(one, ss);
  const fe u2_sqr = fe_sq(u2);
  const fe v = fe_sub(fe_neg(fe_mul(fe_d(), fe_sq(u1))), u2_sqr);
  fe invsqrt;
  const int32_t was_square = fe_invsqrt(fe_mul(v, u2_sqr), invsqrt);
  const fe den_x = fe_mul(invsqrt, u2);
  const fe den_y = fe_mul(fe_mul(invsqrt, den_x), v);
  p.x = fe_cabs(fe_mul(fe_mul_small<2>(s), den_x));
  p.y = fe_mul(u1, den_y);
  p.z = one;
  p.t = fe_mul(p.x, p.y);
  return was_square & (1 - fe_is_negative(p.t)) & (1 - fe_is_zero(p.y)) &
         (1 - fe_is_negative(s)) & canonical;
}

// Encode a point (any representative of its coset) to its canonical 32 bytes.
QQ_HD void ristretto_encode(const ge& p, uint8_t out[32]) {
  const fe u1 = fe_mul(fe_add(p.z, p.y), fe_sub(p.z, p.y));
  const fe u2 = fe_mul(p.x, p.y);
  fe invsqrt;
  fe_invsqrt(fe_mul(u1, fe_sq(u2)), invsqrt);
  const fe den1 = fe_mul(invsqrt, u1);
  const fe den2 = fe_mul(invsqrt, u2);
  const fe z_inv = fe_mul(fe_mul(den1, den2), p.t);
  const fe sqrt_m1 = fe_sqrt_m1();
  const fe ix0 = fe_mul(p.x, sqrt_m1);
  const fe iy0 = fe_mul(p.y, sqrt_m1);
  const fe ench = fe_mul(den1, fe_invsqrt_a_minus_d());
  const int32_t rotate = fe_is_negative(fe_mul(p.t, z_inv));
  const fe x = fe_select(rotate, iy0, p.x);
  fe y = fe_select(rotate, ix0, p.y);
  const fe den_inv = fe_select(rotate, ench, den2);
  y = fe_select(fe_is_negative(fe_mul(x, z_inv)), fe_neg(y), y);
  fe_to_bytes(fe_canonicalize(fe_cabs(fe_mul(den_inv, fe_sub(p.z, y)))), out);
}

}  // namespace qq
