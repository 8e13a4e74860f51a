// Point operations shared by four threads: a "quad" holds one extended point
// (X, Y, Z, T), thread r of the quad (its role) coordinate r, and each point
// operation is two rounds of one field product per role (Hisil, Wong,
// Carter, Dawson 2008, section 4, a = -1):
//
//   doubling      round 1: (X+Y)^2, Y^2, 2 Z^2, X^2 on roles 0..3 = S, B, C, A
//                 round 2: E F, G H, F G, E H   with H = A+B, E = H-S,
//                          G = A-B, F = C+G
//   addition of   round 1: (Y1-X1)(Y2-X2), (Y1+X1)(Y2+X2),
//   a cached               2 Z1 Z2, T1 (2d T2)                   = A, B, D, C
//   point         round 2: E F, G H, F G, E H   with E = B-A, F = D-C,
//                          G = D+C, H = B+A
//
// A cached point is (Y-X, Y+X, Z, 2d T), role r holding entry r; it is what
// an addend is stored as (dalek's ProjectiveNielsPoint with Z kept). Both
// operations give the limbs of the one-thread formulas of point25519.cuh
// (ge_double; ge_add with 2d T2 computed first), whose plain PyTorch
// versions are double and add_cached in quisquis_tpu_torch/ops/point.py.
//
// Between steps the roles exchange field elements, each role reading one
// other role's value: round 2's sums are spread so that a role forms at
// most one sum a step from its own value and one it read, and then reads
// its two factors from the roles that formed them. A doubling exchanges 5
// field elements a role (1 in round 1, 4 in round 2) and forms 3 sums, an
// addition exchanges 4 and forms 2. The exchange is a policy: QuadShfl
// (device) is one thread of a quad and reads with __shfl_sync inside groups
// of 4 lanes; QuadHost runs the four roles of one quad in turn over an
// array, so g++ builds the same round functions and point operations for
// tests/test_torch_csrc_host.py. A round function branches on the role,
// never on data: the four roles share a warp, which runs each role's work
// in turn.
#pragma once

#include "point25519.cuh"

namespace qq {

// ---------------------------------------------------------------------------
// exchange policies
// ---------------------------------------------------------------------------

// The four roles of one quad, run in turn on the host.
struct QuadHost {
  struct V {
    fe c[4];
    QQ_HD fe& at(int r) { return c[r]; }
    QQ_HD const fe& at(int r) const { return c[r]; }
  };
  QQ_HD int first() const { return 0; }
  QQ_HD int end() const { return 4; }
  // role src's element of v, as role r sees it
  QQ_HD fe from(const V& v, int /*r*/, int src) const { return v.c[src]; }
};

// One thread of a quad on the device: the quad is 4 consecutive lanes of a
// warp, `role` = lane % 4, and `mask` names every lane that runs the quad
// code (all of them call each shuffle).
struct QuadShfl {
  struct V {
    fe c;
    QQ_HD fe& at(int) { return c; }
    QQ_HD const fe& at(int) const { return c; }
  };
  int role;
  unsigned mask;
  QQ_HD int first() const { return role; }
  QQ_HD int end() const { return role + 1; }
  QQ_HD fe from(const V& v, int /*r*/, int src) const {
#ifdef __CUDA_ARCH__
    fe r;
    QQ_UNROLL
    for (int i = 0; i < NL; ++i) r.v[i] = __shfl_sync(mask, v.c.v[i], src, 4);
    return r;
#else
    return v.c;  // host builds never run a QuadShfl
#endif
  }
};

// ---------------------------------------------------------------------------
// rounds: functions of (role, inputs), the same on host and device
// ---------------------------------------------------------------------------

// a + b, or a - b where sub = -1: the limbs of fe_add / fe_sub, one reduce
QQ_HD fe fe_addsub(const fe& a, const fe& b, int32_t sub) {
  int32_t z[NL];
  QQ_UNROLL
  for (int i = 0; i < NL; ++i)
    z[i] = a.v[i] + ((int32_t)bias_limb(i) & sub) + ((b.v[i] ^ sub) - sub);
  return reduce_small(z);
}

// Which role a role reads in an exchange: a table of four 2-bit entries,
// role r's at bits 4r (written 0xdcba for roles 0..3 reading a, b, c, d)
QQ_HD int src_of(int table, int role) { return (table >> (4 * role)) & 3; }

// Doubling, round 1. got: Y on role 0, X on role 3 (sources 1, 1, 2, 0).
// -> S = (X+Y)^2, B = Y^2, C = 2 Z^2, A = X^2 on roles 0..3.
QQ_HD fe quad_dbl1(int role, const fe& own, const fe& got) {
  const fe s = fe_sq(role == 0 ? fe_add(own, got) : role == 3 ? got : own);
  return role == 2 ? fe_mul_small<2>(s) : s;
}
constexpr int DBL1_SRC = 0x0211;

// Doubling, round 2, first step. partner: role ^ 2's value. -> G = A-B on
// role 1, H = A+B on role 3 (roles 0 and 2: unused).
QQ_HD fe quad_dbl2a(int role, const fe& own, const fe& partner) {
  return (role & 1) ? fe_addsub(partner, own, eq_mask(role, 1)) : own;
}

// Doubling, round 2, second step. got: H on role 0, G on role 2 (sources 3,
// 1, 1, 3 of step a). -> E = H-S on role 0, F = C+G on role 2; each role's
// factor source: E, G, F, H.
QQ_HD fe quad_dbl2b(int role, const fe& own, const fe& got, const fe& step_a) {
  return (role & 1) ? step_a : fe_addsub(got, own, eq_mask(role, 0));
}
constexpr int DBL2B_SRC = 0x3113;

// Addition of a cached point, round 1. partner: role ^ 1's coordinate,
// cached: this role's entry of the addend. -> A = (Y1-X1)(Y2-X2),
// B = (Y1+X1)(Y2+X2), D = 2 Z1 Z2, C = T1 (2d T2) on roles 0..3.
QQ_HD fe quad_add1(int role, const fe& own, const fe& partner, const fe& cached) {
  const fe s = fe_mul(role < 2 ? fe_addsub(partner, own, eq_mask(role, 0)) : own, cached);
  return role == 2 ? fe_mul_small<2>(s) : s;
}

// Addition, round 2, first step. partner: role ^ 1's value. -> E = B-A,
// H = B+A, G = D+C, F = D-C on roles 0..3.
QQ_HD fe quad_add2a(int role, const fe& own, const fe& partner) {
  return fe_addsub(partner, own, eq_mask(role, 0) | eq_mask(role, 3));
}

// Round 2 of both ends in one product a role, E F, G H, F G, E H (the
// point's X, Y, Z, T); the factors are read from these roles:
constexpr int DBL_F1 = 0x0210, DBL_F2 = 0x3132;
constexpr int ADD_F1 = 0x0320, ADD_F2 = 0x1213;

// Cached form. partner: role ^ 1's coordinate. -> Y-X, Y+X, Z, 2d T.
QQ_HD fe quad_cached1(int role, const fe& own, const fe& partner) {
  return role < 2 ? fe_addsub(partner, own, eq_mask(role, 0))
                  : role == 3 ? fe_mul(own, fe_d2()) : own;
}

// the same in one thread, for a point that one thread holds
QQ_HD void ge_to_cached(const ge& p, fe out[4]) {
  out[0] = fe_sub(p.y, p.x);
  out[1] = fe_add(p.y, p.x);
  out[2] = p.z;
  out[3] = fe_mul(p.t, fe_d2());
}

// ---------------------------------------------------------------------------
// point operations
// ---------------------------------------------------------------------------

template <class Q>
QQ_HD typename Q::V quad_identity(const Q& q) {
  typename Q::V p;
  for (int r = q.first(); r < q.end(); ++r) {
    fe v = fe_zero();
    fe_cmov(v, fe_one(), eq_mask(r, 1) | eq_mask(r, 2));
    p.at(r) = v;
  }
  return p;
}

// p <- 2p; without NEED_T role 3 keeps p's T and idles in the last product
template <bool NEED_T, class Q>
QQ_HD void quad_double(const Q& q, typename Q::V& p) {
  typename Q::V s, a, b;
  for (int r = q.first(); r < q.end(); ++r)
    s.at(r) = quad_dbl1(r, p.at(r), q.from(p, r, src_of(DBL1_SRC, r)));
  for (int r = q.first(); r < q.end(); ++r) a.at(r) = quad_dbl2a(r, s.at(r), q.from(s, r, r ^ 2));
  for (int r = q.first(); r < q.end(); ++r)
    b.at(r) = quad_dbl2b(r, s.at(r), q.from(a, r, src_of(DBL2B_SRC, r)), a.at(r));
  for (int r = q.first(); r < q.end(); ++r) {
    const fe f1 = q.from(b, r, src_of(DBL_F1, r)), f2 = q.from(b, r, src_of(DBL_F2, r));
    if (NEED_T || r != 3) p.at(r) = fe_mul(f1, f2);
  }
}

// p <- p + c, c in cached form; T always computed
template <class Q>
QQ_HD void quad_add(const Q& q, typename Q::V& p, const typename Q::V& c) {
  typename Q::V s, a;
  for (int r = q.first(); r < q.end(); ++r)
    s.at(r) = quad_add1(r, p.at(r), q.from(p, r, r ^ 1), c.at(r));
  for (int r = q.first(); r < q.end(); ++r) a.at(r) = quad_add2a(r, s.at(r), q.from(s, r, r ^ 1));
  for (int r = q.first(); r < q.end(); ++r)
    p.at(r) = fe_mul(q.from(a, r, src_of(ADD_F1, r)), q.from(a, r, src_of(ADD_F2, r)));
}

template <class Q>
QQ_HD typename Q::V quad_to_cached(const Q& q, const typename Q::V& p) {
  typename Q::V c;
  for (int r = q.first(); r < q.end(); ++r)
    c.at(r) = quad_cached1(r, p.at(r), q.from(p, r, r ^ 1));
  return c;
}

// Horner's rule in radix 16 from the identity: for w = top .. 0, four
// doublings (3 without T, 1 with T; none before the first addition), then
// the cached addend(w) added
QQ_FUNCTOR_TEMPLATE
template <class Q, class Addend>
QQ_HD typename Q::V quad_horner16(const Q& q, int top, const Addend& addend) {
  typename Q::V acc = quad_identity(q);
  quad_add(q, acc, addend(top));
  QQ_NOUNROLL
  for (int w = top - 1; w >= 0; --w) {
    quad_double<false>(q, acc);
    quad_double<false>(q, acc);
    quad_double<false>(q, acc);
    quad_double<true>(q, acc);
    quad_add(q, acc, addend(w));
  }
  return acc;
}

// ---------------------------------------------------------------------------
// signed radix 16 and the 8-entry table of variable-base multiplication
// ---------------------------------------------------------------------------

constexpr int SIGNED_DIGITS = 65;

// 64 nibbles 0..15 of a 256-bit integer (little-endian) -> 65 digits in
// -8..8 with the same value sum 16^w e_w (dalek's Scalar::as_radix_16; a
// top nibble >= 8 carries into digit 64, which is 0 or 1). Branch-free.
QQ_HD void signed_radix16(const int32_t* nibbles, int8_t* digits, int stride) {
  int32_t carry = 0;
  QQ_NOUNROLL
  for (int w = 0; w < SIGNED_DIGITS - 1; ++w) {
    const int32_t v = nibbles[w] + carry;
    carry = (v + 8) >> 4;
    digits[w * stride] = (int8_t)(v - (carry << 4));
  }
  digits[(SIGNED_DIGITS - 1) * stride] = (int8_t)carry;
}

// store(r, k, v) keeps role r's entry of multiple k: m in cached form
QQ_FUNCTOR_TEMPLATE
template <class Q, class Store>
QQ_HD void quad_store_cached(const Q& q, int k, const typename Q::V& m, const Store& store) {
  const typename Q::V c = quad_to_cached(q, m);
  for (int r = q.first(); r < q.end(); ++r) store(r, k, c.at(r));
}

// The cached multiples 1..8 of p, 4 doublings and 3 additions:
// 2 = 2(1), 3 = 2+1, 4 = 2(2), 5 = 4+1, 6 = 2(3), 7 = 6+1, 8 = 2(4).
QQ_FUNCTOR_TEMPLATE
template <class Q, class Store>
QQ_HD void quad_table8(const Q& q, const typename Q::V& p, const Store& store) {
  typedef typename Q::V V;
  const V c1 = quad_to_cached(q, p);
  for (int r = q.first(); r < q.end(); ++r) store(r, 1, c1.at(r));
  V p2 = p;
  quad_double<true>(q, p2);
  quad_store_cached(q, 2, p2, store);
  V p3 = p2;
  quad_add(q, p3, c1);
  quad_store_cached(q, 3, p3, store);
  V p4 = p2;
  quad_double<true>(q, p4);
  quad_store_cached(q, 4, p4, store);
  V m = p4;
  quad_add(q, m, c1);
  quad_store_cached(q, 5, m, store);
  m = p3;
  quad_double<true>(q, m);
  quad_store_cached(q, 6, m, store);
  quad_add(q, m, c1);
  quad_store_cached(q, 7, m, store);
  quad_double<true>(q, p4);
  quad_store_cached(q, 8, p4, store);
}

// Entry |d| of the cached table (0: the identity, cached (1, 1, 1, 0)),
// negated when d < 0: Y-X and Y+X swap, 2d T changes sign. entry(r, k) is
// role r's entry of multiple k; all 8 are read whatever d is, and no
// address depends on d.
QQ_FUNCTOR_TEMPLATE
template <class Q, class Entry>
QQ_HD typename Q::V quad_select(const Q& q, int32_t d, const Entry& entry) {
  const int32_t neg = d >> 31;
  const int32_t mag = (d ^ neg) - neg;
  typename Q::V e;
  for (int r = q.first(); r < q.end(); ++r) {
    fe v = fe_one();
    fe_cmov(v, fe_zero(), eq_mask(r, 3));
    QQ_UNROLL
    for (int k = 1; k <= 8; ++k) fe_cmov(v, entry(r, k), eq_mask(k, mag));
    e.at(r) = v;
  }
  typename Q::V out;
  for (int r = q.first(); r < q.end(); ++r) {
    fe v = e.at(r);
    fe_cmov(v, q.from(e, r, r ^ 1), neg & (eq_mask(r, 0) | eq_mask(r, 1)));
    fe_cmov(v, fe_neg(v), neg & eq_mask(r, 3));
    out.at(r) = v;
  }
  return out;
}

}  // namespace qq
