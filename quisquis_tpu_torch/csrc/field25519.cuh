// GF(2^255-19) arithmetic for the port's kernels, one element per thread.
//
// Replaces the TPU's in-kernel field library (quisquis_tpu/ops/pallas_field.py:
// reduce_bounded, k_mul, k_square, k_add, k_sub, k_mul_small), which works in
// radix 2^11 x 24 int32 limbs because the TPU's vector unit has no 64-bit
// multiply. Here the radix is dalek's 32-bit backend layout (FieldElement2625):
// 10 int32 limbs of alternately 26 and 25 bits; limb i has weight 2^ceil(25.5 i).
// Products are 32x32->64 multiplies (IMAD.WIDE) summed in int64 columns, with
// the x19 fold and the x2 half-bit factor applied to one operand before the
// product, so the multiply needs no carry chain inside it. The sums of
// add, sub, neg and small multiples stay below 2^31 and carry in int32.
//
// The plain PyTorch version is quisquis_tpu_torch/ops/field.py: same limbs,
// same carry chain, same bias, so results agree limb for limb. Its docstring
// states the bounds; the static_asserts below prove them again for this code.
//
// Builds as CUDA (nvcc) and as plain C++ (g++), so the host test
// (tests/test_torch_csrc_host.py) runs this arithmetic on the CPU.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define QQ_HD __host__ __device__ __forceinline__
#define QQ_CE __host__ __device__ constexpr
#define QQ_UNROLL _Pragma("unroll")
#define QQ_NOUNROLL _Pragma("unroll 1")
#else
#define QQ_HD inline
#define QQ_CE constexpr
#define QQ_UNROLL
#define QQ_NOUNROLL
#endif

// Before a host-device template that takes a functor: a device-only lambda
// passed to it is fine in device code, and this keeps nvcc from checking
// the host side.
#ifdef __CUDACC__
#define QQ_FUNCTOR_TEMPLATE _Pragma("nv_exec_check_disable")
#else
#define QQ_FUNCTOR_TEMPLATE
#endif

namespace qq {

constexpr int NL = 10;

struct fe {
  int32_t v[NL];
};

// ---------------------------------------------------------------------------
// Compile-time bound proof. CONTRACT[i] is the largest value any limb may
// hold between operations: 2^26-1 (even i), 2^25-1 (odd i), plus 2^9 on
// limbs 1 and 5, which the final carries of reduce() leave slightly over.
// Every operation takes CONTRACT limbs and returns CONTRACT limbs; each
// static_assert below checks one operation: no int64 column or carry
// passes 2^63 - 1, no int32 pre-scaled operand passes 2^31 - 1.
// ---------------------------------------------------------------------------
namespace bounds {

struct B10 {
  unsigned long long v[NL];
};

constexpr unsigned long long kI64Max = 0x7fffffffffffffffULL;
constexpr unsigned long long kI32Max = 0x7fffffffULL;
QQ_CE int bits(int i) { return 26 - (i & 1); }
QQ_CE unsigned long long mask(int i) { return (1ULL << bits(i)) - 1; }

QQ_CE B10 contract() {
  B10 b{};
  for (int i = 0; i < NL; ++i) b.v[i] = mask(i) + ((i == 1 || i == 5) ? (1ULL << 9) : 0);
  return b;
}

// 2p limb by limb: p = (2^26-19, 2^25-1, 2^26-1, ...)
QQ_CE B10 bias() {
  B10 b{};
  for (int i = 0; i < NL; ++i) b.v[i] = 2 * (i == 0 ? mask(0) - 18 : mask(i));
  return b;
}

QQ_CE B10 scaled(B10 a, unsigned long long c) {
  for (int i = 0; i < NL; ++i) a.v[i] *= c;
  return a;
}

QQ_CE B10 sum(B10 a, B10 b) {
  for (int i = 0; i < NL; ++i) a.v[i] += b.v[i];
  return a;
}

QQ_CE bool all_le(B10 a, B10 b) {
  for (int i = 0; i < NL; ++i)
    if (a.v[i] > b.v[i]) return false;
  return true;
}

QQ_CE unsigned long long factor(int i, int j) {
  return (i + j >= NL ? 19ULL : 1ULL) * (((i & j & 1) != 0) ? 2ULL : 1ULL);
}

// product columns; each term < 2^60, ten terms < 2^64, so no wrap here
QQ_CE B10 mul_cols(B10 a, B10 b) {
  B10 z{};
  for (int i = 0; i < NL; ++i)
    for (int j = 0; j < NL; ++j) z.v[(i + j) % NL] += a.v[i] * b.v[j] * factor(i, j);
  return z;
}

// the carry chain of reduce(), on upper bounds; true iff no intermediate
// passes `max` (2^63 - 1: int64 columns; 2^31 - 1: reduce_small's int32)
// and the result lies within CONTRACT
QQ_CE bool reduce_ok(B10 b, unsigned long long max = kI64Max) {
  for (int i = 0; i < NL; ++i)
    if (b.v[i] > max) return false;
  const int order[12] = {0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0};
  for (int s = 0; s < 12; ++s) {
    const int i = order[s];
    const unsigned long long c = b.v[i] >> bits(i);
    if (b.v[i] > mask(i)) b.v[i] = mask(i);
    const int to = (i + 1) % NL;
    const unsigned long long add = (i == NL - 1) ? 19 * c : c;
    if (add > max - b.v[to]) return false;
    b.v[to] += add;
  }
  return all_le(b, contract());
}

QQ_CE bool i32_ok(B10 a) {
  for (int i = 0; i < NL; ++i)
    if (a.v[i] > kI32Max) return false;
  return true;
}

}  // namespace bounds

// mul/square: 19*b_j and 2*a_i (4*a_i in square) are formed in int32
static_assert(bounds::i32_ok(bounds::scaled(bounds::contract(), 19)), "19*limb overflows int32");
static_assert(bounds::i32_ok(bounds::scaled(bounds::contract(), 4)), "4*limb overflows int32");
// mul/square: every column fits int64 and the carry chain restores CONTRACT
static_assert(bounds::reduce_ok(bounds::mul_cols(bounds::contract(), bounds::contract())),
              "fe_mul bound");
// add: a + b, carried in int32
static_assert(bounds::reduce_ok(bounds::scaled(bounds::contract(), 2), bounds::kI32Max),
              "fe_add bound");
// sub/neg: a + 2p - b, with 2p >= CONTRACT limb by limb so no limb goes
// negative; carried in int32
static_assert(bounds::all_le(bounds::contract(), bounds::bias()), "bias must dominate");
static_assert(bounds::reduce_ok(bounds::sum(bounds::contract(), bounds::bias()), bounds::kI32Max),
              "fe_sub bound");

// ---------------------------------------------------------------------------
// operations
// ---------------------------------------------------------------------------

template <int I>
QQ_HD void carry(int64_t z[NL]) {
  constexpr int b = 26 - (I & 1);
  const int64_t c = z[I] >> b;
  z[I] &= (int64_t(1) << b) - 1;
  if constexpr (I == NL - 1) {
    z[0] += 19 * c;
  } else {
    z[I + 1] += c;
  }
}

// dalek's FieldElement2625::reduce chain; nonnegative input bounded as
// proved above -> CONTRACT limbs
QQ_HD fe reduce(int64_t z[NL]) {
  carry<0>(z); carry<4>(z);
  carry<1>(z); carry<5>(z);
  carry<2>(z); carry<6>(z);
  carry<3>(z); carry<7>(z);
  carry<4>(z); carry<8>(z);
  carry<9>(z);
  carry<0>(z);
  fe r;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) r.v[i] = (int32_t)z[i];
  return r;
}

template <int I>
QQ_HD void carry_small(int32_t z[NL]) {
  constexpr int b = 26 - (I & 1);
  const int32_t c = z[I] >> b;
  z[I] &= (int32_t(1) << b) - 1;
  if constexpr (I == NL - 1) {
    z[0] += 19 * c;
  } else {
    z[I + 1] += c;
  }
}

// reduce() for the sums of add, sub, neg and small multiples, whose limbs
// and carries fit int32 (the static_asserts above): the same integers with
// half the instructions and no 64-bit carry propagation
QQ_HD fe reduce_small(int32_t z[NL]) {
  carry_small<0>(z); carry_small<4>(z);
  carry_small<1>(z); carry_small<5>(z);
  carry_small<2>(z); carry_small<6>(z);
  carry_small<3>(z); carry_small<7>(z);
  carry_small<4>(z); carry_small<8>(z);
  carry_small<9>(z);
  carry_small<0>(z);
  fe r;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) r.v[i] = z[i];
  return r;
}

QQ_HD constexpr int64_t bias_limb(int i) {
  return i == 0 ? 134217690 : ((i & 1) ? 67108862 : 134217726);  // 2p
}

QQ_HD fe fe_zero() {
  fe r;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) r.v[i] = 0;
  return r;
}

QQ_HD fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

// 2*d, d = -121665/121666
QQ_HD fe fe_d2() {
  return fe{{45281625, 27714825, 36363642, 13898781, 229458,
             15978800, 54557047, 27058993, 29715967, 9444199}};
}

QQ_HD fe fe_add(const fe& a, const fe& b) {
  int32_t z[NL];
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) z[i] = a.v[i] + b.v[i];
  return reduce_small(z);
}

QQ_HD fe fe_sub(const fe& a, const fe& b) {
  int32_t z[NL];
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) z[i] = a.v[i] + (int32_t)bias_limb(i) - b.v[i];
  return reduce_small(z);
}

QQ_HD fe fe_neg(const fe& a) {
  int32_t z[NL];
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) z[i] = (int32_t)bias_limb(i) - a.v[i];
  return reduce_small(z);
}

template <int C>
QQ_HD fe fe_mul_small(const fe& a) {
  static_assert(C >= 0, "nonnegative constant");
  static_assert(bounds::reduce_ok(bounds::scaled(bounds::contract(), C), bounds::kI32Max),
                "fe_mul_small bound");
  int32_t z[NL];
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) z[i] = a.v[i] * C;
  return reduce_small(z);
}

QQ_HD fe fe_mul(const fe& a, const fe& b) {
  int32_t a2[NL], b19[NL];
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) {
    a2[i] = 2 * a.v[i];
    b19[i] = 19 * b.v[i];
  }
  int64_t z[NL];
  QQ_UNROLL
  for (int k = 0; k < NL; ++k) z[k] = 0;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) {
    QQ_UNROLL
    for (int j = 0; j < NL; ++j) {
      const int32_t x = ((i & j & 1) != 0) ? a2[i] : a.v[i];
      const int32_t y = (i + j >= NL) ? b19[j] : b.v[j];
      z[(i + j) % NL] += (int64_t)x * y;
    }
  }
  return reduce(z);
}

// the same columns as fe_mul(a, a) from 55 products
QQ_HD fe fe_sq(const fe& a) {
  int32_t a2[NL], a4[NL], a19[NL];
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) {
    a2[i] = 2 * a.v[i];
    a4[i] = 4 * a.v[i];
    a19[i] = 19 * a.v[i];
  }
  int64_t z[NL];
  QQ_UNROLL
  for (int k = 0; k < NL; ++k) z[k] = 0;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) {
    QQ_UNROLL
    for (int j = i; j < NL; ++j) {
      const bool odd = (i & j & 1) != 0;
      const int32_t x = (i == j) ? (odd ? a2[i] : a.v[i]) : (odd ? a4[i] : a2[i]);
      const int32_t y = (i + j >= NL) ? a19[j] : a.v[j];
      z[(i + j) % NL] += (int64_t)x * y;
    }
  }
  return reduce(z);
}

QQ_HD fe fe_sq_n(fe a, int n) {
  QQ_NOUNROLL
  for (int i = 0; i < n; ++i) a = fe_sq(a);
  return a;
}

// (z^(2^250-1), z^11)
QQ_HD void fe_pow22501(const fe& z, fe& t19, fe& t3) {
  const fe t0 = fe_sq(z);
  const fe t2 = fe_mul(z, fe_sq_n(t0, 2));
  t3 = fe_mul(t0, t2);
  const fe t5 = fe_mul(t2, fe_sq(t3));
  const fe t7 = fe_mul(fe_sq_n(t5, 5), t5);
  const fe t9 = fe_mul(fe_sq_n(t7, 10), t7);
  const fe t11 = fe_mul(fe_sq_n(t9, 20), t9);
  const fe t13 = fe_mul(fe_sq_n(t11, 10), t7);
  const fe t15 = fe_mul(fe_sq_n(t13, 50), t13);
  const fe t17 = fe_mul(fe_sq_n(t15, 100), t15);
  t19 = fe_mul(fe_sq_n(t17, 50), t13);
}

// z^(p-2); maps 0 to 0
QQ_HD fe fe_invert(const fe& z) {
  fe t19, t3;
  fe_pow22501(z, t19, t3);
  return fe_mul(fe_sq_n(t19, 5), t3);
}

// r = mask ? a : r, for mask 0 or -1, without a branch
QQ_HD void fe_cmov(fe& r, const fe& a, int32_t mask) {
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) r.v[i] ^= (r.v[i] ^ a.v[i]) & mask;
}

}  // namespace qq
