// Extended twisted-Edwards point formulas (a = -1) for the port's kernels.
//
// Replaces the TPU kernels' point helpers (quisquis_tpu/ops/pallas_point.py:
// _k_double, _k_add_pt, _k_add_niels) with the same formulas and the same
// need_t elision: T is computed only when an addition consumes it. The plain
// PyTorch versions are double/add/add_niels in quisquis_tpu_torch/ops/point.py.
#pragma once

#include "field25519.cuh"

namespace qq {

struct ge {
  fe x, y, z, t;
};

// affine niels form of a table point: (y+x, y-x, 2d*x*y), z = 1
struct ge_niels {
  fe yx, ymx, td2;
};

QQ_HD ge ge_identity() { return ge{fe_zero(), fe_one(), fe_one(), fe_zero()}; }

template <bool NEED_T>
QQ_HD ge ge_double(const ge& p) {
  const fe A = fe_sq(p.x);
  const fe B = fe_sq(p.y);
  const fe C = fe_mul_small<2>(fe_sq(p.z));
  const fe H = fe_add(A, B);
  const fe E = fe_sub(H, fe_sq(fe_add(p.x, p.y)));
  const fe G = fe_sub(A, B);
  const fe F = fe_add(C, G);
  ge r;
  r.x = fe_mul(E, F);
  r.y = fe_mul(G, H);
  r.z = fe_mul(F, G);
  if constexpr (NEED_T) {
    r.t = fe_mul(E, H);
  } else {
    r.t = p.t;
  }
  return r;
}

// complete unified addition (2d*T1*T2), with q's coordinates read one at a
// time, just before each is used (fewer registers live where q comes from
// memory): q(c) returns coordinate c of q (x, y, z, t)
QQ_FUNCTOR_TEMPLATE
template <bool NEED_T, class Q>
QQ_HD ge ge_add_lazy(const ge& p, const Q& q) {
  const fe qy = q(1), qx = q(0);
  const fe A = fe_mul(fe_sub(p.y, p.x), fe_sub(qy, qx));
  const fe B = fe_mul(fe_add(p.y, p.x), fe_add(qy, qx));
  const fe C = fe_mul(fe_mul(p.t, fe_d2()), q(3));
  const fe D = fe_mul_small<2>(fe_mul(p.z, q(2)));
  const fe E = fe_sub(B, A);
  const fe F = fe_sub(D, C);
  const fe G = fe_add(D, C);
  const fe H = fe_add(B, A);
  ge r;
  r.x = fe_mul(E, F);
  r.y = fe_mul(G, H);
  r.z = fe_mul(F, G);
  if constexpr (NEED_T) {
    r.t = fe_mul(E, H);
  } else {
    r.t = p.t;
  }
  return r;
}

template <bool NEED_T>
QQ_HD ge ge_add(const ge& p, const ge& q) {
  return ge_add_lazy<NEED_T>(
      p, [&](int c) { return c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.t; });
}

// mixed addition with an affine niels point: 7 multiplies with T
template <bool NEED_T>
QQ_HD ge ge_add_niels(const ge& p, const ge_niels& q) {
  const fe A = fe_mul(fe_sub(p.y, p.x), q.ymx);
  const fe B = fe_mul(fe_add(p.y, p.x), q.yx);
  const fe C = fe_mul(p.t, q.td2);
  const fe D = fe_mul_small<2>(p.z);
  const fe E = fe_sub(B, A);
  const fe F = fe_sub(D, C);
  const fe G = fe_add(D, C);
  const fe H = fe_add(B, A);
  ge r;
  r.x = fe_mul(E, F);
  r.y = fe_mul(G, H);
  r.z = fe_mul(F, G);
  if constexpr (NEED_T) {
    r.t = fe_mul(E, H);
  } else {
    r.t = p.t;
  }
  return r;
}

QQ_HD void ge_cmov(ge& r, const ge& a, int32_t mask) {
  fe_cmov(r.x, a.x, mask);
  fe_cmov(r.y, a.y, mask);
  fe_cmov(r.z, a.z, mask);
  fe_cmov(r.t, a.t, mask);
}

// mask = -1 if a == b else 0, computed without a branch
QQ_HD int32_t eq_mask(int32_t a, int32_t b) {
  const uint32_t d = (uint32_t)(a ^ b);
  return (int32_t)((d | (0u - d)) >> 31) - 1;
}

// one lane of a batch-major [B, NL] coordinate array
QQ_HD fe fe_load(const int32_t* p, long lane) {
  fe r;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) r.v[i] = p[lane * NL + i];
  return r;
}

QQ_HD void fe_store(int32_t* p, long lane, const fe& a) {
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) p[lane * NL + i] = a.v[i];
}

// limb i of the element at p[i * stride]
QQ_HD fe fe_load_strided(const int32_t* p, long stride) {
  fe r;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) r.v[i] = p[i * stride];
  return r;
}

QQ_HD void fe_store_strided(int32_t* p, long stride, const fe& a) {
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) p[i * stride] = a.v[i];
}

QQ_HD ge ge_load(const int32_t* x, const int32_t* y, const int32_t* z, const int32_t* t,
                 long lane) {
  return ge{fe_load(x, lane), fe_load(y, lane), fe_load(z, lane), fe_load(t, lane)};
}

QQ_HD void ge_store(int32_t* x, int32_t* y, int32_t* z, int32_t* t, long lane, const ge& p) {
  fe_store(x, lane, p.x);
  fe_store(y, lane, p.y);
  fe_store(z, lane, p.z);
  fe_store(t, lane, p.t);
}

}  // namespace qq
