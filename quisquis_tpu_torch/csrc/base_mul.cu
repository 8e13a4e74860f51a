// Fixed-base scalar multiplication s*B, one lane per thread.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _base_mul_kernel (with its table
// _niels_base_table and wrappers base_mul_lm / base_mul_pallas). Plain
// version: quisquis_tpu_torch/ops/point.py base_mul; wrapper and launch
// counter: quisquis_tpu_torch/ops/cuda_point.py base_mul.
//
// The table (built once on the host by point.niels_base_table_np, uploaded
// once per process) holds entry k of window w as (16^w * k) * B in affine
// niels form (y+x, y-x, 2d*x*y): int32 [64][16][3][10], 120 KB. Each lane
// adds one entry per window to an accumulator that starts at the identity:
// 64 mixed additions, no doublings, 64 x 7 = 448 field multiplies. Entry 0
// is (1, 1, 0), which the complete formulas add as the identity.
//
// Bound on this card: operations. 448 x 100 32x32->64 limb products a lane
// (field25519.cuh fe_mul; no squares), 7.3e8 at N = 16,384; the bytes
// (nibbles in, four coordinates out, the table once) are far below that.
//
// The simple design: one thread per lane; the table stays in global memory
// and every lane scans all 16 entries of its window (constant time: no
// address depends on the secret digit). All lanes of a warp read the same
// addresses, so the loads are broadcasts served from L1. Left for later:
// the window's 16 entries in shared memory, several threads per lane,
// signed digits (8 entries).
//
// ptxas (-Xptxas -v for sm_90a; chip_smoke.py phase 2 prints it): 140
// registers per thread, no stack frame, no spills. __launch_bounds__ is the
// launched block, 128 threads.
#include "point25519.cuh"

#ifdef __CUDA_ARCH__  // device pass: read through the read-only data cache
#define QQ_LDG(p) __ldg(p)
#else
#define QQ_LDG(p) (*(p))
#endif

namespace qq {

constexpr int kNielsInts = 3 * NL;         // one entry
constexpr int kWindowInts = 16 * kNielsInts;  // one window

QQ_HD ge_niels niels_load(const int32_t* e) {
  ge_niels r;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) {
    r.yx.v[i] = QQ_LDG(e + i);
    r.ymx.v[i] = QQ_LDG(e + NL + i);
    r.td2.v[i] = QQ_LDG(e + 2 * NL + i);
  }
  return r;
}

// constant-time: reads all 16 entries of the window and keeps the match;
// unrolled so that the window's 480 loads overlap (measured in PERF.md)
QQ_HD ge_niels niels_lookup16(const int32_t* window, int32_t digit) {
  ge_niels r = niels_load(window);
  QQ_UNROLL
  for (int k = 1; k < 16; ++k) {
    const ge_niels e = niels_load(window + k * kNielsInts);
    const int32_t m = eq_mask(k, digit);
    fe_cmov(r.yx, e.yx, m);
    fe_cmov(r.ymx, e.ymx, m);
    fe_cmov(r.td2, e.td2, m);
  }
  return r;
}

// table: int32 [64][16][3][10]; digits: 64 little-endian nibbles
QQ_HD ge base_mul_lane(const int32_t* table, const int32_t* digits) {
  ge acc = ge_identity();
  QQ_NOUNROLL
  for (int w = 0; w < 64; ++w) {
    acc = ge_add_niels<true>(acc, niels_lookup16(table + w * kWindowInts, digits[w]));
  }
  return acc;
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

// threads per block of every launch; __launch_bounds__ is set to it
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
base_mul_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ nib,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, int32_t* __restrict__ ot, int n) {
  const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const qq::ge r = qq::base_mul_lane(table, nib + lane * 64);
  qq::ge_store(ox, oy, oz, ot, lane, r);
}

}  // namespace

// table int32 [64, 16, 3, 10]; nib int32 [n, 64]; o* int32 [n, 10];
// returns cudaGetLastError()
extern "C" int qq_base_mul(const void* table, const void* nib, void* ox, void* oy, void* oz,
                           void* ot, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    base_mul_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, (const int32_t*)nib, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
        (int32_t*)ot, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
