// Variable-base scalar multiplication s*P, one lane per thread.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _scalar_mul_kernel (with its
// wrappers scalar_mul_lm / scalar_mul_pallas). Plain version:
// quisquis_tpu_torch/ops/point.py scalar_mul; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_point.py scalar_mul.
//
// Per lane: a 16-entry table 0..15*P (7 doublings for the even entries, 7
// additions for the odd ones, the TPU kernel's schedule), then from digit 63
// down 63 x (3 doublings without T, 1 with T, 1 table addition). A doubling
// is 4 squares and 3 multiplies (4 with T), an addition 9 multiplies, so a
// lane does 1,477 field multiplies and 1,036 squares (2,513 in all).
//
// Bound on this card: operations. A multiply is 100 32x32->64 limb products
// and a square 55 (field25519.cuh fe_mul, fe_sq), so a lane needs
// 1,477 x 100 + 1,036 x 55 = 204,680 products; at N = 16,384 lanes that is
// 3.35e9, against 132 SMs x 64 int32 lanes x the SM clock (about 0.20 ms at
// 1,980 MHz). The 32-bit x19 and x2 pre-scales, the carries and the adds are
// not counted, so this is a lower bound. The bytes moved (nibbles, four
// input and four output coordinates: 416 B a lane) are three orders of
// magnitude below that.
//
// The simple design: one thread per lane, the table per thread in local
// memory (16 x 4 x 10 x 4 B = 2.5 KB, read 64 times), every int64 column
// sum and carry in 64-bit registers. Table entries are selected by a
// branch-free scan over all 16 (no address depends on a secret digit).
// At N = 16,384 only ~124 threads sit on each SM, so latency is not hidden.
// Left for later: several threads per lane, the table in shared memory,
// signed digits (an 8-entry table), 32-bit carries where bounds allow.
//
// ptxas (-Xptxas -v for sm_90a; chip_smoke.py phase 2 prints it): 255
// registers per thread, a 4,800-byte stack frame (the 2,560-byte table plus
// spills), 2,252 bytes of spill stores. __launch_bounds__ is the launched
// block, 128 threads, which leaves ptxas all 255 registers.
#include "point25519.cuh"

namespace qq {

// constant-time: reads all 16 entries and keeps the one that matches
QQ_HD ge lookup16(const ge table[16], int32_t digit) {
  ge r = table[0];
  QQ_UNROLL
  for (int k = 1; k < 16; ++k) ge_cmov(r, table[k], eq_mask(k, digit));
  return r;
}

// digits: 64 little-endian nibbles of one scalar
QQ_HD ge scalar_mul_lane(const int32_t* digits, const ge& p) {
  ge table[16];
  ge_table16(p, table);
  ge acc = lookup16(table, digits[63]);
  QQ_NOUNROLL
  for (int w = 62; w >= 0; --w) {
    acc = ge_double<false>(acc);
    acc = ge_double<false>(acc);
    acc = ge_double<false>(acc);
    acc = ge_double<true>(acc);
    acc = ge_add<true>(acc, lookup16(table, digits[w]));
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
scalar_mul_kernel(const int32_t* __restrict__ nib, const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py, const int32_t* __restrict__ pz,
                  const int32_t* __restrict__ pt, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  int32_t* __restrict__ ot, int n) {
  const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const qq::ge p = qq::ge_load(px, py, pz, pt, lane);
  const qq::ge r = qq::scalar_mul_lane(nib + lane * 64, p);
  qq::ge_store(ox, oy, oz, ot, lane, r);
}

}  // namespace

// nib int32 [n, 64]; p* and o* int32 [n, 10]; returns cudaGetLastError()
extern "C" int qq_scalar_mul(const void* nib, const void* px, const void* py, const void* pz,
                             const void* pt, void* ox, void* oy, void* oz, void* ot, int n,
                             void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    scalar_mul_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nib, (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz,
        (const int32_t*)pt, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
