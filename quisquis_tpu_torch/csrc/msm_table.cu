// First stage of the multiscalar multiplication: per point P its 16 small
// multiples 0*P .. 15*P, one point per thread.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _msm_table_kernel (reached from
// msm_window_sums_lm / msm_pallas / msm_rows_pallas). Plain version:
// quisquis_tpu_torch/ops/msm.py msm_table; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_point.py msm_table.
//
// Per point: 7 doublings and 7 additions, all with T (ge_table16 in
// point25519.cuh, the TPU kernel's schedule): 91 field multiplies and 28
// squares, 10,640 32x32->64 limb products. It reads 160 bytes and writes the
// table, 16 x 4 x 10 x 4 = 2,560 bytes.
//
// Bound on this card: bytes. At n = 4,736 points (the range verifier's 4,610
// padded to whole lanes) the table is 12.1 MB, 3.8 us at 3.35 TB/s, against
// 5.0e7 products, 3.0 us at the int32 rate: the two are close, and the write
// is the larger.
//
// The simple design: the table is built in the thread's local memory, as in
// scalar_mul.cu, then written entry-major and point-minor (msm_layout.cuh) so
// that the writes of a warp, and the reads of msm_acc.cu, are coalesced over
// points. Global memory is enough: nothing is staged in shared memory.
#include "msm_layout.cuh"

namespace qq {

// writes the 16 multiples of point i of n into the four table coordinates
QQ_HD void msm_table_lane(const ge& p, int32_t* tx, int32_t* ty, int32_t* tz, int32_t* tt, long i,
                          long n) {
  ge table[16];
  ge_table16(p, table);
  QQ_NOUNROLL
  for (int k = 0; k < 16; ++k) {
    ge_store_strided(tx, ty, tz, tt, (long)k * NL * n + i, n, table[k]);
  }
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
msm_table_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                 const int32_t* __restrict__ pz, const int32_t* __restrict__ pt,
                 int32_t* __restrict__ tx, int32_t* __restrict__ ty, int32_t* __restrict__ tz,
                 int32_t* __restrict__ tt, int n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  qq::msm_table_lane(qq::ge_load(px, py, pz, pt, i), tx, ty, tz, tt, i, n);
}

}  // namespace

// p* int32 [n, 10]; t* int32 [16, 10, n]; returns cudaGetLastError()
extern "C" int qq_msm_table(const void* px, const void* py, const void* pz, const void* pt,
                            void* tx, void* ty, void* tz, void* tt, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    msm_table_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)pt,
        (int32_t*)tx, (int32_t*)ty, (int32_t*)tz, (int32_t*)tt, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
