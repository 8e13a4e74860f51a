// Second stage of the multiscalar multiplication: the window sums. For each
// row r, window w and lane j, the point
//     W[r, w, j] = sum over the row's points i with i % MSM_LANES == j
//                  of digit[i, w] * P_i,
// each term picked from msm_table.cu's table of P_i. One thread per (r, w, j).
//
// Replaces: quisquis_tpu/ops/pallas_point.py _msm_acc_kernel (reached from
// msm_window_sums_lm / msm_pallas / msm_rows_pallas). Plain version:
// quisquis_tpu_torch/ops/msm.py msm_window_sums; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_point.py msm_window_sums.
//
// The TPU kernel walks point tiles in a sequential grid, keeps a group of
// eight windows' accumulators in a revisited VMEM block and restarts them at
// each row boundary. None of that is carried over: here the row and the
// window are block indices, the lane is the thread, and the walk over the
// row's tiles is a loop in the thread.
//
// Per point and window: one table lookup and one addition with T (9 field
// multiplies, 900 limb products), so 64 x 900 = 57,600 products a point.
// Bound on this card: operations (2.7e8 products at 4,736 points, 16 us at
// the int32 rate; the digits, the table and the sums together are 15 MB,
// 4.5 us). The table is read 64 times over, from L2.
//
// Constant time: the entry is selected by the branch-free scan over all 16
// that scalar_mul.cu and base_mul.cu use, so no address depends on a digit.
// The range verifier's scalars are public, but the same kernel will carry the
// provers' secret scalars in rows mode; an indexed load for public scalars
// would be a later choice, measured and documented.
#include "msm_layout.cuh"

namespace qq {

// entry `digit` of point i's table (coordinates [16, NL, n]), reading all
// 16; unrolled so that the entries' loads from L2 overlap
QQ_HD ge lookup16_strided(const int32_t* tx, const int32_t* ty, const int32_t* tz,
                          const int32_t* tt, long i, long n, int32_t digit) {
  ge r = ge_load_strided(tx, ty, tz, tt, i, n);
  QQ_UNROLL
  for (int k = 1; k < 16; ++k) {
    ge_cmov(r, ge_load_strided(tx, ty, tz, tt, (long)k * NL * n + i, n), eq_mask(k, digit));
  }
  return r;
}

// lane sum of one window: points first, first + MSM_LANES, ... (tiles of them);
// digits points at this window's row of the [64, n] digit array
QQ_HD ge msm_acc_lane(const int32_t* digits, const int32_t* tx, const int32_t* ty,
                      const int32_t* tz, const int32_t* tt, long first, int tiles, long n) {
  ge acc = ge_identity();
  QQ_NOUNROLL
  for (int t = 0; t < tiles; ++t) {
    const long i = first + (long)t * MSM_LANES;
    acc = ge_add<true>(acc, lookup16_strided(tx, ty, tz, tt, i, n, digits[i]));
  }
  return acc;
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

// grid (64 windows, rows), one block of MSM_LANES threads each
__global__ void __launch_bounds__(qq::MSM_LANES)
msm_acc_kernel(const int32_t* __restrict__ digits, const int32_t* __restrict__ tx,
               const int32_t* __restrict__ ty, const int32_t* __restrict__ tz,
               const int32_t* __restrict__ tt, int32_t* __restrict__ wx,
               int32_t* __restrict__ wy, int32_t* __restrict__ wz, int32_t* __restrict__ wt,
               int tiles) {
  const int w = blockIdx.x, r = blockIdx.y, j = threadIdx.x;
  const long n = (long)gridDim.y * tiles * qq::MSM_LANES;
  const long first = (long)r * tiles * qq::MSM_LANES + j;
  const qq::ge acc = qq::msm_acc_lane(digits + (long)w * n, tx, ty, tz, tt, first, tiles, n);
  const long off = ((long)r * qq::MSM_WINDOWS + w) * qq::NL * qq::MSM_LANES + j;
  qq::ge_store_strided(wx, wy, wz, wt, off, qq::MSM_LANES, acc);
}

}  // namespace

// digits int32 [64, n], t* int32 [16, 10, n], w* int32 [rows, 64, 10, lanes],
// n = rows * tiles * lanes; returns cudaGetLastError(), or
// cudaErrorInvalidValue if lanes is not this file's MSM_LANES
extern "C" int qq_msm_acc(const void* digits, const void* tx, const void* ty, const void* tz,
                          const void* tt, void* wx, void* wy, void* wz, void* wt, int rows,
                          int tiles, int lanes, void* stream) {
  if (lanes != qq::MSM_LANES || tiles < 0) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    const dim3 grid(qq::MSM_WINDOWS, rows);
    msm_acc_kernel<<<grid, qq::MSM_LANES, 0, (cudaStream_t)stream>>>(
        (const int32_t*)digits, (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)tz,
        (const int32_t*)tt, (int32_t*)wx, (int32_t*)wy, (int32_t*)wz, (int32_t*)wt, tiles);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
