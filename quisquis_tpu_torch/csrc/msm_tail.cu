// Last stage of the multiscalar multiplication: per row, the 64 window sums
// of every lane folded by Horner's rule, then the lanes summed to one point.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _msm_tail_kernel (reached from
// msm_pallas / msm_rows_pallas). Plain version:
// quisquis_tpu_torch/ops/msm.py msm_tail; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_point.py msm_tail.
//
// Per lane: acc = W_63, then 63 x (3 doublings without T, 1 with T, 1
// addition of W_w): 1,386 field multiplies and 1,008 squares, 194,040 limb
// products; then log2(MSM_LANES) = 7 rounds of a tree over the lanes (127
// additions a row). The addition is the unified one (a = -1 extended
// coordinates), so identity padding and equal operands need no special case.
//
// Bound on this card: operations (128 lanes x 194,040 products a row, 1.5 us
// at the int32 rate; a row's window sums are 1.3 MB, 0.4 us). What the kernel
// really waits for is the chain: 315 dependent point operations in every
// thread, with one block of 128 threads a row.
//
// The simple design: one block per row, one thread per lane, the tree in
// shared memory (a point is 40 int32; 128 lanes x 160 B = 20 KB static, under
// the 48 KB limit). One point per row is written, not the TPU kernel's
// lane-replicated block.
#include "msm_layout.cuh"

namespace qq {

// Horner fold of one lane's 64 window sums; w* point at lane j of a row of
// the window sums [64, NL, MSM_LANES]
QQ_HD ge msm_tail_lane(const int32_t* wx, const int32_t* wy, const int32_t* wz,
                       const int32_t* wt) {
  constexpr long kWindow = (long)NL * MSM_LANES;
  ge acc = ge_load_strided(wx, wy, wz, wt, (MSM_WINDOWS - 1) * kWindow, MSM_LANES);
  QQ_NOUNROLL
  for (int w = MSM_WINDOWS - 2; w >= 0; --w) {
    acc = ge_double<false>(acc);
    acc = ge_double<false>(acc);
    acc = ge_double<false>(acc);
    acc = ge_double<true>(acc);
    acc = ge_add<true>(acc, ge_load_strided(wx, wy, wz, wt, w * kWindow, MSM_LANES));
  }
  return acc;
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(qq::MSM_LANES)
msm_tail_kernel(const int32_t* __restrict__ wx, const int32_t* __restrict__ wy,
                const int32_t* __restrict__ wz, const int32_t* __restrict__ wt,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                int32_t* __restrict__ ot) {
  constexpr int T = qq::MSM_LANES, NL = qq::NL;
  __shared__ int32_t sx[NL * T], sy[NL * T], sz[NL * T], st[NL * T];
  const int r = blockIdx.x, j = threadIdx.x;
  const long row = (long)r * qq::MSM_WINDOWS * NL * T + j;
  qq::ge acc = qq::msm_tail_lane(wx + row, wy + row, wz + row, wt + row);
  // lane j takes lane j + step's sum, the upper half first (the plain
  // version adds the same pairs in the same order)
  for (int step = T / 2; step >= 1; step >>= 1) {
    if (j >= step && j < 2 * step) qq::ge_store_strided(sx, sy, sz, st, j, T, acc);
    __syncthreads();
    if (j < step) {
      acc = qq::ge_add<true>(acc, qq::ge_load_strided(sx, sy, sz, st, j + step, T));
    }
    __syncthreads();
  }
  if (j == 0) qq::ge_store(ox, oy, oz, ot, r, acc);
}

}  // namespace

// w* int32 [rows, 64, 10, lanes]; o* int32 [rows, 10]; returns
// cudaGetLastError(), or cudaErrorInvalidValue if lanes is not MSM_LANES
extern "C" int qq_msm_tail(const void* wx, const void* wy, const void* wz, const void* wt,
                           void* ox, void* oy, void* oz, void* ot, int rows, int lanes,
                           void* stream) {
  if (lanes != qq::MSM_LANES) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    msm_tail_kernel<<<rows, qq::MSM_LANES, 0, (cudaStream_t)stream>>>(
        (const int32_t*)wx, (const int32_t*)wy, (const int32_t*)wz, (const int32_t*)wt,
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
