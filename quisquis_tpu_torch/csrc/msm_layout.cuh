// Memory layouts shared by the three MSM kernels (msm_table.cu, msm_acc.cu,
// msm_tail.cu) and strided loads and stores for them.
//
// Every array puts the index that neighbouring threads differ in (the point
// or the lane) last, so a warp's 32 loads of one limb are one 128-byte line:
//   table coordinate  [16 entries][NL limbs][n points]
//   digits            [64 windows][n points]
//   window sums       [rows][64 windows][NL limbs][MSM_LANES lanes]
// The TPU kernels' [16*NL, tile] rows are not carried over. The plain PyTorch
// versions (quisquis_tpu_torch/ops/msm.py) return the same layouts.
#pragma once

#include "point25519.cuh"

namespace qq {

// lanes of one row's accumulators: lane j sums the row's points i with
// i % MSM_LANES == j. Also the block size of msm_acc and msm_tail.
constexpr int MSM_LANES = 128;
constexpr int MSM_WINDOWS = 64;

QQ_HD ge ge_load_strided(const int32_t* x, const int32_t* y, const int32_t* z, const int32_t* t,
                         long off, long stride) {
  return ge{fe_load_strided(x + off, stride), fe_load_strided(y + off, stride),
            fe_load_strided(z + off, stride), fe_load_strided(t + off, stride)};
}

QQ_HD void ge_store_strided(int32_t* x, int32_t* y, int32_t* z, int32_t* t, long off, long stride,
                            const ge& p) {
  fe_store_strided(x + off, stride, p.x);
  fe_store_strided(y + off, stride, p.y);
  fe_store_strided(z + off, stride, p.z);
  fe_store_strided(t + off, stride, p.t);
}

}  // namespace qq
