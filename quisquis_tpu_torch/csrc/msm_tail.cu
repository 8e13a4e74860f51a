// Last stage of the multiscalar multiplication: per row, the lanes' window
// sums added up per window, then one Horner chain over the 64 totals.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _msm_tail_kernel (reached from
// msm_pallas / msm_rows_pallas). Plain version:
// quisquis_tpu_torch/ops/msm_plain.py msm_tail; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_point.py msm_tail.
//
// sum_lane sum_w 16^w W[w, lane] = sum_w 16^w (sum_lane W[w, lane]), so one
// kernel of 64 x rows blocks of 128 threads does, per row:
// 1. fold: per (row, window) a block adds the 128 lanes in a tree (lane j
//    takes lane j + step, step = 64 .. 1; 127 additions, 7 levels, one
//    thread an addition, the tree in shared memory); thread 0 puts the
//    window total in cached form (Y-X, Y+X, Z, 2d T) in a scratch array;
// 2. chain: the block that finishes a row's last window (a counter per
//    row, after a __threadfence) copies the row's totals to shared memory
//    and runs the row's Horner chain with one quad, its threads 0-3
//    (quad25519.cuh quad_horner16, shared with scalar_mul.cu): from the
//    identity, 64 additions of the cached totals and 63 x (3 doublings
//    without T, 1 with T).
//
// Work a row: fold 127 additions of 9 multiplies; 64 cached totals (1
// multiply); chain 189 doublings
// without T (3 multiplies, 4 squares), 63 with T (4, 4), 64 additions (8
// multiplies): 1,143 + 64 + 1,331 = 2,538 multiplies and 1,008 squares,
// 309,240 limb products (the one-thread design ran 128 chains: 194,040 x
// 128 + 127 x 900 products a row).
//
// Bound on this card: operations, 0.00002 ms a row at the int32 rate; the
// bytes (a row's window sums, 1.3 MB) take 0.4 us. Neither is what limits
// it at one row: the chain is 252 doublings and 64 additions that depend
// on each other, two rounds of one field product each, 632 dependent
// rounds whatever the card's width. chip_smoke.py prints that chain floor
// beside the bound.
#include "msm_layout.cuh"
#include "quad25519.cuh"

namespace qq {

constexpr int TAIL_TOTAL_INTS = 4 * NL;  // one cached window total

// The fold of one (row, window) in the kernel's order, on the host: w*
// point at lane 0 of the window's sums [NL, MSM_LANES].
inline ge msm_fold_lanes(const int32_t* wx, const int32_t* wy, const int32_t* wz,
                         const int32_t* wt) {
  constexpr int H = MSM_LANES / 2;
  ge acc[H];
  for (int j = 0; j < H; ++j)
    acc[j] = ge_add<true>(ge_load_strided(wx, wy, wz, wt, j, MSM_LANES),
                          ge_load_strided(wx, wy, wz, wt, j + H, MSM_LANES));
  for (int step = H / 2; step >= 1; step >>= 1)
    for (int j = 0; j < step; ++j) acc[j] = ge_add<true>(acc[j], acc[j + step]);
  return acc[0];
}

// One row on the host: the 64 folds, then the chain with the quad's four
// roles run in turn. w* point at the row's sums [64, NL, MSM_LANES].
inline ge msm_tail_row(const int32_t* wx, const int32_t* wy, const int32_t* wz,
                       const int32_t* wt) {
  constexpr long kWindow = (long)NL * MSM_LANES;
  fe totals[MSM_WINDOWS][4];
  for (int w = 0; w < MSM_WINDOWS; ++w)
    ge_to_cached(msm_fold_lanes(wx + w * kWindow, wy + w * kWindow, wz + w * kWindow,
                                wt + w * kWindow),
                 totals[w]);
  const QuadHost q;
  const QuadHost::V acc = quad_horner16(q, MSM_WINDOWS - 1, [&](int w) {
    return QuadHost::V{{totals[w][0], totals[w][1], totals[w][2], totals[w][3]}};
  });
  return ge{acc.c[0], acc.c[1], acc.c[2], acc.c[3]};
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(qq::MSM_LANES)
msm_tail_kernel(const int32_t* __restrict__ wx, const int32_t* __restrict__ wy,
                const int32_t* __restrict__ wz, const int32_t* __restrict__ wt,
                int32_t* totals, unsigned* done, int32_t* __restrict__ ox,
                int32_t* __restrict__ oy, int32_t* __restrict__ oz, int32_t* __restrict__ ot) {
  using qq::QuadShfl;
  constexpr int NL = qq::NL, W = qq::MSM_WINDOWS, L = qq::MSM_LANES, TOT = qq::TAIL_TOTAL_INTS;
  constexpr int H = L / 2, C = NL * H;  // C: one coordinate of the tree's points
  // the tree's points, then (in a row's last block) the row's cached totals
  __shared__ int32_t s_pts[4 * C];
  static_assert(W * TOT <= 4 * C, "a row's totals fit in the tree's space");
  __shared__ bool last;
  int32_t *sx = s_pts, *sy = s_pts + C, *sz = s_pts + 2 * C, *st = s_pts + 3 * C;
  const int w = blockIdx.x % W, r = blockIdx.x / W, j = threadIdx.x;
  const long off = ((long)r * W + w) * NL * L + j;
  qq::ge acc;
  if (j < H) {
    acc = qq::ge_add<true>(qq::ge_load_strided(wx, wy, wz, wt, off, L),
                           qq::ge_load_strided(wx, wy, wz, wt, off + H, L));
  }
  // lane j takes lane j + step, the upper half first (the plain version adds
  // the same pairs in the same order)
  for (int step = H / 2; step >= 1; step >>= 1) {
    if (j >= step && j < 2 * step) qq::ge_store_strided(sx, sy, sz, st, j, H, acc);
    __syncthreads();
    if (j < step) acc = qq::ge_add<true>(acc, qq::ge_load_strided(sx, sy, sz, st, j + step, H));
    __syncthreads();
  }
  const long row = (long)r * W * TOT;
  if (j == 0) {
    qq::fe c[4];
    qq::ge_to_cached(acc, c);
    for (int k = 0; k < 4; ++k) qq::fe_store(totals + row + w * TOT, k, c[k]);
    __threadfence();  // the total is visible before the count says so
    last = atomicAdd(done + r, 1u) == W - 1;
  }
  __syncthreads();
  if (!last) return;
  // the row's last block: every window total is written; the block copies
  // them to shared memory, so the chain waits for no load from L2
  __threadfence();
  for (int i = j; i < W * TOT; i += L) s_pts[i] = __ldcg(totals + row + i);
  __syncthreads();
  if (j >= 4) return;
  const QuadShfl q{j, 0xfu};
  const QuadShfl::V out = qq::quad_horner16(q, W - 1, [&](int w2) {
    return QuadShfl::V{qq::fe_load(s_pts + w2 * TOT, j)};
  });
  int32_t* o = j == 0 ? ox : j == 1 ? oy : j == 2 ? oz : ot;
  qq::fe_store(o, r, out.c);
}

}  // namespace

// w* int32 [rows, 64, 10, lanes]; totals int32 [rows, 64, 4, 10] scratch;
// done uint32 [rows] zeros; o* int32 [rows, 10]. Returns cudaGetLastError(),
// or cudaErrorInvalidValue if lanes is not MSM_LANES
extern "C" int qq_msm_tail(const void* wx, const void* wy, const void* wz, const void* wt,
                           void* totals, void* done, void* ox, void* oy, void* oz, void* ot,
                           int rows, int lanes, void* stream) {
  if (lanes != qq::MSM_LANES) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    msm_tail_kernel<<<rows * qq::MSM_WINDOWS, qq::MSM_LANES, 0, (cudaStream_t)stream>>>(
        (const int32_t*)wx, (const int32_t*)wy, (const int32_t*)wz, (const int32_t*)wt,
        (int32_t*)totals, (unsigned*)done, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
        (int32_t*)ot);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
