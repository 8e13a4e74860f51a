// Second stage of the multiscalar multiplication: the window sums. For each
// row r, window w and lane j, the point
//     W[r, w, j] = sum over the row's points i with i % MSM_LANES == j
//                  of digit[i, w] * P_i,
// each term picked from msm_table.cu's table of P_i.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _msm_acc_kernel (reached from
// msm_window_sums_lm / msm_pallas / msm_rows_pallas). Plain version:
// quisquis_tpu_torch/ops/msm_plain.py msm_window_sums; wrapper and launch
// counter: quisquis_tpu_torch/ops/cuda_point.py msm_window_sums.
//
// The TPU kernel walks point tiles in a sequential grid and keeps a group of
// eight windows' accumulators in a revisited VMEM block. None of that is
// carried over. Here a block of 256 threads owns L neighbouring lanes of one
// row for all 64 windows, in S slices (L x S = 4; msm_slices picks S from
// the tiles a lane has: 4 from 8 tiles up, 2 from 4, else 1; 4 at the
// verifier's one row of 37 tiles, 1 at R = 8 rows of 2). Thread (s, w, g)
// is window w of lane j0 + g in slice s; slice s sums the lane's tiles s,
// s + S, ... At each step a slice copies its L points' tables (16 entries
// of 4 x 10 limbs each) once into shared memory (cp.async, two stages; the
// L neighbouring lanes' words are contiguous in memory), and its window
// threads scan them there. The S partial sums of each window are then
// folded in shared memory in a fixed tree (slice s takes slice s + step,
// step = S/2 .. 1), and slice 0 stores the window sums, L neighbouring
// lanes together. The layouts of msm_layout.cuh do not change.
//
// Work the function needs, per row: per point and window one table lookup
// and one addition with T (9 field multiplies, 900 limb products): 64 n_row
// x 900 products. Bound on this card: operations (at one row of 4,736
// points: 2.7e8 products, 16.3 us at the int32 rate; the digits, the table
// and the sums once are 15 MB, 4.5 us). The schedule adds, per window and
// lane, S - 1 fold additions: 64 x 128 x 3 at one row (S = 4), 8.1% more
// products, which the bound does not count.
//
// What held the first design back (one thread a (row, window, lane),
// looping over the lane's tiles; NVIDIA H100 80GB HBM3, 700 W, 0.285 ms at
// one row of 4,736 points against a 0.016 ms bound): 64 blocks of 128
// threads at one row, so 64 of 132 SMs with 4 warps each, each thread
// walking 37 dependent additions; 186 registers; and every window's block
// scanned every point's whole table from L2, 64 x 4,736 x 2,560 B = 776 MB
// of L2 reads for a 12.1 MB table. This design, at one row: 128 blocks of
// 256 threads (one an SM, 8 warps; 10 additions and a 2-level fold on the
// critical path), each point's table read from L2 once (by one block), and
// the scan's loads are shared-memory loads that the 32/L windows of a warp
// share (a broadcast; the L lanes' tables sit on distinct banks). Each
// coordinate of the entry is selected just before the addition uses it
// (ge_add_select16), and indices are 32-bit: both cut the registers live.
// Blocks of 512 threads (L x S = 8, 16 warps an SM at 128 registers)
// spilled 120-276 bytes and were slower at one row (PERF.md).
//
// Constant time: the entry is selected by the branch-free scan over all 16
// entries, so no address depends on a digit; the branches depend only on
// the shapes. The range verifier's scalars are public, but the same kernel
// will carry the provers' secret scalars in rows mode; an indexed load for
// public scalars would be a later choice, measured and documented.
//
// ptxas (-Xptxas -v for sm_90a, CUDA 12.8; chip_smoke.py phase 2 prints
// it): 220 registers, no stack, no spills, 20,608 bytes of shared memory;
// one block (8 warps) an SM. __launch_bounds__ is the launched block, 256
// threads.
#include "msm_layout.cuh"
#include "quad25519.cuh"

namespace qq {

constexpr int MSM_MAX_SLICES = 4;
constexpr int MSM_POINT_INTS = 16 * 4 * NL;  // one point's table: [entry][coord][limb]

// Slices of a lane's tiles: the largest power of two S <= MSM_MAX_SLICES
// with 2 S <= tiles (a block holds MSM_MAX_SLICES / S lanes). A slice of
// one tile would cost a fold addition for each addition it takes off the
// chain. S depends on the tiles alone, so a row's sums do not depend on
// the other rows of the call.
QQ_HD int msm_slices(int tiles) {
  int s = 1;
  while (4 * s <= tiles && 2 * s <= MSM_MAX_SLICES) s <<= 1;
  return s;
}

// p + (entry `digit` of a point's 16-entry table), point25519.cuh's
// ge_add_lazy with each coordinate of the entry selected just before it is
// used, by a scan of all 16 entries and a masked move; entry(k, c) is
// coordinate c of entry k
QQ_FUNCTOR_TEMPLATE
template <class Entry>
QQ_HD ge ge_add_select16(const ge& p, int32_t digit, const Entry& entry) {
  return ge_add_lazy<true>(p, [&](int c) {
    fe v = entry(0, c);
    QQ_UNROLL
    for (int k = 1; k < 16; ++k) fe_cmov(v, entry(k, c), eq_mask(k, digit));
    return v;
  });
}

// The fold of S partial sums (slice s takes slice s + step), on the host
QQ_HD ge msm_fold_slices(ge* acc, int slices) {
  for (int step = slices / 2; step >= 1; step >>= 1)
    for (int s = 0; s < step; ++s) acc[s] = ge_add<true>(acc[s], acc[s + step]);
  return acc[0];
}

// One window of one lane on the host, slices run in turn: digits points at
// this window's row of the [64, n] digit array, first is the lane's point
// in the row's first tile
inline ge msm_acc_lane(const int32_t* digits, const int32_t* tx, const int32_t* ty,
                       const int32_t* tz, const int32_t* tt, long first, int tiles, int slices,
                       long n) {
  const int32_t* coord[4] = {tx, ty, tz, tt};
  ge acc[MSM_MAX_SLICES];
  for (int s = 0; s < slices; ++s) {
    acc[s] = ge_identity();
    for (int t = s; t < tiles; t += slices) {
      const long i = first + (long)t * MSM_LANES;
      acc[s] = ge_add_select16(acc[s], digits[i], [&](int k, int c) {
        return fe_load_strided(coord[c] + (long)k * NL * n + i, n);
      });
    }
  }
  return msm_fold_slices(acc, slices);
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = qq::MSM_WINDOWS * qq::MSM_MAX_SLICES;  // 256
// one lane's staged table: [entry][coord][limb], padded so that the L
// lanes' tables start on distinct banks (4 apart)
constexpr int kLaneInts = qq::MSM_POINT_INTS + 4;
// staging: two stages of L tables a slice (S x L = 4); reused by the fold
constexpr int kSharedInts = 2 * qq::MSM_MAX_SLICES * kLaneInts;
// the fold's points at one level: S/2 slices x 64 windows x L lanes, limb-major
constexpr int kFoldInts = 4 * qq::NL * kThreads / 2;
static_assert(kSharedInts >= kFoldInts, "the fold fits the staging buffers");

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 64 L threads of one slice
__device__ __forceinline__ void slice_sync(int s, int lanes) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + s), "r"(qq::MSM_WINDOWS * lanes) : "memory");
}

// The tables of points i0 .. i0 + L - 1 into buf (lane g at g x kLaneInts);
// thread (w, g) copies words w, w + 64, ... of lane g's table
__device__ __forceinline__ void stage_points(int32_t* buf, const int32_t* tx, const int32_t* ty,
                                             const int32_t* tz, const int32_t* tt, int i0, int n,
                                             int w, int g) {
  QQ_UNROLL
  for (int m = 0; m < qq::MSM_POINT_INTS / qq::MSM_WINDOWS; ++m) {
    const int q = w + m * qq::MSM_WINDOWS;
    const int k = q / (4 * qq::NL), c = (q / qq::NL) % 4, l = q % qq::NL;
    const int32_t* coord = c == 0 ? tx : c == 1 ? ty : c == 2 ? tz : tt;
    cp_async4(buf + g * kLaneInts + q, coord + (k * qq::NL + l) * n + i0 + g);
  }
}

// grid (MSM_LANES / L lane groups, rows), 256 threads: thread
// g + L (w + 64 s) is lane g of the group, window w, slice s. Indices are
// 32-bit (the launcher checks 160 n < 2^31): 64-bit ones spilled.
__global__ void __launch_bounds__(kThreads)
msm_acc_kernel(const int32_t* __restrict__ digits, const int32_t* __restrict__ tx,
               const int32_t* __restrict__ ty, const int32_t* __restrict__ tz,
               const int32_t* __restrict__ tt, int32_t* __restrict__ wx,
               int32_t* __restrict__ wy, int32_t* __restrict__ wz, int32_t* __restrict__ wt,
               int tiles, int slices) {
  __shared__ __align__(16) int32_t smem[kSharedInts];
  const int lanes = qq::MSM_MAX_SLICES / slices;
  const int g = threadIdx.x % lanes, w = (threadIdx.x / lanes) % qq::MSM_WINDOWS;
  const int s = threadIdx.x / (lanes * qq::MSM_WINDOWS);
  const int j0 = blockIdx.x * lanes, r = blockIdx.y;
  const int n = gridDim.y * tiles * qq::MSM_LANES;
  const int first = r * tiles * qq::MSM_LANES + j0;  // the group's first point
  const int dig = w * n + g;                          // this thread's digits
  // stage b of this slice
  auto stage = [&](int b) { return smem + (b * slices + s) * lanes * kLaneInts; };
  const int steps = (tiles + slices - 1) / slices;

  qq::ge acc = qq::ge_identity();
  if (s < tiles) stage_points(stage(0), tx, ty, tz, tt, first + s * qq::MSM_LANES, n, w, g);
  cp_async_commit();
  for (int u = 0; u < steps; ++u) {
    const int t = u * slices + s, t_next = t + slices;
    if (t_next < tiles)
      stage_points(stage((u + 1) & 1), tx, ty, tz, tt, first + t_next * qq::MSM_LANES, n, w, g);
    cp_async_commit();
    const int32_t d = t < tiles ? digits[dig + first + t * qq::MSM_LANES] : 0;
    cp_async_wait<1>();
    slice_sync(s, lanes);
    if (t < tiles) {
      const int32_t* p = stage(u & 1) + g * kLaneInts;
      acc = qq::ge_add_select16(acc, d, [&](int k, int c) {
        return qq::fe_load(p + k * 4 * qq::NL, c);
      });
    }
    slice_sync(s, lanes);  // stage u & 1 is refilled at step u + 1
  }
  cp_async_wait<0>();
  __syncthreads();
  // the fold: slice s >= step hands its sums to slice s - step; point
  // (s - step, w, g) at index ((s - step) x 64 + w) x L + g of each limb row
  const int slot = threadIdx.x % (lanes * qq::MSM_WINDOWS);
  constexpr int kRow = kThreads / 2;  // one limb of every fold point
  for (int step = slices / 2; step >= 1; step >>= 1) {
    int32_t* f = smem + (s - step) * lanes * qq::MSM_WINDOWS + slot;
    if (s >= step && s < 2 * step)
      qq::ge_store_strided(f, f + qq::NL * kRow, f + 2 * qq::NL * kRow, f + 3 * qq::NL * kRow, 0,
                           kRow, acc);
    __syncthreads();
    const int32_t* h = smem + s * lanes * qq::MSM_WINDOWS + slot;
    if (s < step)
      acc = qq::ge_add_lazy<true>(
          acc, [&](int c) { return qq::fe_load_strided(h + c * qq::NL * kRow, kRow); });
    __syncthreads();
  }
  if (s == 0) {
    const int off = (r * qq::MSM_WINDOWS + w) * qq::NL * qq::MSM_LANES + j0 + g;
    qq::ge_store_strided(wx, wy, wz, wt, off, qq::MSM_LANES, acc);
  }
}

}  // namespace

// digits int32 [64, n], t* int32 [16, 10, n], w* int32 [rows, 64, 10, lanes],
// n = rows * tiles * lanes; returns cudaGetLastError(), or
// cudaErrorInvalidValue if lanes is not this file's MSM_LANES or an index
// does not fit an int
extern "C" int qq_msm_acc(const void* digits, const void* tx, const void* ty, const void* tz,
                          const void* tt, void* wx, void* wy, void* wz, void* wt, int rows,
                          int tiles, int lanes, void* stream) {
  // 32-bit indices: every table word (160 n) and sum word (rows x 81,920)
  const long words =
      (long)rows * qq::MSM_LANES * (qq::MSM_POINT_INTS / 4) * (tiles > 4 ? tiles : 4);
  if (lanes != qq::MSM_LANES || tiles < 0 || words >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    const int slices = qq::msm_slices(tiles);
    const dim3 grid(qq::MSM_LANES * slices / qq::MSM_MAX_SLICES, rows);
    msm_acc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)digits, (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)tz,
        (const int32_t*)tt, (int32_t*)wx, (int32_t*)wy, (int32_t*)wz, (int32_t*)wt, tiles,
        slices);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
