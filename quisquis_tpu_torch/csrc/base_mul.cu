// Fixed-base scalar multiplication s*B, four threads a lane.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _base_mul_kernel (with its table
// _niels_base_table and wrappers base_mul_lm / base_mul_pallas). Plain
// version: quisquis_tpu_torch/ops/point.py base_mul; wrapper and launch
// counter: quisquis_tpu_torch/ops/cuda_point.py base_mul.
//
// s*B = sum_w (16^w e_w) B over 65 signed digits e_w in -8..8 (the 64
// nibbles recoded in the kernel by quad25519.cuh signed_radix16, so any
// 256-bit value works, as in the JAX function). The table (built once on
// the host by point.niels_base_table_np, uploaded once per process) holds
// (16^w k) B for w = 0..64 and k = 1..8 in affine niels form (y+x, y-x,
// 2d x y), one entry 32 int32 (30 limbs and 2 of padding, so an entry is
// eight aligned 16-byte loads): [65][8][32], 66,560 bytes. Digit 0 is the
// identity (1, 1, 0), kept by mask; a negative digit swaps y+x with y-x and
// negates 2d x y, by mask.
//
// There are no doublings: the 65 additions are independent terms of one
// sum. Thread t of a lane's four (BM_PARTS) adds windows t, t+4, ... from
// the identity (17 or 16 mixed additions). The four partial points then
// go through shared memory to one quad a lane (quad25519.cuh: four threads,
// one coordinate each, QuadShfl), which folds them in a fixed tree of
// additions of the cached form (part t takes part t + 2, then part 0 takes
// part 1): 3 additions of 3 rounds of one field product a thread.
//
// Work the function needs, a lane: 64 mixed additions of 7 field
// multiplies, 448 multiplies, 44,800 32x32->64 limb products
// (field25519.cuh fe_mul; no squares), 7.3e8 at N = 16,384. Bound on this
// card: operations; the bytes (nibbles in, four coordinates out, the table
// once) are far below that. The schedule's overhead, which the bound does
// not count: the 65th window's addition (7 multiplies) and the fold's 3
// additions with their cached forms (27): 482 multiplies a lane, 7.6% more.
//
// What held the first design back (one thread a lane, unsigned digits, a
// 16-entry table [64][16][3][10] read through L1; NVIDIA H100 80GB HBM3,
// 700 W, 0.345 ms at N = 16,384 against a 0.044 ms bound): 128 threads a
// block and 128 blocks, about 4 warps an SM, one a scheduler, so every
// dependent multiply-add chain stalled in the open; and the constant-time
// scan read all 16 entries a window, 480 loads and 450 masked moves beside
// 700 IMAD.WIDE. This design:
// - four threads a lane, no exchange inside the loop: 16 warps an SM at
//   N = 16,384 (blocks of 64 lanes, 256 threads, two an SM, one wave);
// - signed digits: 8 entries a window, half the scan, and 128-bit loads;
// - the table in shared memory, copied once a block (66,560 bytes; 70,720
//   bytes of dynamic shared memory a block with the digits; the parts'
//   sums take the table's place for the fold);
//   the four parts of a lane sit in four pairs of warps (warps 2t and
//   2t + 1 are part t of the block's 64 lanes), so the 32 threads of a
//   warp read the same window at each step: every table load is a
//   broadcast. The same table read through L1 (__ldg, 32 lanes a block,
//   four blocks an SM) was 4% slower (PERF.md).
// Constant time: every window reads all 8 entries and keeps the match by
// mask; the sign is a masked swap and a masked negation; no address and no
// branch depends on a digit. Threads of lanes past n compute on lane n-1
// (they take part in the barriers) and store nothing.
//
// ptxas (-Xptxas -v for sm_90a, CUDA 12.8; chip_smoke.py phase 2 prints
// it): 128 registers, no stack, no spills, 70,720 bytes of dynamic shared
// memory. A fold of one-thread full additions (ge_add) on parts 0 and 1
// spilled 16 bytes at 128 registers and was up to 1% slower (PERF.md). The
// L1-table build at three blocks an SM (168 registers, no spill) was 5%
// slower than at four. __launch_bounds__ is the launched block, 256
// threads, and two blocks an SM (at most 128 registers).
#include "quad25519.cuh"

namespace qq {

constexpr int BM_PARTS = 4;                       // threads a lane
constexpr int BM_WINDOWS = SIGNED_DIGITS;         // 65
constexpr int BM_ENTRY_INTS = 32;                 // y+x, y-x, 2dxy, padding
constexpr int BM_WINDOW_INTS = 8 * BM_ENTRY_INTS;

// one entry: eight 16-byte loads (from shared memory on the card)
QQ_HD ge_niels niels_load(const int32_t* e) {
  int32_t v[BM_ENTRY_INTS];
#ifdef __CUDA_ARCH__
  QQ_UNROLL
  for (int q = 0; q < BM_ENTRY_INTS / 4; ++q) {
    const int4 x = reinterpret_cast<const int4*>(e)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
#else
  for (int q = 0; q < BM_ENTRY_INTS; ++q) v[q] = e[q];
#endif
  ge_niels r;
  QQ_UNROLL
  for (int i = 0; i < NL; ++i) {
    r.yx.v[i] = v[i];
    r.ymx.v[i] = v[NL + i];
    r.td2.v[i] = v[2 * NL + i];
  }
  return r;
}

// Entry d of a window (d in -8..8): all 8 entries read, the match kept by
// mask, then the masked negation.
QQ_HD ge_niels base_select(const int32_t* window, int32_t d) {
  const int32_t neg = d >> 31;
  const int32_t mag = (d ^ neg) - neg;
  ge_niels r{fe_one(), fe_one(), fe_zero()};
  QQ_UNROLL
  for (int k = 1; k <= 8; ++k) {
    const ge_niels e = niels_load(window + (k - 1) * BM_ENTRY_INTS);
    const int32_t m = eq_mask(k, mag);
    fe_cmov(r.yx, e.yx, m);
    fe_cmov(r.ymx, e.ymx, m);
    fe_cmov(r.td2, e.td2, m);
  }
  const fe yx = r.yx;
  fe_cmov(r.yx, r.ymx, neg);
  fe_cmov(r.ymx, yx, neg);
  fe_cmov(r.td2, fe_neg(r.td2), neg);
  return r;
}

// Part `part` of a lane: windows part, part + BM_PARTS, ... added to the
// identity. digit(w) is the lane's signed digit w.
QQ_FUNCTOR_TEMPLATE
template <class Digit>
QQ_HD ge base_mul_part(const int32_t* table, int part, const Digit& digit) {
  ge acc = ge_identity();
  QQ_NOUNROLL
  for (int w = part; w < BM_WINDOWS; w += BM_PARTS) {
    acc = ge_add_niels<true>(acc, base_select(table + w * BM_WINDOW_INTS, digit(w)));
  }
  return acc;
}

// The fold of the parts' sums (part t takes part t + step, step =
// BM_PARTS/2 .. 1) by quad25519.cuh's additions of the cached form: one
// quad a lane, role r holding coordinate r of every part's sum
template <class Q>
QQ_HD typename Q::V base_mul_fold(const Q& q, typename Q::V* acc) {
  QQ_UNROLL
  for (int step = BM_PARTS / 2; step >= 1; step >>= 1) {
    QQ_UNROLL
    for (int t = 0; t < step; ++t) quad_add(q, acc[t], quad_to_cached(q, acc[t + step]));
  }
  return acc[0];
}

// The kernel's arithmetic for one lane on the host
// (tests/test_torch_csrc_host.py): its four parts run in turn, then the
// fold with the quad's roles run in turn (QuadHost).
inline ge base_mul_lane(const int32_t* table, const int32_t* nibbles) {
  int8_t digits[SIGNED_DIGITS];
  signed_radix16(nibbles, digits, 1);
  QuadHost::V acc[BM_PARTS];
  for (int t = 0; t < BM_PARTS; ++t) {
    const ge p = base_mul_part(table, t, [&](int w) { return (int32_t)digits[w]; });
    acc[t] = QuadHost::V{{p.x, p.y, p.z, p.t}};
  }
  const QuadHost::V r = base_mul_fold(QuadHost{}, acc);
  return ge{r.c[0], r.c[1], r.c[2], r.c[3]};
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kLanes = 64;                         // lanes a block
constexpr int kThreads = qq::BM_PARTS * kLanes;    // warps 2t, 2t + 1: part t
constexpr int kBlocksPerSM = 2;
constexpr int kTableInts = qq::BM_WINDOWS * qq::BM_WINDOW_INTS;
// the parts' sums, in the table's place once the windows are done:
// coordinate r of part t at (4 t + r) x kCoordInts, limb-major; the 8 ints
// of padding put a quad's four roles on distinct banks
constexpr int kCoordInts = qq::NL * kLanes + 8;
static_assert(4 * qq::BM_PARTS * kCoordInts <= kTableInts, "the sums fit the table's place");

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
base_mul_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ nib,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, int32_t* __restrict__ ot, int n) {
  extern __shared__ __align__(16) int32_t dyn[];
  int32_t* s_tab = dyn;
  int8_t* s_dig = reinterpret_cast<int8_t*>(dyn + kTableInts);
  for (int q = threadIdx.x; q < kTableInts / 4; q += kThreads)
    reinterpret_cast<int4*>(s_tab)[q] = __ldg(reinterpret_cast<const int4*>(table) + q);
  const int part = threadIdx.x / kLanes, slot = threadIdx.x % kLanes;
  if (part == 0)
    qq::signed_radix16(nib + min((int)blockIdx.x * kLanes + slot, n - 1) * 64, s_dig + slot,
                       kLanes);
  __syncthreads();
  const qq::ge acc = qq::base_mul_part(
      s_tab, part, [&](int w) { return (int32_t)s_dig[w * kLanes + slot]; });
  __syncthreads();  // every part is done with the table
  int32_t* mine = s_tab + 4 * part * kCoordInts + slot;
  qq::fe_store_strided(mine, kLanes, acc.x);
  qq::fe_store_strided(mine + kCoordInts, kLanes, acc.y);
  qq::fe_store_strided(mine + 2 * kCoordInts, kLanes, acc.z);
  qq::fe_store_strided(mine + 3 * kCoordInts, kLanes, acc.t);
  __syncthreads();
  // the fold: threads 4l .. 4l + 3 are the quad of the block's lane l
  const int l = threadIdx.x / 4, role = threadIdx.x % 4;
  const qq::QuadShfl q{role, 0xffffffffu};
  qq::QuadShfl::V sums[qq::BM_PARTS];
  QQ_UNROLL
  for (int t = 0; t < qq::BM_PARTS; ++t)
    sums[t].c = qq::fe_load_strided(s_tab + (4 * t + role) * kCoordInts + l, kLanes);
  const qq::QuadShfl::V total = qq::base_mul_fold(q, sums);
  const int lane = blockIdx.x * kLanes + l;
  int32_t* out = role == 0 ? ox : role == 1 ? oy : role == 2 ? oz : ot;
  if (lane < n) qq::fe_store(out, lane, total.c);
}

}  // namespace

// table int32 [65, 8, 32]; nib int32 [n, 64]; o* int32 [n, 10];
// returns cudaGetLastError()
extern "C" int qq_base_mul(const void* table, const void* nib, void* ox, void* oy, void* oz,
                           void* ot, int n, void* stream) {
  constexpr int kSmem = kTableInts * 4 + qq::SIGNED_DIGITS * kLanes;
  if (n > 0) {
    // dynamic shared memory above 48 KB only on request, once a device
    static std::atomic<unsigned long long> asked{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;  // 0: ask at every launch
    if (!(asked.load() & bit)) {
      err = cudaFuncSetAttribute(base_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
      if (err != cudaSuccess) return (int)err;
      asked.fetch_or(bit);
    }
    const int blocks = (n + kLanes - 1) / kLanes;
    base_mul_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
        (const int32_t*)table, (const int32_t*)nib, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
        (int32_t*)ot, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
