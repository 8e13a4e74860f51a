// Variable-base scalar multiplication s*P, four threads a lane.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _scalar_mul_kernel (with its
// wrappers scalar_mul_lm / scalar_mul_pallas). Plain version:
// quisquis_tpu_torch/ops/point.py scalar_mul; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_point.py scalar_mul.
//
// Per lane, a quad of four threads (quad25519.cuh: thread r holds
// coordinate r, each point operation is two rounds of one field product
// per thread, values exchanged by __shfl_sync):
// - the 64 nibbles (0..15, any 256-bit value) recoded in the kernel to 65
//   signed digits in -8..8 (signed_radix16, branch-free);
// - the cached multiples 1..8 of P: 4 doublings, 3 additions, 8 cached
//   conversions (one multiply by 2d each);
// - from the identity, 65 additions of the selected entry and 64 x 4
//   doublings (3 without T, 1 with T): Horner's rule in radix 16.
// A doubling is 4 squares and 3 or 4 multiplies, an addition 8 multiplies
// (2d T2 is in the table), so a lane does 192 x 3 + 68 x 4 + 65 x 8 + 3 x 8
// + 8 = 1,400 multiplies and 1,040 squares (2,440; the old one-thread
// kernel did 2,513).
//
// Bound on this card: operations. A multiply is 100 32x32->64 limb products
// and a square 55 (field25519.cuh), so a lane needs 1,400 x 100 + 1,040 x
// 55 = 197,200 products, 3.23e9 at N = 16,384 against 132 SMs x 64 int32
// lanes x the SM clock. The roles also repeat the cheap additions of
// round 2 (4 a thread) and exchange 60 limbs a point operation; neither is
// counted. The bytes (nibbles, four input and four output coordinates:
// 416 B a lane) are three orders of magnitude below.
//
// Design. The first port ran one thread a lane with a 16-entry table in
// local memory: 255 registers, 2,252 bytes of spills, ~124 threads an SM at
// N = 16,384, so every dependent multiply-add stalled in the open. Here:
// - four threads a lane, each holding one field element, not four: ~16
//   warps an SM at N = 16,384 instead of ~4, and no spills;
// - signed digits, so the table is 1..8 P (half the build and the scan);
// - the table in shared memory, 8 x 4 x 10 int32 a lane; a block is 32
//   lanes (128 threads) and 44,064 bytes of static shared memory, so four
//   blocks fit on an SM. Entry k, coordinate r, limb i of the block's lane
//   j lies at ((k-1) x 4 + r) x kStride + i x 32 + j; kStride = 328 puts
//   the 32 threads of a warp (8 lanes x 4 roles) on 32 distinct banks.
//   Each thread reads back only the coordinate it wrote, so no barrier.
// Constant time: every window reads all 8 entries of the thread's
// coordinate and keeps the match by mask; the sign is a masked swap and a
// masked negation; no address and no branch depends on a digit. Threads of
// lanes past n compute on lane n-1 (every lane of a warp takes part in
// each shuffle) and store nothing.
//
// ptxas (-Xptxas -v for sm_90a; chip_smoke.py phase 2 prints it): see
// PERF.md. __launch_bounds__ is the launched block, 128 threads, and four
// blocks an SM.
#include "quad25519.cuh"

namespace qq {

constexpr int SM_LANES = 32;                  // lanes a block (4 threads each)
constexpr int SM_STRIDE = NL * SM_LANES + 8;  // one coordinate of one entry

// The kernel's arithmetic for one lane with its four roles run in turn on
// the host (tests/test_torch_csrc_host.py): digits = 64 little-endian nibbles.
inline ge scalar_mul_lane(const int32_t* nibbles, const ge& p) {
  const QuadHost q;
  int8_t digits[SIGNED_DIGITS];
  signed_radix16(nibbles, digits, 1);
  QuadHost::V table[8];
  const QuadHost::V pv{{p.x, p.y, p.z, p.t}};
  quad_table8(q, pv, [&](int r, int k, const fe& v) { table[k - 1].at(r) = v; });
  const QuadHost::V acc = quad_horner16(q, SIGNED_DIGITS - 1, [&](int w) {
    return quad_select(q, digits[w], [&](int r, int k) { return table[k - 1].at(r); });
  });
  return ge{acc.c[0], acc.c[1], acc.c[2], acc.c[3]};
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 4 * qq::SM_LANES;
constexpr int kBlocksPerSM = 4;

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
scalar_mul_kernel(const int32_t* __restrict__ nib, const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py, const int32_t* __restrict__ pz,
                  const int32_t* __restrict__ pt, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  int32_t* __restrict__ ot, int n) {
  using qq::QuadShfl;
  constexpr int L = qq::SM_LANES, S = qq::SM_STRIDE;
  __shared__ int32_t s_tab[8 * 4 * S];
  __shared__ int8_t s_dig[qq::SIGNED_DIGITS * L];
  const int role = threadIdx.x & 3, slot = threadIdx.x >> 2;
  const long lane = (long)blockIdx.x * L + slot;
  const long src = lane < n ? lane : n - 1;
  const QuadShfl q{role, 0xffffffffu};
  if (role == 0) qq::signed_radix16(nib + src * 64, s_dig + slot, L);
  __syncwarp();
  const int32_t* in = role == 0 ? px : role == 1 ? py : role == 2 ? pz : pt;
  const QuadShfl::V p{qq::fe_load(in, src)};
  int32_t* tab = s_tab + role * S + slot;  // entry k at tab + (k - 1) * 4 * S
  qq::quad_table8(q, p, [&](int, int k, const qq::fe& v) {
    qq::fe_store_strided(tab + (k - 1) * 4 * S, L, v);
  });
  const QuadShfl::V acc = qq::quad_horner16(q, qq::SIGNED_DIGITS - 1, [&](int w) {
    return qq::quad_select(q, s_dig[w * L + slot], [&](int, int k) {
      return qq::fe_load_strided(tab + (k - 1) * 4 * S, L);
    });
  });
  int32_t* out = role == 0 ? ox : role == 1 ? oy : role == 2 ? oz : ot;
  if (lane < n) qq::fe_store(out, lane, acc.c);
}

}  // namespace

// nib int32 [n, 64]; p* and o* int32 [n, 10]; returns cudaGetLastError()
extern "C" int qq_scalar_mul(const void* nib, const void* px, const void* py, const void* pz,
                             const void* pt, void* ox, void* oy, void* oz, void* ot, int n,
                             void* stream) {
  if (n > 0) {
    const int blocks = (n + qq::SM_LANES - 1) / qq::SM_LANES;
    scalar_mul_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nib, (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz,
        (const int32_t*)pt, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
