// First stage of the multiscalar multiplication: per point P its 16 small
// multiples 0*P .. 15*P, four quads (16 threads) a point.
//
// Replaces: quisquis_tpu/ops/pallas_point.py _msm_table_kernel (reached from
// msm_window_sums_lm / msm_pallas / msm_rows_pallas). Plain version:
// quisquis_tpu_torch/ops/msm.py msm_table; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_point.py msm_table.
//
// Entries k are double(k/2) for even k and (k-1) + P for odd k (the TPU
// kernel's schedule; plain version: window_table in
// quisquis_tpu_torch/ops/point.py): 7 doublings and 7 additions, 91 field
// multiplies and 28 squares a point, 10,640 32x32->64 limb products. It
// reads 160 bytes and writes the table, 16 x 4 x 10 x 4 = 2,560 bytes.
// Bound on this card: bytes. At n = 4,736 points (the range verifier's
// 4,610 padded to whole lanes) the table is 12.1 MB, 3.8 us at 3.35 TB/s,
// against 5.0e7 products, 3.0 us at the int32 rate.
//
// What held the first port back at that size: one thread a point, so 37
// blocks of 128 threads, 37 SMs with 4 warps each, every thread walking the
// 14 operations in sequence; and the whole table kept in a local array
// (a 2,560-byte stack) and written only at the end, so the 12.1 MB went
// through local memory before it reached its place.
//
// This design. A point is held by quads (quad25519.cuh: four threads, one
// coordinate each, two rounds of one field product a point operation,
// QuadShfl), and its 14 operations are split into four chains, one a quad,
// each a single running multiple that is doubled or has P added:
//   part 0:  2, 3, 6, 7, 14, 15             (D A D A D A)
//   part 1: (2), 4, 5, 10, 11               (D D A D A)
//   part 2: (2, 3, 6), 12, 13               (D A D D A)
//   part 3: (2, 4), 8, 9, and entries 0, 1  (D D D A)
// The entries in brackets are recomputed, not shared: a doubling of the
// same limbs gives the same limbs, so no barrier or shared memory is
// needed. That is 20 point operations a point instead of 14, six deep
// instead of 14 (the schedule's dependency graph is six deep: 2, 3, 6, 7,
// 14, 15). A block runs one part (blockIdx.y) for 32 points, 8 a warp, so
// the part is uniform over the block: its quads run the same operation at
// each step, and the compiler sees every shuffle on a converged warp (with
// the part taken from the warp's index instead, it wrapped each of the 740
// shuffles in WARPSYNC.COLLECTIVE and took 0.0273 ms, against 0.0207 here;
// PERF.md). At 4,736 points: 2,368 warps, 18 an SM, at most 96 registers
// (five blocks an SM) and no spills.
// Each entry is stored from registers as soon as it exists: role r writes
// coordinate r, so the 8 threads of a role in a warp write 8 consecutive
// points of a limb, one 32-byte sector. No local table.
//
// The additions use P's cached form (Y-X, Y+X, Z, 2d T), so T1 (2d T2) is
// formed with 2d T2 first (quad_add); the plain window_table adds the same
// way (add_cached), so both agree limb for limb.
//
// Measured (kernel_ab, graph replay, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 0.0206-0.0209 ms at 4,736 points (the first port: 0.054 ms) and
// 0.0107-0.0112 ms at 8 rows of 256 points. Designs tried and dropped:
// one quad a point running the 14 operations in order (0.0261 / 0.0260
// ms: too few warps), and two quads a point, each a prefix and then two
// chains interleaved, 15 operations (0.0200 / 0.0173 ms: as fast at one
// row, slower at R = 8). At one row the time stays near 0.020 ms whether a
// point takes 20 operations on 2,368 warps or 15 on 1,184: the SMs issue
// about 0.27 instructions a clock a scheduler of this mix (one IMAD.WIDE in
// three to four instructions, the field library's carries and masks beside
// it), so
// what bounds it now is the instruction count of the field arithmetic,
// not the schedule's depth or the 12.1 MB of stores.
#include "msm_layout.cuh"
#include "quad25519.cuh"

namespace qq {

constexpr int MT_PARTS = 4;  // quads a point

// From P: LEN steps, step s a doubling of the running multiple or, where
// bit s of ADDS is set, an addition of P (c1: P cached); the multiples of
// steps FIRST.. are stored (store(role, k, value))
QQ_FUNCTOR_TEMPLATE
template <int LEN, int ADDS, int FIRST, class Q, class Store>
QQ_HD void quad_table_chain(const Q& q, const typename Q::V& p, const typename Q::V& c1,
                            const Store& store) {
  typename Q::V m = p;
  int k = 1;
  QQ_UNROLL
  for (int s = 0; s < LEN; ++s) {
    if ((ADDS >> s) & 1) {
      quad_add(q, m, c1);
      k += 1;
    } else {
      quad_double<true>(q, m);
      k *= 2;
    }
    if (s >= FIRST)
      for (int r = q.first(); r < q.end(); ++r) store(r, k, m.at(r));
  }
}

// Part `part` (0..3) of the four-quad table of P; the four parts together
// store every entry once.
QQ_FUNCTOR_TEMPLATE
template <class Q, class Store>
QQ_HD void quad_table16_part(const Q& q, int part, const typename Q::V& p, const Store& store) {
  const typename Q::V c1 = quad_to_cached(q, p);
  switch (part) {
    case 0: quad_table_chain<6, 0x2a, 0>(q, p, c1, store); break;  // 2, 3, 6, 7, 14, 15
    case 1: quad_table_chain<5, 0x14, 1>(q, p, c1, store); break;  // 4, 5, 10, 11
    case 2: quad_table_chain<5, 0x12, 3>(q, p, c1, store); break;  // 12, 13
    default: {
      const typename Q::V e = quad_identity(q);
      for (int r = q.first(); r < q.end(); ++r) {
        store(r, 0, e.at(r));
        store(r, 1, p.at(r));
      }
      quad_table_chain<4, 0x08, 2>(q, p, c1, store);  // 8, 9
    }
  }
}

// The kernel's arithmetic for point i of n with the parts and their roles
// run in turn on the host: writes its 16 multiples into the four table
// coordinates [16][NL][n].
inline void msm_table_lane(const ge& p, int32_t* tx, int32_t* ty, int32_t* tz, int32_t* tt,
                           long i, long n) {
  const QuadHost q;
  const QuadHost::V pv{{p.x, p.y, p.z, p.t}};
  int32_t* const t[4] = {tx, ty, tz, tt};
  const auto store = [&](int r, int k, const fe& v) {
    fe_store_strided(t[r] + (long)k * NL * n + i, n, v);
  };
  for (int part = 0; part < MT_PARTS; ++part) quad_table16_part(q, part, pv, store);
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPointsPerBlock = kThreads / 4;
// at most 102 registers, so that the 2,368 warps of 4,736 points fit on the
// 132 SMs at once (20 warps an SM)
constexpr int kBlocksPerSM = 5;

// Thread t of a block: role t % 4 of point t / 4 of the block's 32; the
// block runs part blockIdx.y. Threads of points
// past n compute point n-1's entries and store them there too, the same
// values as its own threads: no store is conditional, so the warp stays
// converged between its shuffles.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
msm_table_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                 const int32_t* __restrict__ pz, const int32_t* __restrict__ pt,
                 int32_t* __restrict__ tx, int32_t* __restrict__ ty, int32_t* __restrict__ tz,
                 int32_t* __restrict__ tt, int n) {
  const int role = threadIdx.x & 3;
  const long i = (long)blockIdx.x * kPointsPerBlock + (threadIdx.x >> 2);
  const long src = i < n ? i : n - 1;  // the point computed and stored
  const qq::QuadShfl q{role, 0xffffffffu};
  const int32_t* in = role == 0 ? px : role == 1 ? py : role == 2 ? pz : pt;
  int32_t* out = role == 0 ? tx : role == 1 ? ty : role == 2 ? tz : tt;
  const qq::QuadShfl::V p{qq::fe_load(in, src)};
  const auto store = [&](int, int k, const qq::fe& v) {
    qq::fe_store_strided(out + (long)k * qq::NL * n + src, n, v);
  };
  qq::quad_table16_part(q, blockIdx.y, p, store);
}

}  // namespace

// p* int32 [n, 10]; t* int32 [16, 10, n]; returns cudaGetLastError()
extern "C" int qq_msm_table(const void* px, const void* py, const void* pz, const void* pt,
                            void* tx, void* ty, void* tz, void* tt, int n, void* stream) {
  if (n > 0) {
    const dim3 blocks((n + kPointsPerBlock - 1) / kPointsPerBlock, qq::MT_PARTS);
    msm_table_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)pt,
        (int32_t*)tx, (int32_t*)ty, (int32_t*)tz, (int32_t*)tt, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
