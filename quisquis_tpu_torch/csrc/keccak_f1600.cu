// Keccak-f[1600], all 24 rounds in one launch, one state a warp: thread i
// of the warp holds lane i (i = x + 5y) of the state.
//
// Replaces: quisquis_tpu/ops/pallas_keccak.py _kernel (reached from
// f1600_pallas). Plain version: quisquis_tpu_torch/ops/device_keccak.py
// f1600_plain; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_keccak.py f1600.
//
// The TPU kernel keeps states as [200 byte rows, lanes], splits every 64-bit
// lane into two uint32 halves (its vector unit has no 64-bit rotate) and pads
// the batch to 128. Input and output here are the [n, 200] byte states the
// device STROBE keeps: 200 bytes are 25 little-endian uint64, read and
// written as such.
//
// Work a state and round: theta 50 xors and 5 rotates, rho+pi 24 rotates,
// chi 75 (not, and, xor), iota 1: 155 64-bit logic operations, 3,720 a
// state, each two 32-bit operations. At the range verifier's 64 states
// that is 0.48 M operations, tens of nanoseconds at the card's int32 rate:
// the bound says nothing about this kernel. What bounds it on this card is
// latency at tiny batch: the first port ran one thread a state, so 64
// states were two warps on one SM of 132, each thread issuing ~7,500
// dependent 32-bit instructions in order (~10 us a launch).
//
// This design splits a state over 25 threads, one 64-bit lane each (lanes
// 25..31 of the warp hold zeros, read only themselves and take part in
// every shuffle, so the mask stays full). A round is three exchange steps,
// each a few independent 64-bit shuffles (two 32-bit SHFL each):
//   1. theta, column parity: the four other lanes of the thread's column;
//   2. theta, D[x] = C[x-1] ^ rotl(C[x+1], 1): two lanes of the same row,
//      then rho: the thread rotates its own lane by its own offset (a
//      funnel shift by a register amount);
//   3. pi and chi together: lane (x, y) reads the rho outputs of the pi
//      sources of (x, y), (x+1, y) and (x+2, y) and forms chi; iota on
//      lane 0.
// Nine 64-bit shuffles and about a dozen logic operations a thread and
// round, 24 x 3 = 72 dependent exchange steps a state. Four states (warps)
// a block, so 64 states spread over 16 SMs, one warp a scheduler.
//
// Measured (kernel_ab, graph replay, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 0.0043-0.0044 ms a launch at 64 states and 0.0047 at 1,024 (the first
// port: 0.0100 and 0.0104), of which about 0.0010 ms is the launch of an
// empty kernel: ~46 ns, ~90 clocks, a dependent step, the latency of its
// 2-8 shuffles (18 SHFL a round) and of the logic between them. Tried and
// dropped: one or two states a block (no change), theta in one step from
// ten shuffles (0.0045-0.0047 / 0.0055 ms), the exchange through shared
// memory (0.0050-0.0052 / 0.0063 ms).
//
// The exchange is a policy, as in quad25519.cuh: KeccakShfl (device) is one
// lane of a warp and reads with __shfl_sync; KeccakHost runs the 25 lanes
// of one state in turn over an array, so g++ builds the same round for
// tests/test_torch_csrc_host.py. Round constants and rotation offsets live
// in __constant__ memory on the card (uniform per round; per thread once),
// never in a thread's local array. keccak_f1600_lanes, the one-thread
// permutation, stays as the host reference.
#include <stdint.h>

#ifdef __CUDACC__
#define QQK_HD __host__ __device__ __forceinline__
#define QQK_UNROLL _Pragma("unroll")
#else
#define QQK_HD inline
#define QQK_UNROLL
#endif

namespace qq {

constexpr int KECCAK_LANES = 25;

// rho offsets by flat lane index x + 5y, and the round constants
#define QQK_ROT_INIT                                                                      \
  {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, \
   56, 14}
#define QQK_RC_INIT                                                                    \
  {0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,                \
   0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,                \
   0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,                \
   0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,                \
   0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,                \
   0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,                \
   0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,                \
   0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL}

constexpr int kKeccakRotHost[25] = QQK_ROT_INIT;
constexpr uint64_t kKeccakRcHost[24] = QQK_RC_INIT;
#ifdef __CUDACC__
__constant__ int kKeccakRotDev[25] = QQK_ROT_INIT;
__constant__ uint64_t kKeccakRcDev[24] = QQK_RC_INIT;
#endif

QQK_HD uint64_t keccak_rc(int round) {
#ifdef __CUDA_ARCH__
  return kKeccakRcDev[round];
#else
  return kKeccakRcHost[round];
#endif
}

QQK_HD uint64_t rotl64(uint64_t x, int r) { return r == 0 ? x : (x << r) | (x >> (64 - r)); }

// x rotated left by r in 0..63, r in a register: on the card two funnel
// shifts of the halves, swapped first when r >= 32
QQK_HD uint64_t rotl64_var(uint64_t x, int r) {
#ifdef __CUDA_ARCH__
  const uint32_t a = (uint32_t)x, b = (uint32_t)(x >> 32);
  const bool swap = r & 32;
  const uint32_t lo = swap ? b : a, hi = swap ? a : b;
  return ((uint64_t)__funnelshift_l(lo, hi, r) << 32) | __funnelshift_l(hi, lo, r);
#else
  return rotl64(x, r & 63);
#endif
}

// ---------------------------------------------------------------------------
// where lane i = x + 5y reads; a lane >= 25 (the warp's spare lanes) reads
// only itself
// ---------------------------------------------------------------------------

// lane (x, y + k) of lane i's column, k = 1..4
QQK_HD int keccak_col_src(int i, int k) {
  return i < KECCAK_LANES ? i % 5 + 5 * ((i / 5 + k) % 5) : i;
}

// lane (x + k, y) of lane i's row
QQK_HD int keccak_row_src(int i, int k) {
  return i < KECCAK_LANES ? (i % 5 + k) % 5 + 5 * (i / 5) : i;
}

// the lane that pi moves to lane d = X + 5Y: (x, y) with y = X and
// 2x + 3y = Y (mod 5), that is x = 3Y + X (mod 5)
QQK_HD int keccak_pi_src(int d) {
  return d < KECCAK_LANES ? (3 * (d / 5) + d % 5) % 5 + 5 * (d % 5) : d;
}

// ---------------------------------------------------------------------------
// exchange policies
// ---------------------------------------------------------------------------

// Each policy says where lane i reads: col(i, k) the lanes of its column
// (k = 1..4), row(i, k) the lanes x+4 and x+1 of its row (k = 4, 1), chi(i,
// k) the pi source of lane (x+k, y) (k = 0..2), and rot(i) its rho offset.

// The 25 lanes of one state, run in turn on the host.
struct KeccakHost {
  struct V {
    uint64_t c[KECCAK_LANES];
    QQK_HD uint64_t& at(int i) { return c[i]; }
  };
  QQK_HD int first() const { return 0; }
  QQK_HD int end() const { return KECCAK_LANES; }
  QQK_HD uint64_t from(const V& v, int src) const { return v.c[src]; }
  QQK_HD int col(int i, int k) const { return keccak_col_src(i, k); }
  QQK_HD int row(int i, int k) const { return keccak_row_src(i, k); }
  QQK_HD int chi(int i, int k) const { return keccak_pi_src(keccak_row_src(i, k)); }
  QQK_HD int rot(int i) const { return kKeccakRotHost[i]; }
};

// One lane of a warp on the card, its sources and rho offset computed once
// before the rounds (keccak_shfl); the warp's spare lanes read themselves
// and rotate by 0. Every lane runs every shuffle: the kernel has no early
// exit, so the warp is converged at each one.
struct KeccakShfl {
  struct V {
    uint64_t c;
    QQK_HD uint64_t& at(int) { return c; }
  };
  int lane, r, col_[5], row_[5], chi_[3];
  QQK_HD int first() const { return lane; }
  QQK_HD int end() const { return lane + 1; }
  // k is a compile-time constant in keccak_round (unrolled): registers
  QQK_HD int col(int, int k) const { return col_[k]; }
  QQK_HD int row(int, int k) const { return row_[k]; }
  QQK_HD int chi(int, int k) const { return chi_[k]; }
  QQK_HD int rot(int) const { return r; }
  QQK_HD uint64_t from(const V& v, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, (unsigned long long)v.c, src);
#else
    return v.c;  // host builds never run a KeccakShfl
#endif
  }
};

// One round on the lanes a[i], i = x.first() .. x.end() - 1. Each step
// reads only values the step before wrote.
template <class X>
QQK_HD void keccak_round(const X& x, typename X::V& a, uint64_t rc) {
  typename X::V c, b;
  for (int i = x.first(); i < x.end(); ++i) {  // 1. column parity C[x]
    uint64_t p = a.at(i);
    QQK_UNROLL
    for (int k = 1; k < 5; ++k) p ^= x.from(a, x.col(i, k));
    c.at(i) = p;
  }
  for (int i = x.first(); i < x.end(); ++i) {  // 2. theta, then rho
    const uint64_t t = a.at(i) ^ x.from(c, x.row(i, 4)) ^ rotl64(x.from(c, x.row(i, 1)), 1);
    b.at(i) = rotl64_var(t, x.rot(i));
  }
  for (int i = x.first(); i < x.end(); ++i) {  // 3. pi and chi, iota
    const uint64_t b0 = x.from(b, x.chi(i, 0));
    const uint64_t b1 = x.from(b, x.chi(i, 1));
    const uint64_t b2 = x.from(b, x.chi(i, 2));
    a.at(i) = b0 ^ (~b1 & b2) ^ (i == 0 ? rc : 0);
  }
}

// The permutation on 25 lanes a[x + 5y] through the split round, the 25
// lanes run in turn: what the kernel computes, on the host.
inline void keccak_f1600_split(uint64_t a[KECCAK_LANES]) {
  const KeccakHost x;
  KeccakHost::V v;
  for (int i = 0; i < KECCAK_LANES; ++i) v.c[i] = a[i];
  for (int round = 0; round < 24; ++round) keccak_round(x, v, keccak_rc(round));
  for (int i = 0; i < KECCAK_LANES; ++i) a[i] = v.c[i];
}

// The reference: the permutation on 25 lanes a[x + 5y] in one thread.
inline void keccak_f1600_lanes(uint64_t a[KECCAK_LANES]) {
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], kKeccakRotHost[x + 5 * y]);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= kKeccakRcHost[round];
  }
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kStatesPerBlock = 4;  // one a warp

__device__ __forceinline__ qq::KeccakShfl keccak_shfl(int lane) {
  qq::KeccakShfl x;
  x.lane = lane;
  x.r = lane < qq::KECCAK_LANES ? qq::kKeccakRotDev[lane] : 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    x.col_[k] = qq::keccak_col_src(lane, k);
    x.row_[k] = qq::keccak_row_src(lane, k);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) x.chi_[k] = qq::keccak_pi_src(qq::keccak_row_src(lane, k));
  return x;
}

// Warps past the last state permute state n-1 and store nothing, so no
// warp leaves before the shuffles. in and out may be the same array: each
// thread reads its lane before it writes it, and no other thread touches
// that lane.
__global__ void __launch_bounds__(32 * kStatesPerBlock)
keccak_f1600_kernel(const uint64_t* in, uint64_t* out, int n) {
  const int lane = threadIdx.x & 31;
  const long s = (long)blockIdx.x * kStatesPerBlock + (threadIdx.x >> 5);
  const long src = s < n ? s : n - 1;
  const qq::KeccakShfl x = keccak_shfl(lane);
  qq::KeccakShfl::V a{lane < qq::KECCAK_LANES ? in[src * qq::KECCAK_LANES + lane] : 0};
#pragma unroll
  for (int round = 0; round < 24; ++round) qq::keccak_round(x, a, qq::keccak_rc(round));
  if (s < n && lane < qq::KECCAK_LANES) out[s * qq::KECCAK_LANES + lane] = a.c;
}

}  // namespace

// in, out: uint8 [n, 200], 8-byte aligned (out may be in); returns cudaGetLastError()
extern "C" int qq_keccak_f1600(const void* in, void* out, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + kStatesPerBlock - 1) / kStatesPerBlock;
    keccak_f1600_kernel<<<blocks, 32 * kStatesPerBlock, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
