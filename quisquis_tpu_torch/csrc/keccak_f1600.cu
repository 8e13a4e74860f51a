// Keccak-f[1600], all 24 rounds in one launch, one state per thread.
//
// Replaces: quisquis_tpu/ops/pallas_keccak.py _kernel (reached from
// f1600_pallas). Plain version: quisquis_tpu_torch/ops/device_keccak.py
// f1600_plain; wrapper and launch counter:
// quisquis_tpu_torch/ops/cuda_keccak.py f1600.
//
// The TPU kernel keeps states as [200 byte rows, lanes], splits every 64-bit
// lane into two uint32 halves (its vector unit has no 64-bit rotate) and pads
// the batch to 128. Here a state is 25 native uint64_t in one thread's
// registers, the rotation amounts are compile-time constants (the rounds'
// inner loops are fully unrolled), and the batch is what it is (guard i < n).
// Input and output are the [n, 200] byte states the device STROBE keeps: 200
// bytes are 25 little-endian uint64, read and written as such.
//
// Per state and round: theta 50 xors and 5 rotates, rho+pi 24 rotates, chi 75
// (not, and, xor), iota 1: 155 64-bit logic operations, 3,720 a state. Each
// is two 32-bit operations (a rotate by a constant is two funnel shifts, one
// for each half). Bound on this card: operations (7,440 int32 operations a
// state against 400 bytes: 0.44 ns against 0.12 ns a state). At the range
// verifier's 64 states both bounds are tens of nanoseconds and the launch
// itself is what takes time.
#include <stdint.h>

#ifdef __CUDACC__
#define QQK_HD __host__ __device__ __forceinline__
#define QQK_UNROLL _Pragma("unroll")
#else
#define QQK_HD inline
#define QQK_UNROLL
#endif

namespace qq {

QQK_HD uint64_t rotl64(uint64_t x, int r) { return r == 0 ? x : (x << r) | (x >> (64 - r)); }

// rho offsets by flat lane index x + 5y
QQK_HD constexpr int keccak_rot(int i) {
  constexpr int rot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                           25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  return rot[i];
}

QQK_HD constexpr uint64_t keccak_rc(int round) {
  constexpr uint64_t rc[24] = {
      0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL, 0x8000000080008000ULL,
      0x000000000000808BULL, 0x0000000080000001ULL, 0x8000000080008081ULL, 0x8000000000008009ULL,
      0x000000000000008AULL, 0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
      0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL, 0x8000000000008003ULL,
      0x8000000000008002ULL, 0x8000000000000080ULL, 0x000000000000800AULL, 0x800000008000000AULL,
      0x8000000080008081ULL, 0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
  return rc[round];
}

// the permutation on 25 lanes a[x + 5y]
QQK_HD void keccak_f1600_lanes(uint64_t a[25]) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
    QQK_UNROLL
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    QQK_UNROLL
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
      QQK_UNROLL
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
    QQK_UNROLL
    for (int x = 0; x < 5; ++x) {
      QQK_UNROLL
      for (int y = 0; y < 5; ++y) {
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], keccak_rot(x + 5 * y));
      }
    }
    QQK_UNROLL
    for (int y = 0; y < 5; ++y) {
      QQK_UNROLL
      for (int x = 0; x < 5; ++x) {
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
      }
    }
    a[0] ^= keccak_rc(round);
  }
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
keccak_f1600_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t a[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) a[k] = in[i * 25 + k];
  qq::keccak_f1600_lanes(a);
#pragma unroll
  for (int k = 0; k < 25; ++k) out[i * 25 + k] = a[k];
}

}  // namespace

// in, out: uint8 [n, 200], 8-byte aligned (out may be in); returns cudaGetLastError()
extern "C" int qq_keccak_f1600(const void* in, void* out, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    keccak_f1600_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
