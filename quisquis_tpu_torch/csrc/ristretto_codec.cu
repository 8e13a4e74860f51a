// ristretto255 decode and encode of a batch, one thread a point.
//
// Replaces no pallas_call: the JAX package's compress and decompress
// (quisquis_tpu/ops/point.py) are jax.jit programs that XLA fuses into one
// program each. The port ran the same formulas eagerly, some 10,900 torch
// launches a call whatever the batch. Here each call is one launch.
// Plain versions: quisquis_tpu_torch/ops/point.py decompress_bytes_tensor
// and compress_to_bytes_tensor; wrappers and launch counters:
// quisquis_tpu_torch/ops/cuda_point.py decode_bytes and encode_bytes.
//
// Per point (ristretto25519.cuh): decode is 257 squares and 27 multiplies,
// encode 255 squares and 32 multiplies, nearly all of them the inverse
// square root's z^(2^252-3) chain.
//
// Bound on this card: operations, 257 x 55 + 27 x 100 = 16,835 limb
// products a decode and 255 x 55 + 32 x 100 = 17,225 an encode against
// 132 SMs x 64 int32 lanes x the SM clock. At the batches the port hands it
// (hundreds to a few thousand points: under one warp a scheduler) no SM is
// full, and the floor is the latency of one thread's chain of about 285
// dependent field operations. The design keeps that chain short: one
// thread a point holds its element in registers (no shuffles, no shared
// memory, no barrier), the constants are immediates, and the bytes are
// read and written once (64 + 160 bytes a decoded point, 160 + 32 an
// encoded one). Threads past n return at once.
#include "ristretto25519.cuh"

namespace qq {

// One lane of a decode: 32 bytes in, ok and the four coordinates out.
QQ_HD void ristretto_decode_lane(const uint8_t* b, uint8_t* ok, int32_t* x, int32_t* y,
                                 int32_t* z, int32_t* t, long lane) {
  uint8_t in[32];
  QQ_UNROLL
  for (int k = 0; k < 32; ++k) in[k] = b[lane * 32 + k];
  ge p;
  ok[lane] = (uint8_t)ristretto_decode(in, p);
  ge_store(x, y, z, t, lane, p);
}

// One lane of an encode: the four coordinates in, 32 bytes out.
QQ_HD void ristretto_encode_lane(const int32_t* x, const int32_t* y, const int32_t* z,
                                 const int32_t* t, uint8_t* out, long lane) {
  uint8_t enc[32];
  ristretto_encode(ge_load(x, y, z, t, lane), enc);
  QQ_UNROLL
  for (int k = 0; k < 32; ++k) out[lane * 32 + k] = enc[k];
}

}  // namespace qq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kCodecThreads = 128;

__global__ void __launch_bounds__(kCodecThreads)
ristretto_decode_kernel(const uint8_t* __restrict__ b, uint8_t* __restrict__ ok,
                        int32_t* __restrict__ x, int32_t* __restrict__ y,
                        int32_t* __restrict__ z, int32_t* __restrict__ t, int n) {
  const long lane = (long)blockIdx.x * kCodecThreads + threadIdx.x;
  if (lane < n) qq::ristretto_decode_lane(b, ok, x, y, z, t, lane);
}

__global__ void __launch_bounds__(kCodecThreads)
ristretto_encode_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                        const int32_t* __restrict__ z, const int32_t* __restrict__ t,
                        uint8_t* __restrict__ out, int n) {
  const long lane = (long)blockIdx.x * kCodecThreads + threadIdx.x;
  if (lane < n) qq::ristretto_encode_lane(x, y, z, t, out, lane);
}

}  // namespace

// b uint8 [n, 32] -> ok uint8 [n] (0 or 1), x/y/z/t int32 [n, 10]; returns
// cudaGetLastError()
extern "C" int qq_ristretto_decode(const void* b, void* ok, void* x, void* y, void* z, void* t,
                                   int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + kCodecThreads - 1) / kCodecThreads;
    ristretto_decode_kernel<<<blocks, kCodecThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)b, (uint8_t*)ok, (int32_t*)x, (int32_t*)y, (int32_t*)z, (int32_t*)t,
        n);
  }
  return (int)cudaGetLastError();
}

// x/y/z/t int32 [n, 10] -> out uint8 [n, 32]; returns cudaGetLastError()
extern "C" int qq_ristretto_encode(const void* x, const void* y, const void* z, const void* t,
                                   void* out, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + kCodecThreads - 1) / kCodecThreads;
    ristretto_encode_kernel<<<blocks, kCodecThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)t,
        (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
