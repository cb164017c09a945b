// Inverted dropout keyed by the counter RNG, for the fused train step:
//
//   out[i] = x[i] * (keep(i) ? scale : 0.0f),
//   keep(i) = (fmix32(i * 0xC2B2AE35 ^ key) >> 8) * 2^-24 >= ratio,
//
// with i the flat row-major (NHWC) index, key folded on the host from
// (stream seed, unit id, epoch, counter) and ratio and scale =
// 1/(1 - ratio) rounded to float32 there.  That is the reference's
// rngbits.uniform01 and dropout.make_mask bit for bit, so the mask equals
// the JAX package's; the same call serves the forward (x) and the backward
// (err), and no mask is ever stored.
//
// dropout_kernel replaces the TPU kernel znicz_tpu/ops/elementwise.py
// pallas_dropout (_dropout_kernel).
//
// Bound on an H100: bytes.  At AlexNet's (128,6,6,256) the kernel reads
// and writes 4.7 MB each (~2.8 us at 3.35 TB/s), at (128,4096) 2.1 MB each
// (~1.3 us); the hash is ~12 integer operations per element, far under
// the card's integer rate.  One thread per element, neighbouring threads
// on neighbouring addresses, so the loads and stores coalesce; the
// elements fit 32-bit indices (the wrapper refuses 2^31 or more).  The
// product with the mask is __fmul_rn, as the reference's x * mask
// (a dropped element gives +-0, as there).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int fmix32(unsigned int x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__global__ void dropout_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int n,
                               unsigned int key, float ratio, float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned int h = fmix32(static_cast<unsigned int>(i) * 0xC2B2AE35u
                                ^ key);
  // h >> 8 < 2^24 converts exactly; the product with 2^-24 is exact too
  const float u = static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
  out[i] = __fmul_rn(x[i], u >= ratio ? scale : 0.0f);
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns the launch status
// (cudaGetLastError) as an int, 0 on success.
extern "C" int znicz_dropout_f32(const float* x, float* out, int n,
                                 unsigned int key, float ratio, float scale,
                                 void* stream) {
  if (n <= 0) return 0;
  dropout_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, out, n, key, ratio,
                                                        scale);
  return static_cast<int>(cudaGetLastError());
}
