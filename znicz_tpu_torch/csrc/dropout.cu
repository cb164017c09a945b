// Inverted dropout keyed by the counter RNG, for the fused train step:
//
//   out[i] = x[i] * (keep(i) ? scale : 0.0f),
//   keep(i) = (fmix32(i * 0xC2B2AE35 ^ key) >> 8) * 2^-24 >= ratio,
//
// with i the flat row-major (NHWC) index in the whole tensor, key folded on
// the host from
// (stream seed, unit id, epoch, counter) and ratio and scale =
// 1/(1 - ratio) rounded to float32 there.  That is the reference's
// rngbits.uniform01 and dropout.make_mask bit for bit, so the mask equals
// the JAX package's; the same call serves the forward (x) and the backward
// (err), and no mask is ever stored.
//
// A shard of a sharded step (parallel/fused.py) passes where its elements
// sit in the whole tensor: element j of the shard has the index
//
//   i = base + (j / width) * row + col + j % width,
//
// rows of `width` elements at column `col` of rows `row` wide, the first
// `base` elements in: a data shard of the global batch (width == row, base
// = its first row's offset) or a model shard of the channels (width of row
// channels from col).  (base, width, row, col) = (0, n, n, 0) is the whole
// tensor, and width == row with col == 0 skips the division.
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
//
// The forward also takes x in the fused step's narrow storage types
// (narrow.cuh; entry points suffixed bf16, f16) and writes out in x's type:
// the product is formed in float from x's exact value and rounded once, as
// the reference multiplies a bf16 x by a float32 mask and casts the float32
// product at the layer's end.

#include <cuda_runtime.h>

#include "narrow.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int fmix32(unsigned int x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                               int n, unsigned int key, float ratio,
                               float scale, unsigned int base, int width,
                               int row, int col) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  // the index in the whole tensor, in u32 arithmetic as the reference's
  // uint32 iota wraps
  const unsigned int i =
      (width == row && col == 0)
          ? base + static_cast<unsigned int>(j)
          : base + static_cast<unsigned int>(j / width) *
                       static_cast<unsigned int>(row) +
                static_cast<unsigned int>(col + j % width);
  const unsigned int h = fmix32(i * 0xC2B2AE35u ^ key);
  // h >> 8 < 2^24 converts exactly; the product with 2^-24 is exact too
  const float u = static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
  out[j] = from_f32<T>(__fmul_rn(to_f32(x[j]), u >= ratio ? scale : 0.0f));
}

template <typename T>
int dropout(const T* x, T* out, int n, unsigned int key, float ratio,
            float scale, unsigned int base, int width, int row, int col,
            void* stream) {
  if (n <= 0) return 0;
  if (width <= 0 || width > row || col < 0 || col > row - width ||
      n % width != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dropout_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, out, n, key, ratio, scale, base, width, row, col);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns the launch status
// (cudaGetLastError) as an int, 0 on success, cudaErrorInvalidValue for
// (width, row, col) that place no shard of rows; x and out in the suffix's
// storage type (f32, bf16, f16).
#define ZNICZ_DROPOUT_ENTRY(T, SFX)                                          \
  extern "C" int znicz_dropout_##SFX(const T* x, T* out, int n,              \
                                     unsigned int key, float ratio,          \
                                     float scale, unsigned int base,         \
                                     int width, int row, int col,            \
                                     void* stream) {                         \
    return dropout<T>(x, out, n, key, ratio, scale, base, width, row, col,   \
                      stream);                                               \
  }

ZNICZ_FOR_EACH_STORAGE(ZNICZ_DROPOUT_ENTRY)
