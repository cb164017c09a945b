// Row softmax + argmax for the unit graph's All2AllSoftmax.
//
// Replaces the TPU kernel znicz_tpu/ops/softmax.py pallas_softmax
// (_softmax_kernel): per row of float32 x (N, C) it writes
//   y   = e / sum(e),  e = exp(x - max(x)),
//   idx = argmax(x), the first index of the maximum (jnp.argmax).
// A NaN counts as the largest value, as in torch.argmax and jnp.argmax, so
// a row holding one gives the first NaN's index and NaN probabilities, as
// the plain version does.
//
// expf and the division are the accurate, correctly rounded versions (no
// --use_fast_math, no __expf): y agrees with the plain PyTorch version to
// rtol 1e-6 (the sums are taken in another order), idx exactly.
//
// Bound on an H100: bytes.  N*C*4 read and N*C*4 + N*4 written against ~5
// flops an element: 0.31 µs at (128, 1000) over 3.35 TB/s; the unit
// graph's (100, 10) is launch-bound.  The design is softmax_ce.cu's: one
// warp per row, so the three passes over a row (max and argmax, sum,
// write) re-read it from L1 rather than device memory, and the argmax is a
// warp reduction that keeps the smaller index on ties.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;   // one warp per row, 256 threads a block

// (v2, a2) beats (v1, a1): a larger value, NaN above everything, the
// smaller index on a tie; a lane that saw no element carries index -1.
__device__ __forceinline__ bool beats(float v2, int a2, float v1, int a1) {
  if (a2 < 0) return false;
  if (a1 < 0) return true;
  const bool n2 = v2 != v2;
  const bool n1 = v1 != v1;
  if (n2 != n1) return n2;
  if (n2 || v2 == v1) return a2 < a1;
  return v2 > v1;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void row_softmax_kernel(const float* __restrict__ x,
                                   float* __restrict__ y,
                                   int* __restrict__ idx, int n, int c) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;   // whole warp leaves together: shuffles stay full
  const float* xr = x + row * c;
  float* yr = y + row * c;

  // pass 1: this lane's first maximum, then the warp's
  float m = -CUDART_INF_F;
  int arg = -1;
  for (int j = lane; j < c; j += kWarp) {
    const float v = xr[j];
    if (beats(v, j, m, arg)) {
      m = v;
      arg = j;
    }
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const int a2 = __shfl_xor_sync(0xffffffffu, arg, off);
    if (beats(m2, a2, m, arg)) {
      m = m2;
      arg = a2;
    }
  }

  // pass 2: sum of exp(x - m)
  float s = 0.0f;
  for (int j = lane; j < c; j += kWarp) s += expf(xr[j] - m);
  s = warp_sum(s);

  // pass 3: probabilities and (lane 0) the row's argmax
  for (int j = lane; j < c; j += kWarp) yr[j] = expf(xr[j] - m) / s;
  if (lane == 0) idx[row] = arg;
}

}  // namespace

// n > 0 rows of c > 0 contiguous float32 values.  Launches on `stream`,
// does not synchronise; returns cudaGetLastError() as an int.
extern "C" int znicz_row_softmax_f32(const float* x, float* y, int* idx,
                                     int n, int c, void* stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  row_softmax_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, y, idx, n, c);
  return static_cast<int>(cudaGetLastError());
}
