// Elementwise activation forward and backward of the standalone activation
// units (nn/activation.py), over float32 tensors of any shape taken flat:
//
//   act_fwd_kernel<A>:  y[i] = act(x[i])
//   act_bwd_kernel<A>:  err_x[i] = act'(err_y[i], y[i][, x[i]])
//
// They replace the TPU kernels znicz_tpu/ops/elementwise.py pallas_act_fwd
// (_act_fwd_kernel) and pallas_act_bwd (_act_bwd_kernel).  One template
// over the activation id (act_math.cuh, whose formulas the fused
// LRN->max-pool backward shares); the only position-dependent activation,
// sincos, takes sin at even and cos at odd indices of the last axis, so
// the kernels take its length C and find i mod C through FastDiv.  The
// Pallas kernels tile the flat tensor as (rows, 128) lanes and keep the
// last axis as the lane dimension for sincos; here a thread takes an
// element, neighbouring threads neighbouring addresses, in a grid-stride
// loop.
//
// Bound on an H100: bytes.  The forward reads x and writes y (8 bytes an
// element), the backward reads err_y and y (and x for log, sincos and
// tanhlog) and writes err_x (12 or 16 bytes), against at most ~40 float
// instructions an element (tanhf, log1pf, sinf: far under the card's
// float32 rate for these byte counts).  At the unit graph's (100, 100) the
// launch dominates; at (128, 55, 55, 96) the forward moves 297 MB (~89 us
// at 3.35 TB/s).  Loads and stores coalesce; the wrappers refuse 2^31
// elements or more, so indices are 32-bit.
//
// Rounding: act_math.cuh follows the plain PyTorch version operation by
// operation, so the kernels can equal it bit for bit where CUDA's expf,
// logf, log1pf, tanhf, sinf and cosf are what PyTorch's CUDA kernels call.

#include <cuda_runtime.h>

#include "act_math.cuh"
#include "fastdiv.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks a streaming multiprocessor

using act_math::TanhLogConsts;

__device__ __forceinline__ bool even_column(int i, const FastDiv& C) {
  return ((i - C.div(i) * static_cast<int>(C.d)) & 1) == 0;
}

template <int A>
__global__ void __launch_bounds__(kThreads)
act_fwd_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
               FastDiv C, TanhLogConsts k) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool even = A == act_math::kSinCos ? even_column(i, C) : true;
    y[i] = act_math::act_fwd<A>(x[i], even, k);
  }
}

template <int A>
__global__ void __launch_bounds__(kThreads)
act_bwd_kernel(const float* __restrict__ e, const float* __restrict__ y,
               const float* __restrict__ x, float* __restrict__ out, int n,
               FastDiv C, TanhLogConsts k) {
  constexpr bool kNeedsX = A == act_math::kLog || A == act_math::kSinCos ||
                           A == act_math::kTanhLog;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool even = A == act_math::kSinCos ? even_column(i, C) : true;
    out[i] = act_math::act_bwd<A>(e[i], kNeedsX ? 0.0f : y[i],
                                  kNeedsX ? x[i] : 0.0f, even, k);
  }
}

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <int A>
void launch_fwd(const float* x, float* y, int n, FastDiv C,
                TanhLogConsts k, cudaStream_t stream) {
  act_fwd_kernel<A><<<blocks_for(n), kThreads, 0, stream>>>(x, y, n, C, k);
}

template <int A>
void launch_bwd(const float* e, const float* y, const float* x, float* out,
                int n, FastDiv C, TanhLogConsts k, cudaStream_t stream) {
  act_bwd_kernel<A><<<blocks_for(n), kThreads, 0, stream>>>(e, y, x, out, n,
                                                            C, k);
}

}  // namespace

// n > 0 contiguous float32 elements whose last axis has C > 0 entries; act
// an id of act_math.cuh (an unknown id returns cudaErrorInvalidValue);
// t, inv_t, a, y_t are TanhLog's float32 constants.  Both entry points
// launch on `stream`, do not synchronise, and return cudaGetLastError() as
// an int.

extern "C" int znicz_act_fwd_f32(const float* x, float* y, int n, int C,
                                 int act, float t, float inv_t, float a,
                                 float y_t, void* stream) {
  const FastDiv c = make_fastdiv(C);
  const TanhLogConsts k{t, inv_t, a, y_t};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case act_math::kLinear: launch_fwd<act_math::kLinear>(x, y, n, c, k, s); break;
    case act_math::kStrictRelu: launch_fwd<act_math::kStrictRelu>(x, y, n, c, k, s); break;
    case act_math::kTanh: launch_fwd<act_math::kTanh>(x, y, n, c, k, s); break;
    case act_math::kSigmoid: launch_fwd<act_math::kSigmoid>(x, y, n, c, k, s); break;
    case act_math::kRelu: launch_fwd<act_math::kRelu>(x, y, n, c, k, s); break;
    case act_math::kMul: launch_fwd<act_math::kMul>(x, y, n, c, k, s); break;
    case act_math::kLog: launch_fwd<act_math::kLog>(x, y, n, c, k, s); break;
    case act_math::kSinCos: launch_fwd<act_math::kSinCos>(x, y, n, c, k, s); break;
    case act_math::kTanhLog: launch_fwd<act_math::kTanhLog>(x, y, n, c, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x may be null for the activations whose derivative needs only y.
extern "C" int znicz_act_bwd_f32(const float* e, const float* y,
                                 const float* x, float* out, int n, int C,
                                 int act, float t, float inv_t, float a,
                                 float y_t, void* stream) {
  const FastDiv c = make_fastdiv(C);
  const TanhLogConsts k{t, inv_t, a, y_t};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case act_math::kLinear: launch_bwd<act_math::kLinear>(e, y, x, out, n, c, k, s); break;
    case act_math::kStrictRelu: launch_bwd<act_math::kStrictRelu>(e, y, x, out, n, c, k, s); break;
    case act_math::kTanh: launch_bwd<act_math::kTanh>(e, y, x, out, n, c, k, s); break;
    case act_math::kSigmoid: launch_bwd<act_math::kSigmoid>(e, y, x, out, n, c, k, s); break;
    case act_math::kRelu: launch_bwd<act_math::kRelu>(e, y, x, out, n, c, k, s); break;
    case act_math::kMul: launch_bwd<act_math::kMul>(e, y, x, out, n, c, k, s); break;
    case act_math::kLog: launch_bwd<act_math::kLog>(e, y, x, out, n, c, k, s); break;
    case act_math::kSinCos: launch_bwd<act_math::kSinCos>(e, y, x, out, n, c, k, s); break;
    case act_math::kTanhLog: launch_bwd<act_math::kTanhLog>(e, y, x, out, n, c, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
