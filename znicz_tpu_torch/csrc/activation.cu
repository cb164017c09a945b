// Elementwise activation forward and backward over float32 tensors of any
// shape taken flat, for every non-linear activation of the port: the fused
// step's fc, conv and deconv outputs and its standalone activation rows,
// the unit graph's weighted units and its standalone activation units
// (ops/activations.py apply_fwd/apply_bwd and act_fwd/act_bwd):
//
//   act_fwd_kernel<A, V>:  y[i] = act(x[i])
//   act_bwd_kernel<A, V>:  err_x[i] = act'(err_y[i], y[i] or x[i])
//
// They replace the TPU kernels znicz_tpu/ops/elementwise.py pallas_act_fwd
// (_act_fwd_kernel) and pallas_act_bwd (_act_bwd_kernel).  A is the
// activation id of act_math.cuh, whose per-element formulas the fused
// LRN->max-pool backward shares.  The Pallas kernels tile the flat tensor
// as (rows, 128) lanes; here the tensor is cut into chunks of kChunk
// elements, one block a chunk, the grid sized to the tensor (no grid-stride
// loop, no cap on the grid).
//
// Bound on an H100: bytes.  The forward reads x and writes y (8 bytes an
// element), the backward reads err_y and one of y or x (x for log, sincos
// and tanhlog) and writes err_x (12 bytes), against at most ~40 float
// instructions an element (tanhf, log1pf, sinf: far under the card's
// float32 rate for these byte counts).  At AlexNet's conv1 output
// (128, 55, 55, 96) the forward moves 297 MB (~89 us at 3.35 TB/s), the
// backward 446 MB (~133 us); at (100, 100) the launch dominates.
//
// What the design does about the bound:
// - V = 4: a thread moves float4s (16-byte loads and stores) where
//   n % 4 == 0 and every pointer is 16-byte aligned; the entry points test
//   that themselves and otherwise launch the scalar form V = 1 (the same
//   chunks, 4 * kVecs elements a thread, neighbouring threads on
//   neighbouring addresses).
// - Every load of a thread is issued before any of its math, so a thread
//   keeps kVecs float4s of each input in flight; with the grid sized to
//   the tensor, each SM holds as many blocks as its registers allow.
//   kVecs = 1, 2 and 4 were measured at (128, 55, 55, 96) and (100, 100)
//   (python -m znicz_tpu_torch.act_probe): 1 was fastest or level at
//   both, 4 spilled and lost 0.3 us at (100, 100).  Streaming loads and
//   stores (__ldcs/__stcs) were up to 55% slower where the tensor sits in
//   L2, as the CIFAR layers' do, so the accesses are plain.
// - sincos, the one position-dependent activation, takes sin at even and
//   cos at odd indices of the last axis (length C).  Where C is even an
//   element's column has the parity of its flat index, so lanes 0 and 2
//   of a float4 take sin and lanes 1 and 3 cos, with no division; only an
//   odd C finds each column through FastDiv.
//
// Rounding: act_math.cuh follows the plain PyTorch version operation by
// operation; the vector form changes where an element is loaded, never
// its arithmetic.  Indices are 32-bit: the wrappers refuse 2^31 elements
// or more.
//
// The backward also reads the stored y (or x) of the fused step's narrow
// storage types (narrow.cuh; entry points suffixed bf16, f16): converted to
// float at the load (8-byte loads of 4 values in the vector form) and the
// derivative computed in float; err_y and err_x stay float.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

#include "act_math.cuh"
#include "fastdiv.cuh"
#include "narrow.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 1;                        // float4s a thread, an input
constexpr int kChunk = kThreads * kVecs * 4;    // elements a block
constexpr int kScalar = kChunk / kThreads;      // elements a thread, V = 1

using act_math::TanhLogConsts;

__device__ __forceinline__ float4 load4(const float4* p) { return *p; }
__device__ __forceinline__ void store4(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ float load1(const float* p) { return *p; }
// 4 stored values (float: one float4; narrow: one 8-byte load) as a float4,
// one as a float
template <typename T>
__device__ __forceinline__ float4 load4s(const T* p) {
  if constexpr (kNarrow<T>) {
    float v[4];
    load_vec<4>(p, v);
    return make_float4(v[0], v[1], v[2], v[3]);
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}
template <typename T>
__device__ __forceinline__ float load1s(const T* p) { return to_f32(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

template <int A>
__device__ __forceinline__ constexpr bool needs_x() {
  return A == act_math::kLog || A == act_math::kSinCos ||
         A == act_math::kTanhLog;
}

// whether flat index i sits at an even index of the last axis (sincos)
struct Parity {
  FastDiv C;
  int by_index;                                 // C even: i's own parity

  __device__ __forceinline__ bool even(int i) const {
    if (by_index) return (i & 1) == 0;
    return ((i - C.div(i) * static_cast<int>(C.d)) & 1) == 0;
  }
};

template <int A>
__device__ __forceinline__ bool even_at(const Parity& p, int i) {
  return A == act_math::kSinCos ? p.even(i) : true;
}

template <int A>
__device__ __forceinline__ float fwd1(float x, const Parity& p, int i,
                                      const TanhLogConsts& k) {
  return act_math::act_fwd<A>(x, even_at<A>(p, i), k);
}

// s is y, or x for the activations whose derivative needs the input
template <int A>
__device__ __forceinline__ float bwd1(float e, float s, const Parity& p,
                                      int i, const TanhLogConsts& k) {
  constexpr bool kX = needs_x<A>();
  return act_math::act_bwd<A>(e, kX ? 0.0f : s, kX ? s : 0.0f,
                              even_at<A>(p, i), k);
}

template <int A, int V>
__global__ void __launch_bounds__(kThreads)
act_fwd_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
               Parity p, TanhLogConsts k) {
  if constexpr (V == 4) {
    const int n4 = n >> 2;
    const int first = static_cast<int>(blockIdx.x) * (kThreads * kVecs) +
                      static_cast<int>(threadIdx.x);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    float4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = first + u * kThreads;
      if (i < n4) v[u] = load4(x4 + i);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = first + u * kThreads;
      if (i < n4) {
        const int j = 4 * i;
        store4(y4 + i, make_float4(fwd1<A>(v[u].x, p, j, k),
                                   fwd1<A>(v[u].y, p, j + 1, k),
                                   fwd1<A>(v[u].z, p, j + 2, k),
                                   fwd1<A>(v[u].w, p, j + 3, k)));
      }
    }
  } else {
    const unsigned first = blockIdx.x * static_cast<unsigned>(kChunk) +
                           threadIdx.x;
    const unsigned un = static_cast<unsigned>(n);
    float v[kScalar];
#pragma unroll
    for (int u = 0; u < kScalar; ++u) {
      const unsigned i = first + u * kThreads;
      if (i < un) v[u] = load1(x + i);
    }
#pragma unroll
    for (int u = 0; u < kScalar; ++u) {
      const unsigned i = first + u * kThreads;
      if (i < un) store1(y + i, fwd1<A>(v[u], p, static_cast<int>(i), k));
    }
  }
}

template <int A, int V, typename TS>
__global__ void __launch_bounds__(kThreads)
act_bwd_kernel(const float* __restrict__ e, const TS* __restrict__ y,
               const TS* __restrict__ x, float* __restrict__ out, int n,
               Parity p, TanhLogConsts k) {
  const TS* __restrict__ s = needs_x<A>() ? x : y;
  if constexpr (V == 4) {
    const int n4 = n >> 2;
    const int first = static_cast<int>(blockIdx.x) * (kThreads * kVecs) +
                      static_cast<int>(threadIdx.x);
    const float4* e4 = reinterpret_cast<const float4*>(e);
    float4* o4 = reinterpret_cast<float4*>(out);
    float4 ve[kVecs], vs[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = first + u * kThreads;
      if (i < n4) {
        ve[u] = load4(e4 + i);
        vs[u] = load4s(s + 4 * i);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = first + u * kThreads;
      if (i < n4) {
        const int j = 4 * i;
        store4(o4 + i, make_float4(bwd1<A>(ve[u].x, vs[u].x, p, j, k),
                                   bwd1<A>(ve[u].y, vs[u].y, p, j + 1, k),
                                   bwd1<A>(ve[u].z, vs[u].z, p, j + 2, k),
                                   bwd1<A>(ve[u].w, vs[u].w, p, j + 3, k)));
      }
    }
  } else {
    const unsigned first = blockIdx.x * static_cast<unsigned>(kChunk) +
                           threadIdx.x;
    const unsigned un = static_cast<unsigned>(n);
    float ve[kScalar], vs[kScalar];
#pragma unroll
    for (int u = 0; u < kScalar; ++u) {
      const unsigned i = first + u * kThreads;
      if (i < un) {
        ve[u] = load1(e + i);
        vs[u] = load1s(s + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kScalar; ++u) {
      const unsigned i = first + u * kThreads;
      if (i < un) {
        store1(out + i, bwd1<A>(ve[u], vs[u], p, static_cast<int>(i), k));
      }
    }
  }
}

int blocks_for(int n) {
  return static_cast<int>((static_cast<long long>(n) + kChunk - 1) / kChunk);
}

// 16-byte vectors where the element count and every (non-null) pointer
// allow them
bool vec_ok(int n, std::initializer_list<const void*> ptrs) {
  std::uintptr_t bits = 0;
  for (const void* q : ptrs) bits |= reinterpret_cast<std::uintptr_t>(q);
  return n % 4 == 0 && (bits & 15u) == 0;
}

template <int A>
void launch_fwd(const float* x, float* y, int n, const Parity& p,
                const TanhLogConsts& k, bool vec, cudaStream_t stream) {
  if (vec) {
    act_fwd_kernel<A, 4><<<blocks_for(n), kThreads, 0, stream>>>(x, y, n, p,
                                                                 k);
  } else {
    act_fwd_kernel<A, 1><<<blocks_for(n), kThreads, 0, stream>>>(x, y, n, p,
                                                                 k);
  }
}

template <int A, typename TS>
void launch_bwd(const float* e, const TS* y, const TS* x, float* out, int n,
                const Parity& p, const TanhLogConsts& k, bool vec,
                cudaStream_t stream) {
  if (vec) {
    act_bwd_kernel<A, 4, TS><<<blocks_for(n), kThreads, 0, stream>>>(
        e, y, x, out, n, p, k);
  } else {
    act_bwd_kernel<A, 1, TS><<<blocks_for(n), kThreads, 0, stream>>>(
        e, y, x, out, n, p, k);
  }
}

// err_x of activation `act` (an unknown id: cudaErrorInvalidValue), the
// vector form where n and the pointers allow it
template <typename TS>
int act_bwd(const float* e, const TS* y, const TS* x, float* out, int n,
            int C, int act, float t, float inv_t, float a, float y_t,
            void* stream) {
  const Parity p{make_fastdiv(C), C % 2 == 0};
  const TanhLogConsts k{t, inv_t, a, y_t};
  const bool v = vec_ok(n, {e, y, x, out});
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case act_math::kLinear: launch_bwd<act_math::kLinear>(e, y, x, out, n, p, k, v, s); break;
    case act_math::kStrictRelu: launch_bwd<act_math::kStrictRelu>(e, y, x, out, n, p, k, v, s); break;
    case act_math::kTanh: launch_bwd<act_math::kTanh>(e, y, x, out, n, p, k, v, s); break;
    case act_math::kSigmoid: launch_bwd<act_math::kSigmoid>(e, y, x, out, n, p, k, v, s); break;
    case act_math::kRelu: launch_bwd<act_math::kRelu>(e, y, x, out, n, p, k, v, s); break;
    case act_math::kMul: launch_bwd<act_math::kMul>(e, y, x, out, n, p, k, v, s); break;
    case act_math::kLog: launch_bwd<act_math::kLog>(e, y, x, out, n, p, k, v, s); break;
    case act_math::kSinCos: launch_bwd<act_math::kSinCos>(e, y, x, out, n, p, k, v, s); break;
    case act_math::kTanhLog: launch_bwd<act_math::kTanhLog>(e, y, x, out, n, p, k, v, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n > 0 contiguous float32 elements whose last axis has C > 0 entries; act
// an id of act_math.cuh (an unknown id returns cudaErrorInvalidValue);
// t, inv_t, a, y_t are TanhLog's float32 constants.  Each entry point
// picks the vector form itself (V = 4 where n % 4 == 0 and all its
// pointers are 16-byte aligned, else V = 1), launches on `stream`, does
// not synchronise, and returns cudaGetLastError() as an int.

extern "C" int znicz_act_fwd_f32(const float* x, float* y, int n, int C,
                                 int act, float t, float inv_t, float a,
                                 float y_t, void* stream) {
  const Parity p{make_fastdiv(C), C % 2 == 0};
  const TanhLogConsts k{t, inv_t, a, y_t};
  const bool v = vec_ok(n, {x, y});
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case act_math::kLinear: launch_fwd<act_math::kLinear>(x, y, n, p, k, v, s); break;
    case act_math::kStrictRelu: launch_fwd<act_math::kStrictRelu>(x, y, n, p, k, v, s); break;
    case act_math::kTanh: launch_fwd<act_math::kTanh>(x, y, n, p, k, v, s); break;
    case act_math::kSigmoid: launch_fwd<act_math::kSigmoid>(x, y, n, p, k, v, s); break;
    case act_math::kRelu: launch_fwd<act_math::kRelu>(x, y, n, p, k, v, s); break;
    case act_math::kMul: launch_fwd<act_math::kMul>(x, y, n, p, k, v, s); break;
    case act_math::kLog: launch_fwd<act_math::kLog>(x, y, n, p, k, v, s); break;
    case act_math::kSinCos: launch_fwd<act_math::kSinCos>(x, y, n, p, k, v, s); break;
    case act_math::kTanhLog: launch_fwd<act_math::kTanhLog>(x, y, n, p, k, v, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x may be null for the activations whose derivative needs only y; y and
// x (whichever the derivative reads) are in the suffix's storage type (f32,
// bf16, f16), err_y and err_x are float.
#define ZNICZ_ACT_BWD_ENTRY(T, SFX)                                          \
  extern "C" int znicz_act_bwd_##SFX(const float* e, const T* y, const T* x, \
                                     float* out, int n, int C, int act,      \
                                     float t, float inv_t, float a,          \
                                     float y_t, void* stream) {              \
    return act_bwd<T>(e, y, x, out, n, C, act, t, inv_t, a, y_t, stream);    \
  }

ZNICZ_FOR_EACH_STORAGE(ZNICZ_ACT_BWD_ENTRY)
