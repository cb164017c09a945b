// The storage types of the fused step's activations (ModelSpec.
// storage_dtype): float, __nv_bfloat16 and __half.  A kernel that reads a
// stored activation takes it in its storage type, converts each element to
// float at the load (exact), computes in float, and rounds once where it
// stores one: __float2bfloat16_rn / __float2half_rn, round to nearest
// even, as PyTorch's and XLA's casts round.
//
// load_vec/store_vec here extend lrn_vec.cuh's to the two narrow types:
// V = 4 elements move as one 8-byte access (the caller's base 8-byte
// aligned, which a 16-byte aligned base with C % 4 == 0 gives), V = 1 as
// one element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// v rounded once to T (float: v itself)
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same_v<T, __half>) {
    return __float2half_rn(v);
  } else {
    return v;
  }
}

// v rounded to T and back: the value a store in T keeps
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
inline constexpr bool kNarrow =
    std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>;

// V consecutive narrow elements at p as floats
template <int V, typename T,
          typename = std::enable_if_t<kNarrow<T>>>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    T t[4];
    static_assert(sizeof(t) == sizeof(q), "4 narrow elements, 8 bytes");
    memcpy(t, &q, sizeof(q));
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_f32(t[i]);
  } else {
    v[0] = to_f32(*p);
  }
}

// V floats rounded once to the narrow T at p
template <int V, typename T,
          typename = std::enable_if_t<kNarrow<T>>>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    T t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = from_f32<T>(v[i]);
    uint2 q;
    memcpy(&q, t, sizeof(q));
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    *p = from_f32<T>(v[0]);
  }
}

// The entry points of a kernel templated on the storage type carry its
// suffix: f32, bf16, f16 (ops/__init__.py STORAGE_SUFFIX).
#define ZNICZ_FOR_EACH_STORAGE(M) \
  M(float, f32)                   \
  M(__nv_bfloat16, bf16)          \
  M(__half, f16)
