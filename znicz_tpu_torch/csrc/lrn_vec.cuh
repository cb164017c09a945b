// The vector-window building blocks of the LRN kernels that stage x in a
// zero-haloed shared tile (lrn.cu's lrn_y/gd_lrn_x, lrn_pool.cu's fused
// LRN->max-pool pair): 16-byte loads and stores of V = 4 channels (V = 1,
// the scalar form, where C % 4 != 0 or a base is not 16-byte aligned), the
// window sums of a tile row, and the launch with a raised shared-memory
// limit.  A tile keeps `halo` zero floats on each side of every pixel's C
// channels, so a window reads its clipped slots as 0.0f without a bounds
// test.  The rounding is lrn_math.cuh's.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "lrn_math.cuh"
#include "narrow.cuh"

template <typename T>
using Vec4 = std::conditional_t<std::is_same<T, int>::value, int4, float4>;

template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[V]) {
  if constexpr (V == 4) {
    const Vec4<T> q = *reinterpret_cast<const Vec4<T>*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<Vec4<T>*>(p) = Vec4<T>{v[0], v[1], v[2], v[3]};
  } else {
    *p = v[0];
  }
}

// s[i] = the LRN window sum around channel i of the tile row r (r[j] is
// the vector's channel j, the tile's zero halo the clipped slots): slots
// r[i + m - lo], m = 0 .. n-1, added in ascending m from slot 0 with
// __fadd_rn; kSquare sums squares (the denominator's), else values (q).
// kN > 0 fixes n at compile time (V = 4: the window as aligned 16-byte
// loads); kN = 0 reads it from p.
template <int V, int kN, bool kSquare>
__device__ __forceinline__ void window_sums(const float* r,
                                            const LrnParams& p,
                                            float (&s)[V]) {
  if constexpr (kN > 0 && V == 4) {
    constexpr int lo = (kN - 1) / 2;
    constexpr int below = (lo + 3) / 4;   // float4s left of the vector
    constexpr int nq = below + (V + kN - 1 - lo + 3) / 4;
    constexpr int base = 4 * below - lo;  // w[base + j] = r[j - lo]
    float w[4 * nq];
#pragma unroll
    for (int q = 0; q < nq; ++q) {
      const float4 v = reinterpret_cast<const float4*>(r)[q - below];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = base; j < base + V + kN - 1; ++j) {
      if (kSquare) w[j] = __fmul_rn(w[j], w[j]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float acc = w[base + i];
#pragma unroll
      for (int m = 1; m < kN; ++m) acc = __fadd_rn(acc, w[base + i + m]);
      s[i] = acc;
    }
  } else {
    const int n = kN > 0 ? kN : p.n;
    const float* b = r - (n - 1) / 2;
    float a[V];   // slot m of channel i, shifted down a slot each step
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] = kSquare ? __fmul_rn(b[i], b[i]) : b[i];
      s[i] = a[i];
    }
    for (int m = 1; m < n; ++m) {
#pragma unroll
      for (int i = 0; i + 1 < V; ++i) a[i] = a[i + 1];
      const float v = b[V - 1 + m];
      a[V - 1] = kSquare ? __fmul_rn(v, v) : v;
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = __fadd_rn(s[i], a[i]);
    }
  }
}

// Set the halo floats each side of every pixel of `tiles` consecutive
// tiles of `pixels` pixels of P = C + 2 * halo floats to 0.
__device__ __forceinline__ void zero_halos(float* tile, int tiles,
                                           int pixels, int C, int halo) {
  const int n = tiles * pixels * 2 * halo;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int j = t / (2 * halo), h = t - j * 2 * halo;
    tile[j * (C + 2 * halo) + (h < halo ? h : C + h)] = 0.0f;
  }
}

// kernel<<<blocks, threads, smem, stream>>>(args...), the kernel's dynamic
// shared-memory limit raised first where smem passes the default 48 KB;
// the launch status (cudaGetLastError) as an int, 0 on success.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 blocks, dim3 threads, int smem, void* stream,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}
