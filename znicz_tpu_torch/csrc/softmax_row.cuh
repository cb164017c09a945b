// Row machinery shared by the two softmax heads (softmax.cu, softmax_ce.cu).
//
// A row of C float32 values is held by a team of threads:
//
// - G lanes (G a power of two, 1-32) in the narrow form (C <= 32): several
//   rows a warp, blockDim.x / G rows a block, the reductions log2(G)
//   shuffle steps within the group;
// - the whole block (G = 0) in the register and streaming forms: one row a
//   block, each reduction a warp's shuffles, one barrier, and every thread
//   combining the warps' partials in warp order from shared memory (so all
//   threads hold the same bits).
//
// A team member loads V = 4 floats at a time (16-byte vectors) where the C
// entry points allow it, else V = 1.  Member r of a team of `size` holds
// the vectors r, r + size, r + 2 size, ...: neighbouring threads read
// neighbouring addresses.
//
// The row softmax's argmax is the first index of the maximum, with NaN
// above everything (as torch.argmax and jnp.argmax): the maximum is reduced
// as a value with a flag for NaN, then each member's first index of it
// (of a NaN where it is NaN) is reduced, as a minimum, beside the sum.  No
// index rides through the maximum's steps.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace softmax_row {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// partials a block reduction keeps in shared memory (1024 threads)
constexpr int kMaxWarps = 32;

// the forms, numbered as ops/softmax.py FORMS names them
constexpr int kNarrow = 0;
constexpr int kRegister = 1;
constexpr int kStreaming = 2;

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// -- the team of a row -------------------------------------------------------
__device__ __forceinline__ int warps() {
  return static_cast<int>(blockDim.x) / kWarp;
}

template <int G>
__device__ __forceinline__ int team_rank() {
  if constexpr (G == 0) return static_cast<int>(threadIdx.x);
  else return threadIdx.x & (G - 1);
}

template <int G>
__device__ __forceinline__ int team_size() {
  if constexpr (G == 0) return static_cast<int>(blockDim.x);
  else return G;
}

template <int G>
__device__ __forceinline__ long long team_row() {
  if constexpr (G == 0) return blockIdx.x;
  else
    return static_cast<long long>(blockIdx.x) * (blockDim.x / G) +
           threadIdx.x / G;
}

// Shuffle steps over the lowest `width` lanes' groups: after them every
// lane of a group of `width` holds the group's result, the same bits in
// each lane (each step's two operands are the same pair).
template <int width>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int width>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Whether any lane of this lane's group of `width` holds p.
template <int width>
__device__ __forceinline__ bool lanes_any(bool p) {
  const unsigned b = __ballot_sync(kFull, p);
  if constexpr (width == kWarp) {
    return b != 0u;
  } else {
    const int first = (threadIdx.x % kWarp) & ~(width - 1);
    return ((b >> first) & ((1u << width) - 1u)) != 0u;
  }
}

// The team's reductions.  G > 0: the group's shuffles.  G == 0: the warp's
// shuffles, lane 0's partial into `slots`, one barrier, and each thread's
// walk over the warps' partials in order.  Each block reduction takes
// slots of its own, so one follows another without a second barrier.
template <int G>
__device__ __forceinline__ float team_max(float v, float* slots) {
  if constexpr (G > 0) {
    return lanes_max<G>(v);
  } else {
    v = lanes_max<kWarp>(v);
    if (threadIdx.x % kWarp == 0) slots[threadIdx.x / kWarp] = v;
    __syncthreads();
    float r = slots[0];
    for (int w = 1; w < warps(); ++w) r = fmaxf(r, slots[w]);
    return r;
  }
}

// The maximum with NaN above everything: fmaxf's reduction, NaN where any
// member saw one (`nan`).
template <int G>
__device__ __forceinline__ float team_max_nan(float m, bool nan,
                                              float* slots, int* flags) {
  if constexpr (G > 0) {
    nan = lanes_any<G>(nan);
    m = lanes_max<G>(m);
  } else {
    m = lanes_max<kWarp>(m);
    nan = __any_sync(kFull, nan);
    if (threadIdx.x % kWarp == 0) {
      slots[threadIdx.x / kWarp] = m;
      flags[threadIdx.x / kWarp] = nan;
    }
    __syncthreads();
    m = slots[0];
    nan = flags[0] != 0;
    for (int w = 1; w < warps(); ++w) {
      m = fmaxf(m, slots[w]);
      nan = nan || flags[w] != 0;
    }
  }
  return nan ? CUDART_NAN_F : m;
}

// The sum of v and the least a, in one reduction.
template <int G>
__device__ __forceinline__ float team_sum_min(float v, int& a, float* slots,
                                              int* args) {
  constexpr int width = G > 0 ? G : kWarp;
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
    a = min(a, __shfl_xor_sync(kFull, a, off));
  }
  if constexpr (G == 0) {
    if (threadIdx.x % kWarp == 0) {
      slots[threadIdx.x / kWarp] = v;
      args[threadIdx.x / kWarp] = a;
    }
    __syncthreads();
    v = slots[0];
    a = args[0];
    for (int w = 1; w < warps(); ++w) {
      v += slots[w];
      a = min(a, args[w]);
    }
  }
  return v;
}

// The sum of v and whether any member holds p, in one reduction.
template <int G>
__device__ __forceinline__ float team_sum_any(float v, bool& p, float* slots,
                                              int* flags) {
  if constexpr (G > 0) {
    p = lanes_any<G>(p);
    return lanes_sum<G>(v);
  } else {
    v = lanes_sum<kWarp>(v);
    p = __any_sync(kFull, p);
    if (threadIdx.x % kWarp == 0) {
      slots[threadIdx.x / kWarp] = v;
      flags[threadIdx.x / kWarp] = p;
    }
    __syncthreads();
    float r = slots[0];
    bool any = flags[0] != 0;
    for (int w = 1; w < warps(); ++w) {
      r += slots[w];
      any = any || flags[w] != 0;
    }
    p = any;
    return r;
  }
}

// -- choosing an instance ----------------------------------------------------
// The narrow form's instance <G, V, K> for K vectors a lane, K a power of
// two with G * V * K <= 32 (a row of at most 32 floats); nullptr where none
// is compiled.
template <class Fn, template <int, int, int> class Narrow, int G, int V,
          int K>
Fn narrow_instance(int per) {
  if constexpr (G * V * K > kWarp) {
    return nullptr;
  } else {
    if (per == K) return Narrow<G, V, K>::get();
    return narrow_instance<Fn, Narrow, G, V, K * 2>(per);
  }
}

template <class Fn, template <int, int, int> class Narrow, int V>
Fn narrow_kernel(int group, int per) {
  switch (group) {
    case 1: return narrow_instance<Fn, Narrow, 1, V, 1>(per);
    case 2: return narrow_instance<Fn, Narrow, 2, V, 1>(per);
    case 4: return narrow_instance<Fn, Narrow, 4, V, 1>(per);
    case 8: return narrow_instance<Fn, Narrow, 8, V, 1>(per);
    case 16: return narrow_instance<Fn, Narrow, 16, V, 1>(per);
    case 32: return narrow_instance<Fn, Narrow, 32, V, 1>(per);
    default: return nullptr;
  }
}

// the register form holds at most this many floats a thread
constexpr int kRegisterFloats = 16;

// The register form's instance <0, V, K>, K a power of two with V * K <=
// kRegisterFloats; nullptr where none is compiled.
template <class Fn, template <int, int, int> class Rows, int V, int K>
Fn register_kernel(int per) {
  if constexpr (V * K > kRegisterFloats) {
    return nullptr;
  } else {
    if (per == K) return Rows<0, V, K>::get();
    return register_kernel<Fn, Rows, V, K * 2>(per);
  }
}

// The kernel of a plan: the narrow form's <G, V, K> (G = group, K = per),
// the register form's <0, V, K> or the streaming form's <V>; nullptr where
// none is compiled.
template <class Fn, template <int, int, int> class Rows,
          template <int> class Stream>
Fn pick_kernel(int form, int group, int vec, int per) {
  if (vec != 1 && vec != 4) return nullptr;
  if (form == kNarrow)
    return vec == 4 ? narrow_kernel<Fn, Rows, 4>(group, per)
                    : narrow_kernel<Fn, Rows, 1>(group, per);
  if (form == kRegister)
    return vec == 4 ? register_kernel<Fn, Rows, 4, 1>(per)
                    : register_kernel<Fn, Rows, 1, 1>(per);
  if (form == kStreaming) return vec == 4 ? Stream<4>::get() : Stream<1>::get();
  return nullptr;
}

// The blocks of a launch over n rows, or 0 where the plan does not fit the
// rows: threads a whole number of warps up to 1024; the narrow form's row
// within G * V * per slots (G rows a warp's group, threads / G rows a
// block); the register form's within threads * V * per (a row a block);
// the streaming form any row (a row a block).  Vectors (V = 4) only where
// C % 4 == 0 and every base is 16-byte aligned: a plan that asks for them
// elsewhere is refused, never narrowed.
inline long long plan_blocks(int n, int c, int form, int threads, int group,
                             int vec, int per, bool aligned) {
  if (n <= 0 || c <= 0) return 0;
  if (threads < kWarp || threads > kMaxWarps * kWarp || threads % kWarp)
    return 0;
  if (vec == 4 && (c % 4 != 0 || !aligned)) return 0;
  const long long held = static_cast<long long>(vec) * per;
  if (form == kNarrow) {
    if (group < 1 || held * group < c) return 0;
    const int rows = threads / group;
    return (static_cast<long long>(n) + rows - 1) / rows;
  }
  if (form == kRegister && held * threads < c) return 0;
  return n;
}

}  // namespace softmax_row
