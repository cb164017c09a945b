// Cross-channel local-response normalization, forward and backward, in
// two forms: y only with the denominator recomputed in the backward (the
// fused train step), and y plus the denominator d, cached for the
// backward (the unit graph's LRNormalizerForward / LRNormalizerBackward).
// All work on rows = B*H*W contiguous pixels of C channels (NHWC), with
// the reference's clipped window [c-(n-1)/2, c+n/2] on the channel axis:
//
//   d_c  = k + alpha * sum_{j in win(c)} x_j^2
//   y_c  = x_c * d_c^-beta
//   dx_c = err_c * d_c^-beta
//          - (2*alpha*beta) * x_c * sum_{j in win(c)} err_j*x_j*(d_j^-beta / d_j)
//
// d^-beta is 1/(sqrt(d)*sqrt(sqrt(d))) for beta = 0.75 (every shipped
// config; correctly rounded ops, so bit-equal to the reference's tiers) and
// powf(d, -beta) otherwise.  The backward uses the forward's window even
// for an even n, as the reference's formula does.
//
// lrn_y_kernel (with its warp and direct forms) replaces the TPU kernel
// znicz_tpu/ops/elementwise.py pallas_lrn_y (_lrn_fwd_y_kernel);
// gd_lrn_x_kernel (and its warp form) replaces pallas_gd_lrn_x
// (_lrn_bwd_x_kernel).  lrn_kernel replaces pallas_lrn
// (_lrn_fwd_kernel) and gd_lrn_kernel pallas_gd_lrn (_lrn_bwd_kernel): the
// same math, with d written by the forward and read by the backward
// instead of recomputed from x.
//
// Bound on an H100: bytes, then the rounding chain.  At the CIFAR step,
// (100,16,16,32), the forward reads and writes 3.3 MB each (~2.0 us at
// 3.35 TB/s) and the backward reads 6.6 MB and writes 3.3 MB (~2.9 us);
// the cached-d forms move one more 3.3 MB tensor each (~2.9 us, ~3.9 us).
// Each element also runs a chain of correctly rounded operations (two
// square roots and a reciprocal for d^-0.75, backward also a divide p/d)
// that nvcc emits as branch regions of their own, so the chains of a
// thread's channels do not interleave: at 819,200 elements that is of the
// order of the bytes' time.
//
// Design of the recompute pair, the fused LRN->max-pool pair's
// (lrn_pool.cu) without the pooling.  The launch (vector width, threads_x,
// pixels, shared bytes) is ops/normalization.py lrn_plan's; the width and
// the form are checked and picked here.
//
// - Tile form (lrn_y_kernel<V, kN>, gd_lrn_x_kernel<V, kN>): a block of
//   threads_x x pixels threads takes `pixels` consecutive pixels, one a row
//   of threads (blockIdx.x * pixels + threadIdx.y), and a thread takes V =
//   4 consecutive channels as one 16-byte vector (threadIdx.x * V, then
//   every threads_x * V channels), so no index is divided.  x is read once
//   into a shared tile with `halo` zeros on each side of every pixel
//   (lrn_vec.cuh), so each window sum (lrn_vec.cuh window_sums, aligned
//   16-byte loads of the tile under kN = 5) needs no bounds test and each
//   x^2 comes from the tile, not from n global loads.  Forward: d, p =
//   d^-beta and y = x*p, one 16-byte store.  Backward: q = err*x*(p/d) and
//   err*p of each element once, q into a zero-haloed q row and err*p into
//   a row of its own; after one barrier the window of q gives dx, one
//   16-byte store.  kN = 5 is the window fixed at compile time (every
//   shipped config), kN = 0 any n.
// - Warp form (lrn_y_warp_kernel, gd_lrn_x_warp_kernel), where a warp holds
//   whole pixels (n = 5, a pixel's C / 4 threads dividing 32: CIFAR's 8
//   threads a pixel): x and err stay in registers, and the one vector on
//   each side that a window needs comes from the neighbouring threads by
//   __shfl_up_sync/__shfl_down_sync (zeros past the pixel's edges), q's
//   likewise; no tile and no barrier.
// - V = 1, the scalar form, where C % 4 != 0 or a base is not 16-byte
//   aligned (decided here), and for a small tensor (the plan's choice):
//   there a thread's latency, not the bytes, sets the time, and one
//   channel a thread runs a quarter of the vector form's chain of rounded
//   operations in a row.  A small tensor's forward runs one thread an
//   element of the flat index that reads its window straight from global
//   memory (lrn_y_direct_kernel, the channel by FastDiv: no tile, no
//   barrier).
//
// The cached forms keep one thread per element (lrn_kernel, its y bit for
// bit lrn_y_kernel's) and a block of whole rows in two passes through
// shared memory (gd_lrn_kernel: pass 1 q and p once per element from the
// cached d, pass 2 the window of q), the channel found through FastDiv
// (fastdiv.cuh); gd_lrn_kernel's tile limits C to 6144 channels (48 KB).
// Index arithmetic is 32-bit (the wrappers refuse 2^31 elements or more).
//
// The math (window sums, d^-beta, rounding) is csrc/lrn_math.cuh, shared
// with the fused LRN->max-pool kernels of lrn_pool.cu.
//
// The recompute pair takes x (and the forward writes y) in the fused step's
// storage type T (float, __nv_bfloat16 or __half; narrow.cuh): x converted
// to float where it is loaded, y rounded once where it is stored; err and
// dx are float.  Its entry points carry the type's suffix.

#include <cuda_runtime.h>

#include <cstdint>

#include "lrn_math.cuh"
#include "lrn_vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxThreads = 1024;

// Zero the halo floats each side of the tile row `row` (its channel 0).
__device__ __forceinline__ void zero_row_halos(float* row, int C, int halo) {
  for (int h = threadIdx.x; h < halo; h += blockDim.x) {
    row[h - halo] = 0.0f;
    row[C + h] = 0.0f;
  }
}

// The pixel's C channels at src (float or narrow) into the float tile row
// `row`, V a thread.
template <int V, typename T>
__device__ __forceinline__ void fill_row(float* row, const T* src, int C) {
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float v[V];
    load_vec<V>(src + c, v);
    store_vec<V>(row + c, v);
  }
}

// 4 consecutive values at p (16-byte aligned float or 8-byte aligned
// narrow) as a float4
template <typename T>
__device__ __forceinline__ float4 load4f(const T* p) {
  if constexpr (kNarrow<T>) {
    float v[4];
    load_vec<4>(p, v);
    return make_float4(v[0], v[1], v[2], v[3]);
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}

template <int V, int kN, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_y_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                 int halo, LrnParams p) {
  extern __shared__ float4 smem4[];
  const int C = p.C.d;
  float* xs = reinterpret_cast<float*>(smem4) + threadIdx.y * (C + 2 * halo)
              + halo;
  const int pix = blockIdx.x * blockDim.y + threadIdx.y;
  if (pix < rows) {
    zero_row_halos(xs, C, halo);
    fill_row<V>(xs, x + pix * C, C);
  }
  __syncthreads();
  if (pix >= rows) return;
  T* yr = y + pix * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float s[V], xa[V], ya[V];
    window_sums<V, kN, true>(xs + c, p, s);
    load_vec<V>(xs + c, xa);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ya[i] = __fmul_rn(xa[i], lrn_dpow_nbeta(lrn_d(s[i], p), p));
    }
    store_vec<V>(yr + c, ya);
  }
}

// The forward of a small tensor: a thread takes one element of the flat
// index (its channel by FastDiv) and reads its window from global memory
// (lrn_math.cuh lrn_y_at, the cache holding the neighbours), with no tile
// and no barrier in its way.  At that size a thread's latency sets the
// time, and the flat index measured faster than a row of threads a pixel.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_y_direct_kernel(const T* __restrict__ x, T* __restrict__ y,
                        int total, LrnParams p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = e - p.C.div(e) * p.C.d;
  y[e] = lrn_y_at(x + (e - c), c, p);
}

// Shared memory: the x rows and the q rows of the block's pixels (each
// C + 2 * halo floats, zero-haloed), then their err * p rows (C floats).
template <int V, int kN, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gd_lrn_x_kernel(const float* __restrict__ err, const T* __restrict__ x,
                    float* __restrict__ dx, int rows, int halo,
                    LrnParams p) {
  extern __shared__ float4 smem4[];
  const int C = p.C.d, P = C + 2 * halo;
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + threadIdx.y * P + halo;
  float* qs = smem + (blockDim.y + threadIdx.y) * P + halo;
  float* eps = smem + 2 * blockDim.y * P + threadIdx.y * C;
  const int pix = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = pix < rows;
  if (live) {
    zero_row_halos(xs, C, halo);
    zero_row_halos(qs, C, halo);
    fill_row<V>(xs, x + pix * C, C);
  }
  __syncthreads();   // the x row is in
  if (live) {
    const float* er = err + pix * C;
    for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
      float s[V], xa[V], e[V], qa[V], ep[V];
      window_sums<V, kN, true>(xs + c, p, s);
      load_vec<V>(xs + c, xa);
      load_vec<V>(er + c, e);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = lrn_d(s[i], p);
        const float pc = lrn_dpow_nbeta(d, p);
        qa[i] = lrn_q(e[i], xa[i], d, pc);
        ep[i] = __fmul_rn(e[i], pc);
      }
      store_vec<V>(qs + c, qa);
      store_vec<V>(eps + c, ep);
    }
  }
  __syncthreads();   // the q row is in
  if (!live) return;
  float* dxr = dx + pix * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float ws[V], xa[V], ep[V], out[V];
    window_sums<V, kN, false>(qs + c, p, ws);
    load_vec<V>(xs + c, xa);
    load_vec<V>(eps + c, ep);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = lrn_dx(ep[i], xa[i], ws[i], p);
    store_vec<V>(dxr + c, out);
  }
}

// The neighbours' vectors of v where a pixel's C / 4 threads share a warp:
// win[0] the vector below v (threadIdx.x - 1), win[2] the one above, zeros
// past the pixel's edges; win[1] = v.  Every thread of the warp calls it.
__device__ __forceinline__ void warp_window(float4 v, float4 (&win)[3]) {
  const unsigned m = 0xffffffffu;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 lo = make_float4(
      __shfl_up_sync(m, v.x, 1), __shfl_up_sync(m, v.y, 1),
      __shfl_up_sync(m, v.z, 1), __shfl_up_sync(m, v.w, 1));
  const float4 hi = make_float4(
      __shfl_down_sync(m, v.x, 1), __shfl_down_sync(m, v.y, 1),
      __shfl_down_sync(m, v.z, 1), __shfl_down_sync(m, v.w, 1));
  win[0] = threadIdx.x == 0 ? z : lo;
  win[1] = v;
  win[2] = threadIdx.x + 1 == blockDim.x ? z : hi;
}

// The warp form of lrn_y_kernel<4, 5>: a pixel's C / 4 threads share a
// warp, so a thread takes its window's neighbours (within 4 channels) from
// the next threads' registers; no tile, no barrier.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_y_warp_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                      int, LrnParams p) {
  const int C = p.C.d, c = threadIdx.x * 4;
  const int pix = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = pix < rows;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) v = load4f(x + pix * C + c);
  float4 win[3];
  warp_window(v, win);
  const float xa[4] = {v.x, v.y, v.z, v.w};
  float s[4], ya[4];
  window_sums<4, 5, true>(reinterpret_cast<const float*>(&win[1]), p, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ya[i] = __fmul_rn(xa[i], lrn_dpow_nbeta(lrn_d(s[i], p), p));
  }
  if (live) store_vec<4>(y + pix * C + c, ya);
}

// The warp form of gd_lrn_x_kernel<4, 5>: x's and q's neighbours from the
// next threads' registers.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gd_lrn_x_warp_kernel(const float* __restrict__ err,
                         const T* __restrict__ x, float* __restrict__ dx,
                         int rows, int, LrnParams p) {
  const int C = p.C.d, c = threadIdx.x * 4;
  const int pix = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = pix < rows;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), ev = v;
  if (live) {
    v = load4f(x + pix * C + c);
    ev = *reinterpret_cast<const float4*>(err + pix * C + c);
  }
  float4 win[3];
  warp_window(v, win);
  const float xa[4] = {v.x, v.y, v.z, v.w}, e[4] = {ev.x, ev.y, ev.z, ev.w};
  float s[4], qa[4], ep[4], ws[4], out[4];
  window_sums<4, 5, true>(reinterpret_cast<const float*>(&win[1]), p, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = lrn_d(s[i], p);
    const float pc = lrn_dpow_nbeta(d, p);
    qa[i] = lrn_q(e[i], xa[i], d, pc);
    ep[i] = __fmul_rn(e[i], pc);
  }
  warp_window(make_float4(qa[0], qa[1], qa[2], qa[3]), win);
  window_sums<4, 5, false>(reinterpret_cast<const float*>(&win[1]), p, ws);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = lrn_dx(ep[i], xa[i], ws[i], p);
  if (live) store_vec<4>(dx + pix * C + c, out);
}

// y and d = k + alpha * (window sum of x^2), in the order lrn_y_kernel
// takes
__global__ void lrn_kernel(const float* __restrict__ x, float* __restrict__ y,
                           float* __restrict__ d, int total, LrnParams p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = e - p.C.div(e) * p.C.d;
  const float de = lrn_denom(x + (e - c), c, p);
  d[e] = de;
  y[e] = __fmul_rn(x[e], lrn_dpow_nbeta(de, p));
}

// One block per `rows_per_block` rows of C channels; shared memory holds
// q and p = d^-beta for each element of those rows, from the forward's d.
__global__ void gd_lrn_kernel(const float* __restrict__ err,
                              const float* __restrict__ x,
                              const float* __restrict__ dcache,
                              float* __restrict__ dx, int rows,
                              int rows_per_block, LrnParams p) {
  extern __shared__ float tile[];
  const int C = p.C.d;
  float* q_s = tile;
  float* p_s = tile + rows_per_block * C;
  const int row0 = blockIdx.x * rows_per_block;
  const int n_el = min(rows_per_block, rows - row0) * C;
  const float* xb = x + row0 * C;
  const float* eb = err + row0 * C;
  for (int t = threadIdx.x; t < n_el; t += blockDim.x) {
    const float d = dcache[row0 * C + t];
    const float pc = lrn_dpow_nbeta(d, p);
    q_s[t] = lrn_q(eb[t], xb[t], d, pc);
    p_s[t] = pc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_el; t += blockDim.x) {
    const int c = t - p.C.div(t) * C;
    const float ws = lrn_q_window(q_s + (t - c), c, p);
    dx[row0 * C + t] = lrn_dx(__fmul_rn(eb[t], p_s[t]), xb[t], ws, p);
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The vector width of the recompute pair: 4 where C % 4 == 0 and every
// base is 16-byte aligned, else 1; and the halo of its tile rows, the
// window's wider side (n - 1 - (n - 1) / 2) rounded up to whole vectors.
int vec_width(int C, bool aligned) { return C % 4 == 0 && aligned ? 4 : 1; }

int halo_for(int n, int vec) {
  return (n - 1 - (n - 1) / 2 + vec - 1) / vec * vec;
}

// The warp form runs where a warp holds whole pixels: the vector form, n =
// 5 (the window within one vector each side), a pixel's C / 4 threads
// dividing 32 and the block whole warps.
bool warp_rows(int C, int vec, int n, int threads_x, int pixels) {
  return vec == 4 && n == 5 && C == 4 * threads_x && 32 % threads_x == 0 &&
         threads_x * pixels % 32 == 0;
}

template <typename T>
using ForwardKernel = void (*)(const T*, T*, int, int, LrnParams);
template <typename T>
using BackwardKernel = void (*)(const float*, const T*, float*, int, int,
                                LrnParams);

// The kernel instance: the warp form, or the tile's with V = 4 or 1 and n
// = 5 fixed at compile time (every shipped config's; under V = 1 the
// window loop unrolled) or read at run time.
template <typename T>
ForwardKernel<T> forward_kernel(int vec, int n, bool warp) {
  if (warp) return lrn_y_warp_kernel<T>;
  if (vec == 4) return n == 5 ? lrn_y_kernel<4, 5, T> : lrn_y_kernel<4, 0, T>;
  return n == 5 ? lrn_y_kernel<1, 5, T> : lrn_y_kernel<1, 0, T>;
}

template <typename T>
BackwardKernel<T> backward_kernel(int vec, int n, bool warp) {
  if (warp) return gd_lrn_x_warp_kernel<T>;
  if (vec == 4) {
    return n == 5 ? gd_lrn_x_kernel<4, 5, T> : gd_lrn_x_kernel<4, 0, T>;
  }
  return n == 5 ? gd_lrn_x_kernel<1, 5, T> : gd_lrn_x_kernel<1, 0, T>;
}

template <typename T>
int lrn_y(const T* x, T* y, int rows, int C, int n, double alpha,
          double beta, double k, int plan_vec, int direct, int threads_x,
          int pixels, int smem, void* stream) {
  if (rows <= 0 || C <= 0) return 0;
  const LrnParams p = make_lrn_params(C, n, alpha, beta, k);
  const int vec =
      plan_vec == 4 ? vec_width(C, aligned16(x) && aligned16(y)) : 1;
  if (direct && vec == 1) {   // a small tensor: one thread an element
    const int threads = threads_x * pixels, total = rows * C;
    return launch(lrn_y_direct_kernel<T>, (total + threads - 1) / threads,
                  threads, 0, stream, x, y, total, p);
  }
  const bool warp = warp_rows(C, vec, n, threads_x, pixels);
  return launch(forward_kernel<T>(vec, n, warp),
                (rows + pixels - 1) / pixels, dim3(threads_x, pixels),
                warp ? 0 : smem, stream, x, y, rows, halo_for(n, vec), p);
}

template <typename T>
int gd_lrn_x(const float* err, const T* x, float* dx, int rows, int C,
             int n, double alpha, double beta, double k, int plan_vec,
             int threads_x, int pixels, int smem, void* stream) {
  if (rows <= 0 || C <= 0) return 0;
  const int vec =
      plan_vec == 4
          ? vec_width(C, aligned16(err) && aligned16(x) && aligned16(dx))
          : 1;
  const bool warp = warp_rows(C, vec, n, threads_x, pixels);
  return launch(backward_kernel<T>(vec, n, warp),
                (rows + pixels - 1) / pixels, dim3(threads_x, pixels),
                warp ? 0 : smem, stream, err, x, dx, rows, halo_for(n, vec),
                make_lrn_params(C, n, alpha, beta, k));
}

}  // namespace

// All entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int, 0 on success.  The recompute
// pair takes the plan of ops/normalization.py lrn_plan (n clipped to
// 2C + 1, the vector width it asks for, threads_x, pixels, smem: the
// tile's shared bytes at that width, which cover the scalar form's); the
// vector form runs only where C and the pointers allow it, and the form
// (warp or tile) follows from the rest.

#define ZNICZ_LRN_ENTRIES(T, SFX)                                          \
  extern "C" int znicz_lrn_y_##SFX(                                         \
      const T* x, T* y, int rows, int C, int n, double alpha, double beta,  \
      double k, int plan_vec, int direct, int threads_x, int pixels,        \
      int smem, void* stream) {                                             \
    return lrn_y<T>(x, y, rows, C, n, alpha, beta, k, plan_vec, direct,     \
                    threads_x, pixels, smem, stream);                       \
  }                                                                         \
  extern "C" int znicz_gd_lrn_x_##SFX(                                      \
      const float* err, const T* x, float* dx, int rows, int C, int n,      \
      double alpha, double beta, double k, int plan_vec, int threads_x,     \
      int pixels, int smem, void* stream) {                                 \
    return gd_lrn_x<T>(err, x, dx, rows, C, n, alpha, beta, k, plan_vec,    \
                       threads_x, pixels, smem, stream);                    \
  }

ZNICZ_FOR_EACH_STORAGE(ZNICZ_LRN_ENTRIES)

extern "C" int znicz_lrn_f32(const float* x, float* y, float* d, int rows,
                             int C, int n, double alpha, double beta,
                             double k, void* stream) {
  const int total = rows * C;
  if (total <= 0) return 0;
  lrn_kernel<<<blocks_for(total), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      x, y, d, total, make_lrn_params(C, n, alpha, beta, k));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int znicz_gd_lrn_f32(const float* err, const float* x,
                                const float* d, float* dx, int rows, int C,
                                int n, double alpha, double beta, double k,
                                void* stream) {
  if (rows <= 0 || C <= 0) return 0;
  const int rows_per_block = C >= kThreads ? 1 : kThreads / C;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * sizeof(float) * rows_per_block * C;
  gd_lrn_kernel<<<blocks, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      err, x, d, dx, rows, rows_per_block,
      make_lrn_params(C, n, alpha, beta, k));
  return static_cast<int>(cudaGetLastError());
}
