// Cross-channel local-response normalization, forward and backward, in
// two forms: y only with the denominator recomputed in the backward (the
// fused train step), and y plus the denominator d, cached for the
// backward (the unit graph's LRNormalizerForward / LRNormalizerBackward).
// All work on rows = B*H*W contiguous rows of C channels (NHWC), with
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
// lrn_y_kernel replaces the TPU kernel znicz_tpu/ops/elementwise.py
// pallas_lrn_y (_lrn_fwd_y_kernel); gd_lrn_kernel<false> replaces
// pallas_gd_lrn_x (_lrn_bwd_x_kernel).  lrn_kernel replaces pallas_lrn
// (_lrn_fwd_kernel) and gd_lrn_kernel<true> pallas_gd_lrn
// (_lrn_bwd_kernel): the same math, with d written by the forward and
// read by the backward instead of recomputed from x.
//
// Bound on an H100: bytes.  At the CIFAR step, (100,16,16,32), the forward
// reads and writes 3.3 MB each (~2.0 us at 3.35 TB/s) and the backward
// reads 6.6 MB and writes 3.3 MB (~2.9 us), against ~2 float operations
// per byte, far below the card's ~20 flop/byte float32 balance.  The
// cached-d forms move one more 3.3 MB tensor each: ~2.9 us and ~3.9 us.
//
// Design.  The forwards have one thread per element, C fastest, so a
// warp's reads are contiguous and each element's <= n neighbours hit L1;
// lrn_kernel differs from lrn_y_kernel only in also storing d, so its y
// is lrn_y_kernel's bit for bit.  The backward needs q_j = err_j*x_j*(p_j/d_j) for the <= n neighbours of each
// element; a block takes whole rows (as many as fit 256 threads, or one
// row with the threads looping) and works in two passes through shared
// memory: pass 1 computes d, p = d^-beta and q once per element into the
// tile, pass 2 sums each element's window of q from the tile.  Each
// element then pays one d^-beta (two square roots and a divide) and one
// p/d instead of n of each.  With the cached d, pass 1 reads d where the
// recompute form takes the window sum of x^2; nothing else differs.
// Index arithmetic is 32-bit (the wrappers refuse 2^31 elements or more)
// with the channel found through FastDiv (fastdiv.cuh), and the tile
// limits C to 6144 channels (48 KB of shared memory).
//
// The math (window sums, d^-beta, rounding) is csrc/lrn_math.cuh, shared
// with the fused LRN->max-pool kernels of lrn_pool.cu.

#include <cuda_runtime.h>

#include "lrn_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void lrn_y_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int total, LrnParams p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = e - p.C.div(e) * p.C.d;
  const float* xr = x + (e - c);
  y[e] = lrn_y_at(xr, c, p);
}

// y and d = k + alpha * (window sum of x^2), in the order lrn_y_at takes
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
// q and p = d^-beta for each element of those rows.  kCachedD: d is read
// from `dcache` (the forward's); otherwise it is recomputed from x.
template <bool kCachedD>
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
    const int c = t - p.C.div(t) * C;
    const float d = kCachedD ? dcache[row0 * C + t]
                             : lrn_denom(xb + (t - c), c, p);
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

}  // namespace

// All entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int, 0 on success.

extern "C" int znicz_lrn_y_f32(const float* x, float* y, int rows, int C,
                               int n, double alpha, double beta, double k,
                               void* stream) {
  const int total = rows * C;
  if (total <= 0) return 0;
  lrn_y_kernel<<<blocks_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, y, total, make_lrn_params(C, n, alpha, beta, k));
  return static_cast<int>(cudaGetLastError());
}

template <bool kCachedD>
int launch_gd_lrn(const float* err, const float* x, const float* d,
                  float* dx, int rows, int C, int n, double alpha,
                  double beta, double k, void* stream) {
  if (rows <= 0 || C <= 0) return 0;
  const int rows_per_block = C >= kThreads ? 1 : kThreads / C;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * sizeof(float) * rows_per_block * C;
  gd_lrn_kernel<kCachedD><<<blocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      err, x, d, dx, rows, rows_per_block,
      make_lrn_params(C, n, alpha, beta, k));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int znicz_gd_lrn_x_f32(const float* err, const float* x,
                                  float* dx, int rows, int C, int n,
                                  double alpha, double beta, double k,
                                  void* stream) {
  return launch_gd_lrn<false>(err, x, nullptr, dx, rows, C, n, alpha, beta,
                              k, stream);
}

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
  return launch_gd_lrn<true>(err, x, d, dx, rows, C, n, alpha, beta, k,
                             stream);
}
