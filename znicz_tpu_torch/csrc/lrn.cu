// Cross-channel local-response normalization, forward (y only) and
// backward (denominator recomputed from x), for the fused train step.
// Both work on rows = B*H*W contiguous rows of C channels (NHWC), with
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
// pallas_lrn_y (_lrn_fwd_y_kernel); gd_lrn_x_kernel replaces
// pallas_gd_lrn_x (_lrn_bwd_x_kernel).
//
// Bound on an H100: bytes.  At the CIFAR step, (100,16,16,32), the forward
// reads and writes 3.3 MB each (~2.0 us at 3.35 TB/s) and the backward
// reads 6.6 MB and writes 3.3 MB (~2.9 us), against ~2 float operations
// per byte, far below the card's ~20 flop/byte float32 balance.
//
// Design.  The forward has one thread per element, C fastest, so a warp's
// reads are contiguous and each element's <= n neighbours hit L1.  The
// backward needs q_j = err_j*x_j*(p_j/d_j) for the <= n neighbours of each
// element; a block takes whole rows (as many as fit 256 threads, or one
// row with the threads looping) and works in two passes through shared
// memory: pass 1 computes d, p = d^-beta and q once per element into the
// tile, pass 2 sums each element's window of q from the tile.  Each
// element then pays one d^-beta (two square roots and a divide) and one
// p/d instead of n of each.  Index arithmetic is 32-bit (the wrappers
// refuse 2^31 elements or more) with the channel found through FastDiv
// (fastdiv.cuh), and the tile limits C to 6144 channels (48 KB of shared
// memory).
//
// Every window sum is taken in ascending channel order starting from the
// first window slot, a clipped slot adding 0.0f exactly as the reference's
// zero-padded shifted slices do.  k + alpha*s, the sums and the products
// are written with __fadd_rn/__fmul_rn/__fdiv_rn so nvcc cannot contract
// them into FMAs (numpy and XLA round each step); sqrtf/powf are the
// accurate versions (no --use_fast_math).

#include <cuda_runtime.h>

#include "fastdiv.cuh"

namespace {

constexpr int kThreads = 256;

struct LrnParams {
  FastDiv C;        // the channel count, for the index's channel
  int n;
  int half_lo;      // (n - 1) / 2
  float alpha;      // float(alpha), as the reference rounds a python float
  float k;
  float neg_beta;   // float(-beta), the pow exponent
  float two_ab;     // float(2 * alpha * beta), folded in double first
  int beta_075;     // beta == 0.75: d^-beta as 1/(sqrt(d) * sqrt(sqrt(d)))
};

__device__ __forceinline__ float dpow_nbeta(float d, const LrnParams& p) {
  if (p.beta_075) {
    const float r = __fsqrt_rn(d);
    return __fdiv_rn(1.0f, __fmul_rn(r, __fsqrt_rn(r)));
  }
  return powf(d, p.neg_beta);
}

// d_c = k + alpha * (window sum of x^2 around channel c of row xr)
__device__ __forceinline__ float denom(const float* __restrict__ xr, int c,
                                      const LrnParams& p) {
  float s = 0.0f;
  for (int m = 0; m < p.n; ++m) {
    const int j = c + m - p.half_lo;
    float v = 0.0f;
    if (j >= 0 && j < static_cast<int>(p.C.d)) {
      const float xj = xr[j];
      v = __fmul_rn(xj, xj);
    }
    s = (m == 0) ? v : __fadd_rn(s, v);
  }
  return __fadd_rn(p.k, __fmul_rn(p.alpha, s));
}

__global__ void lrn_y_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int total, LrnParams p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = e - p.C.div(e) * p.C.d;
  const float* xr = x + (e - c);
  y[e] = __fmul_rn(xr[c], dpow_nbeta(denom(xr, c, p), p));
}

// One block per `rows_per_block` rows of C channels; shared memory holds
// q and p = d^-beta for each element of those rows.
__global__ void gd_lrn_x_kernel(const float* __restrict__ err,
                                const float* __restrict__ x,
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
    const float d = denom(xb + (t - c), c, p);
    const float pc = dpow_nbeta(d, p);
    q_s[t] = __fmul_rn(__fmul_rn(eb[t], xb[t]), __fdiv_rn(pc, d));
    p_s[t] = pc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_el; t += blockDim.x) {
    const int c = t - p.C.div(t) * C;
    const float* qr = q_s + (t - c);
    float ws = 0.0f;   // window sum of q, clipped slots adding 0.0f
    for (int m = 0; m < p.n; ++m) {
      const int j = c + m - p.half_lo;
      const float q = (j >= 0 && j < C) ? qr[j] : 0.0f;
      ws = (m == 0) ? q : __fadd_rn(ws, q);
    }
    dx[row0 * C + t] = __fsub_rn(__fmul_rn(eb[t], p_s[t]),
                                 __fmul_rn(__fmul_rn(p.two_ab, xb[t]), ws));
  }
}

LrnParams make_params(int C, int n, double alpha, double beta, double k) {
  LrnParams p;
  p.C = make_fastdiv(C);
  p.n = n;
  p.half_lo = (n - 1) / 2;
  p.alpha = static_cast<float>(alpha);
  p.k = static_cast<float>(k);
  p.neg_beta = static_cast<float>(-beta);
  p.two_ab = static_cast<float>(2.0 * alpha * beta);
  p.beta_075 = beta == 0.75;
  return p;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Both entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int, 0 on success.

extern "C" int znicz_lrn_y_f32(const float* x, float* y, int rows, int C,
                               int n, double alpha, double beta, double k,
                               void* stream) {
  const int total = rows * C;
  if (total <= 0) return 0;
  lrn_y_kernel<<<blocks_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, y, total, make_params(C, n, alpha, beta, k));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int znicz_gd_lrn_x_f32(const float* err, const float* x,
                                  float* dx, int rows, int C, int n,
                                  double alpha, double beta, double k,
                                  void* stream) {
  if (rows <= 0 || C <= 0) return 0;
  const int rows_per_block = C >= kThreads ? 1 : kThreads / C;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * sizeof(float) * rows_per_block * C;
  gd_lrn_x_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      err, x, dx, rows, rows_per_block, make_params(C, n, alpha, beta, k));
  return static_cast<int>(cudaGetLastError());
}
