// Device math of cross-channel local-response normalization, shared by
// every LRN-bearing kernel of the port (lrn.cu, lrn_pool.cu) so that all of
// them round identically.  Rows are C contiguous channels (NHWC), and the
// reference's window is the clipped [c-(n-1)/2, c+n/2]:
//
//   d_c  = k + alpha * sum_{j in win(c)} x_j^2
//   p_c  = d_c^-beta
//   y_c  = x_c * p_c
//   dx_c = err_c * p_c - (2*alpha*beta) * x_c * sum_{j in win(c)} q_j,
//   q_j  = err_j * x_j * (p_j / d_j)
//
// d^-beta is 1/(sqrt(d)*sqrt(sqrt(d))) for beta = 0.75 (every shipped
// config; correctly rounded ops, so bit-equal to the reference's tiers:
// __frcp_rn is the correctly rounded 1/v, as __fdiv_rn(1.0f, v), in fewer
// instructions) and powf(d, -beta) otherwise.  Every window sum is taken
// in ascending channel order starting from the first window slot, a
// clipped slot adding 0.0f exactly as the reference's zero-padded shifted
// slices do; k + alpha*s, the sums and the products are
// __fadd_rn/__fmul_rn/__fdiv_rn so nvcc cannot contract them into FMAs
// (numpy and XLA round each step).

#pragma once

#include <cuda_runtime.h>

#include "fastdiv.cuh"
#include "narrow.cuh"

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

__device__ __forceinline__ float lrn_dpow_nbeta(float d, const LrnParams& p) {
  if (p.beta_075) {
    const float r = __fsqrt_rn(d);
    return __frcp_rn(__fmul_rn(r, __fsqrt_rn(r)));
  }
  return powf(d, p.neg_beta);
}

// d = k + alpha * s, s the window sum of x^2
__device__ __forceinline__ float lrn_d(float s, const LrnParams& p) {
  return __fadd_rn(p.k, __fmul_rn(p.alpha, s));
}

// d_c = k + alpha * (window sum of x^2 around channel c of row xr), x in
// float or a narrow storage type (narrow.cuh), converted at the load
template <typename T>
__device__ __forceinline__ float lrn_denom(const T* __restrict__ xr, int c,
                                           const LrnParams& p) {
  float s = 0.0f;
  for (int m = 0; m < p.n; ++m) {
    const int j = c + m - p.half_lo;
    float v = 0.0f;
    if (j >= 0 && j < static_cast<int>(p.C.d)) {
      const float xj = to_f32(xr[j]);
      v = __fmul_rn(xj, xj);
    }
    s = (m == 0) ? v : __fadd_rn(s, v);
  }
  return lrn_d(s, p);
}

// y_c = x_c * d_c^-beta for channel c of row xr
template <typename T>
__device__ __forceinline__ float lrn_y_at(const T* __restrict__ xr, int c,
                                          const LrnParams& p) {
  return __fmul_rn(to_f32(xr[c]), lrn_dpow_nbeta(lrn_denom(xr, c, p), p));
}

// q_c = err_c * x_c * (p_c / d_c)
__device__ __forceinline__ float lrn_q(float err, float x, float d,
                                       float pc) {
  return __fmul_rn(__fmul_rn(err, x), __fdiv_rn(pc, d));
}

// the window sum of q around channel c of the tile row qr
__device__ __forceinline__ float lrn_q_window(const float* qr, int c,
                                              const LrnParams& p) {
  const int C = static_cast<int>(p.C.d);
  float ws = 0.0f;
  for (int m = 0; m < p.n; ++m) {
    const int j = c + m - p.half_lo;
    const float q = (j >= 0 && j < C) ? qr[j] : 0.0f;
    ws = (m == 0) ? q : __fadd_rn(ws, q);
  }
  return ws;
}

// dx_c = err_c * p_c - two_ab * x_c * ws, given ep = err_c * p_c
__device__ __forceinline__ float lrn_dx(float ep, float x, float ws,
                                        const LrnParams& p) {
  return __fsub_rn(ep, __fmul_rn(__fmul_rn(p.two_ab, x), ws));
}

inline LrnParams make_lrn_params(int C, int n, double alpha, double beta,
                                 double k) {
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
