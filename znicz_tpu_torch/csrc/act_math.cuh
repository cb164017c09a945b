// The activation formulas of the port's elementwise kernels, one rounding
// shared by every kernel that evaluates them: activation.cu's standalone
// forward and backward (act_fwd_kernel, act_bwd_kernel) and the derivative
// lrn_pool.cu folds into the fused LRN->max-pool backward (fold_act).
//
// Ids, as znicz_tpu_torch/ops/activations.py ACT_IDS (and FOLD_IDS for the
// foldable ones) numbers them.  Each formula follows the plain PyTorch
// version (the BY_NAME classes) operation by operation: every product, sum
// and quotient is a correctly rounded __f*_rn intrinsic, which nvcc never
// contracts into a fused multiply-add, the square roots __fsqrt_rn; exp,
// log, log1p, tanh, sin and cos are CUDA's expf, logf, log1pf, tanhf,
// sinf and cosf (no --use_fast_math).  Python scalars enter as the float32
// values PyTorch gives them: 1.7159 and 0.6666 rounded once, a division
// of a tensor by a host scalar as a product with its float32 reciprocal,
// and `1.0 / tensor` as a correctly rounded reciprocal.

#pragma once

namespace act_math {

enum Act {
  kLinear = 0, kStrictRelu = 1, kTanh = 2, kSigmoid = 3, kRelu = 4,
  kMul = 5, kLog = 6, kSinCos = 7, kTanhLog = 8
};

// TanhLog's threshold t, the float32 reciprocal of t, a = s_t * t and y_t,
// rounded to float32 on the host (ops/activations.py tanhlog_constants)
struct TanhLogConsts {
  float t, inv_t, a, y_t;
};

// the scaled tanh's constants 1.7159 and 0.6666, and its derivative's
// 1.7159 * 0.6666 and 0.6666 / 1.7159, rounded to float as the host
// rounds the python constants
__device__ __forceinline__ float tanh_a() { return static_cast<float>(1.7159); }
__device__ __forceinline__ float tanh_b() { return static_cast<float>(0.6666); }
__device__ __forceinline__ float tanh_d1() {
  return static_cast<float>(1.7159 * 0.6666);
}
__device__ __forceinline__ float tanh_d2() {
  return static_cast<float>(0.6666 / 1.7159);
}

__device__ __forceinline__ float scaled_tanh(float x) {
  return __fmul_rn(tanh_a(), tanhf(__fmul_rn(tanh_b(), x)));
}

// clamp(x, min=lo): x unless it is below lo
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// the derivative of a y-only activation at its output y, applied to e
__device__ __forceinline__ float fold_act(float e, float y, int act) {
  switch (act) {
    case kStrictRelu:
      return __fmul_rn(e, y > 0.0f ? 1.0f : 0.0f);
    case kTanh:
      return __fmul_rn(e, __fsub_rn(tanh_d1(),
                                    __fmul_rn(__fmul_rn(tanh_d2(), y), y)));
    case kSigmoid:
      return __fmul_rn(__fmul_rn(e, y), __fsub_rn(1.0f, y));
    case kRelu:
      return __fmul_rn(e, __fsub_rn(1.0f, expf(-y)));
    case kMul:
      return __fmul_rn(e, 1.0f);
    default:
      return e;
  }
}

// y = act(x); `even` says whether x sits at an even index of the last
// axis (sincos takes sin there, cos elsewhere)
template <int A>
__device__ __forceinline__ float act_fwd(float x, bool even,
                                         const TanhLogConsts& k) {
  switch (A) {
    case kStrictRelu:
      return clamp_min(x, 0.0f);
    case kTanh:
      return scaled_tanh(x);
    case kSigmoid:
      return __fdiv_rn(1.0f, __fadd_rn(expf(-x), 1.0f));
    case kRelu:  // softplus: max(x, 0) + log1p(exp(-|x|))
      return __fadd_rn(clamp_min(x, 0.0f), log1pf(expf(-fabsf(x))));
    case kMul:
      return __fmul_rn(x, 1.0f);
    case kLog:  // asinh as log(x + sqrt(x*x + 1))
      return logf(__fadd_rn(
          x, __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), 1.0f))));
    case kSinCos:
      return even ? sinf(x) : cosf(x);
    case kTanhLog: {
      const float ax = fabsf(x);
      if (ax <= k.t) return scaled_tanh(x);
      const float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
      const float l = logf(__fmul_rn(clamp_min(ax, k.t), k.inv_t));
      return __fmul_rn(s, __fadd_rn(__fmul_rn(k.a, l), k.y_t));
    }
    default:
      return x;
  }
}

// err_x from err_y = e, the output y and the input x
template <int A>
__device__ __forceinline__ float act_bwd(float e, float y, float x, bool even,
                                         const TanhLogConsts& k) {
  switch (A) {
    case kLog:
      return __fdiv_rn(e, __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), 1.0f)));
    case kSinCos:
      return __fmul_rn(e, even ? cosf(x) : -sinf(x));
    case kTanhLog: {
      const float ax = fabsf(x);
      float d;
      if (ax <= k.t) {
        const float th = tanhf(__fmul_rn(tanh_b(), x));
        d = __fmul_rn(tanh_d1(), __fsub_rn(1.0f, __fmul_rn(th, th)));
      } else {
        d = __fmul_rn(__fdiv_rn(1.0f, clamp_min(ax, k.t)), k.a);
      }
      return __fmul_rn(e, d);
    }
    default:
      return fold_act(e, y, A);
  }
}

}  // namespace act_math
