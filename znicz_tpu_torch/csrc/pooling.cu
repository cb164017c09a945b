// Max / max-abs pooling forward (winner select), its backward (offset
// scatter, also the depooling forward) and the depooling backward (offset
// gather) over NHWC float32 tensors.
//
// pool_select_kernel replaces the TPU kernel znicz_tpu/ops/elementwise.py
// pallas_pool_select (_pool_select_kernel).  The reference first stacks
// the kh*kw window taps in XLA, a (T, rows, C) copy of x, and then selects
// the winner in Pallas.  Here each thread owns one output element
// (b, oh, ow, c), C fastest so a warp reads contiguous channels, and reads
// its taps straight from x: t = i*kw + j in flat row-major order, a tap
// outside the input taking the pad value (-inf, or 0 for max-abs).  The
// first tap seeds the running winner and a later tap replaces it only when
// its score (|v| for max-abs) is strictly greater, so ties keep the first
// tap and a padded tap can win exactly where the reference's does.  It
// writes the winner's signed value and its int32 slot t.
//
// pool_scatter_kernel replaces znicz_tpu/ops/elementwise.py
// pallas_pool_scatter (_pool_scatter_kernel) together with the XLA strided
// placement that follows it (znicz_tpu/ops/pooling.py _pallas_gd_max_pool).
// It is written as a gather: one thread per dx element (b, ih, iw, c)
// visits the windows (oh, ow) that contain it, computed directly from the
// geometry, in ascending order of its tap t = (ih+ph-oh*sh)*kw +
// (iw+pw-ow*sw), and adds err[b,oh,ow,c]*(offsets == t), starting from
// 0.0f.  That is the reference's summation order (zeros, then one strided
// add per tap), so the result is bit-identical, deterministic even for
// overlapping windows (stride < ksize), needs no atomics and no memset:
// every dx element is written once.
//
// Bound on an H100: bytes.  At the CIFAR step, (100,32,32,32) -> k2 s2 ->
// (100,16,16,32), select reads 13.1 MB and writes 3.3 MB of values and
// 3.3 MB of slots; scatter reads 6.6 MB and writes 13.1 MB.  Either is
// ~5.9 us at 3.35 TB/s, against ~1 compare per tap.  The design moves only
// those bytes: the tap stack and the per-tap contribution stack of the
// reference never exist, and neighbouring windows' reads of x (or of err
// and offsets) hit L1/L2.
//
// pool_gather_kernel replaces znicz_tpu/ops/elementwise.py
// pallas_pool_gather (_pool_gather_kernel) together with the XLA tap stack
// before it (znicz_tpu/ops/pooling.py gd_depooling): the adjoint of the
// scatter, out[b,oh,ow,c] = err[b, oh*sh-ph+t/kw, ow*sw-pw+t%kw, c] for the
// recorded slot t = offsets[b,oh,ow,c], and 0 where that tap falls in the
// padding (or t is outside [0, kh*kw)).  The reference stacks all kh*kw
// strided taps of err in XLA, a (T, rows, C) copy that was a device of
// Mosaic's tiling, and sums taps[t]*(offsets == t) over t in Pallas; here
// one thread per output element reads its slot and the one tap it names.
// The reference's sum adds only zeros besides that tap, so the two agree
// as values (a -0.0 may come back as +0.0) for finite err.
// Bound on an H100: bytes.  At the autoencoder's step, err (100,28,28,16)
// and slots (100,14,14,16) -> (100,14,14,16): 5.0 MB of err (counted
// whole, though one tap of each window is read), 1.3 MB of slots read and
// 1.3 MB written, ~2.25 us at 3.35 TB/s; no arithmetic beyond the index.
//
// The adds use __fadd_rn/__fmul_rn so nvcc cannot contract them into FMAs.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "fastdiv.cuh"

namespace {

constexpr int kThreads = 256;

// Index arithmetic is 32-bit (the wrappers refuse tensors of 2^31 elements
// or more), and every division is by a divisor fixed at launch, so it goes
// through FastDiv (fastdiv.cuh): a multiply, an add and a shift.

struct Geometry {
  FastDiv C, W, H, OW, OH, sh, sw, kwd;   // the divisors (kwd: kw)
  int kh, kw, ph, pw;
};

__global__ void pool_select_kernel(const float* __restrict__ x,
                                   float* __restrict__ y,
                                   int* __restrict__ offsets, int total,
                                   Geometry g, int use_abs) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int H = g.H.d, W = g.W.d, C = g.C.d, sh = g.sh.d, sw = g.sw.d;
  const int kh = g.kh, kw = g.kw, ph = g.ph, pw = g.pw;
  int r = g.C.div(o);
  const int c = o - r * C;
  int q = g.OW.div(r);
  const int ow = r - q * g.OW.d;
  const int b = g.OH.div(q);
  const int oh = q - b * g.OH.d;
  const float* xb = x + b * H * W * C + c;
  const float pad = use_abs ? 0.0f : -CUDART_INF_F;
  float best = 0.0f, best_val = 0.0f;
  int best_t = 0;
  for (int i = 0, t = 0; i < kh; ++i) {
    const int ih = oh * sh + i - ph;
    for (int j = 0; j < kw; ++j, ++t) {
      const int iw = ow * sw + j - pw;
      const float v = (ih >= 0 && ih < H && iw >= 0 && iw < W)
                          ? xb[(ih * W + iw) * C]
                          : pad;
      const float s = use_abs ? fabsf(v) : v;
      if (t == 0 || s > best) {
        best = s;
        best_val = v;
        best_t = t;
      }
    }
  }
  y[o] = best_val;
  offsets[o] = best_t;
}

// The windows holding padded row ih+ph are oh in [lo, hi] with tap row
// i = ih+ph-oh*sh in [0, kh); ascending t = i*kw + j means descending oh,
// then descending ow.
__device__ __forceinline__ void window_range(int p, int k, const FastDiv& s,
                                             int n, int* lo, int* hi) {
  const int first = p - k + 1;
  *lo = first <= 0 ? 0 : s.div(first + s.d - 1);
  *hi = min(n - 1, s.div(p));
}

__global__ void pool_scatter_kernel(const float* __restrict__ err,
                                    const int* __restrict__ offsets,
                                    float* __restrict__ dx, int total,
                                    Geometry g) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int C = g.C.d, OH = g.OH.d, OW = g.OW.d, sh = g.sh.d, sw = g.sw.d;
  const int kw = g.kw, ph = g.ph, pw = g.pw;
  int r = g.C.div(e);
  const int c = e - r * C;
  int q = g.W.div(r);
  const int iw = r - q * g.W.d;
  const int b = g.H.div(q);
  const int ih = q - b * g.H.d;
  int oh_lo, oh_hi, ow_lo, ow_hi;
  window_range(ih + ph, g.kh, g.sh, OH, &oh_lo, &oh_hi);
  window_range(iw + pw, kw, g.sw, OW, &ow_lo, &ow_hi);
  const int ob = b * OH * OW * C + c;
  float acc = 0.0f;
  for (int oh = oh_hi; oh >= oh_lo; --oh) {
    const int ti = (ih + ph - oh * sh) * kw;
    for (int ow = ow_hi; ow >= ow_lo; --ow) {
      const int o = ob + (oh * OW + ow) * C;
      const float g = err[o];
      // err * (offsets == t), as the reference multiplies: err*1 or err*0
      acc = __fadd_rn(acc, offsets[o] == ti + iw + pw - ow * sw
                               ? g : __fmul_rn(g, 0.0f));
    }
  }
  dx[e] = acc;
}

// One thread per pooled element (b, oh, ow, c), C fastest.
__global__ void pool_gather_kernel(const float* __restrict__ err,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ out, int total,
                                   Geometry g) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int H = g.H.d, W = g.W.d, C = g.C.d;
  int r = g.C.div(o);
  const int c = o - r * C;
  int q = g.OW.div(r);
  const int ow = r - q * g.OW.d;
  const int b = g.OH.div(q);
  const int oh = q - b * g.OH.d;
  const int t = offsets[o];
  float v = 0.0f;
  if (t >= 0 && t < g.kh * g.kw) {
    const int i = g.kwd.div(t);
    const int ih = oh * static_cast<int>(g.sh.d) - g.ph + i;
    const int iw = ow * static_cast<int>(g.sw.d) - g.pw + (t - i * g.kw);
    if (ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = err[((b * H + ih) * W + iw) * C + c];
  }
  out[o] = v;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

Geometry make_geometry(int H, int W, int C, int OH, int OW, int kh, int kw,
                       int sh, int sw, int ph, int pw) {
  return Geometry{make_fastdiv(C),  make_fastdiv(W),  make_fastdiv(H),
                  make_fastdiv(OW), make_fastdiv(OH), make_fastdiv(sh),
                  make_fastdiv(sw), make_fastdiv(kw), kh, kw, ph, pw};
}

}  // namespace

// All entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int, 0 on success.

extern "C" int znicz_pool_select_f32(const float* x, float* y, int* offsets,
                                     int B, int H, int W, int C, int kh,
                                     int kw, int sh, int sw, int ph, int pw,
                                     int use_abs, void* stream) {
  const int OH = (H + 2 * ph - kh) / sh + 1;
  const int OW = (W + 2 * pw - kw) / sw + 1;
  const int total = B * OH * OW * C;
  if (total <= 0) return 0;
  pool_select_kernel<<<blocks_for(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, y, offsets, total,
      make_geometry(H, W, C, OH, OW, kh, kw, sh, sw, ph, pw), use_abs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int znicz_pool_scatter_f32(const float* err, const int* offsets,
                                      float* dx, int B, int H, int W, int C,
                                      int OH, int OW, int kh, int kw, int sh,
                                      int sw, int ph, int pw, void* stream) {
  const int total = B * H * W * C;
  if (total <= 0) return 0;
  pool_scatter_kernel<<<blocks_for(total), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      err, offsets, dx, total,
      make_geometry(H, W, C, OH, OW, kh, kw, sh, sw, ph, pw));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int znicz_pool_gather_f32(const float* err, const int* offsets,
                                     float* out, int B, int H, int W, int C,
                                     int OH, int OW, int kh, int kw, int sh,
                                     int sw, int ph, int pw, void* stream) {
  const int total = B * OH * OW * C;
  if (total <= 0) return 0;
  pool_gather_kernel<<<blocks_for(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      err, offsets, out, total,
      make_geometry(H, W, C, OH, OW, kh, kw, sh, sw, ph, pw));
  return static_cast<int>(cudaGetLastError());
}
