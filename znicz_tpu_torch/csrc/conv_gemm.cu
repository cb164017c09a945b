// Implicit-GEMM convolution on NHWC activations and HWIO weights: the
// forward, the input gradient (a transposed conv) and the weight gradient,
// each a product on csrc/gemm_tile.cuh's tile loop whose patch operand is
// gathered from the image while a tile is loaded into shared memory.
//
// Replaces the TPU kernels of the reference's Pallas conv tier
// (ZNICZ_TPU_CONV=pallas), which build the patch matrix in XLA and
// multiply it in Pallas:
//   conv_fwd_kernel   <- znicz_tpu/ops/conv.py pallas_conv2d (also
//                        ops/deconv.py pallas_deconv2d_grad_input);
//   conv_dgrad_kernel <- ops/conv.py pallas_conv2d_grad_input (also
//                        ops/deconv.py pallas_deconv2d);
//   conv_wgrad_kernel <- ops/conv.py pallas_conv2d_grad_weights via
//                        pallas_matmul_at_b (also ops/deconv.py
//                        pallas_deconv2d_grad_weights).
// Built in device memory that patch matrix would be 896 MB at AlexNet's
// conv2 (93,312 x 2,400 floats) and 562 MB at its conv1; here it never
// exists.
//
// Shapes: x (B, H, W, C), w (KH, KW, C, OC), y (B, OH, OW, OC).
//   forward  y(M = B.OH.OW, N = OC) = P(M, K = KH.KW.C) . W(K, N), with
//            P[m, (kh, kw, c)] = x[b, oh.sh + kh - ph, ow.sw + kw - pw, c]
//            (0 outside the image) and W = w as a dense (K, OC) matrix.
//            K runs in (kh, kw, c) order; the reference orders its patches
//            (C, KH, KW), which changes only the order of summation.
//   dgrad    dx(M = B.H.W, N = C) = E(M, K = KH.KW.OC) . W'(K, N), with
//            E[(b, h, w), (kh, kw, oc)] = err[b, (h + ph - kh)/sh,
//            (w + pw - kw)/sw, oc] where both divisions are exact and in
//            range, else 0; W'[(kh, kw, oc), c] = w[kh, kw, c, oc].  The
//            reference dilates err by the stride and pads its edges before
//            taking patches against the flipped, IO-swapped kernel; index
//            arithmetic replaces both, and no dilated copy exists.
//   wgrad    dw(K = KH.KW.C, N = OC) = sum over m < B.OH.OW of
//            P[m, k] . err[m, n]: at_b_block with P gathered as in the
//            forward, split over m (gemm_tile.cuh), summed in a fixed order.
//
// Index math: a block's 64 output rows are decomposed into (b, oh, ow)
// once, into shared memory; a thread's depth index k into (kh, kw, c) once
// a step (the depth-fast loaders keep one k across their four loads), with
// csrc/fastdiv.cuh, since a runtime division costs some twenty
// instructions.  Indices are int32: the wrappers refuse tensors of 2^31
// elements or more.
//
// Bound on an H100: float operations at every conv of the paths (2.M.N.K
// over the 67 TFLOP/s float32 peak; AlexNet conv2 forward 114.7 GFLOP,
// 1.71 ms).  This first version is the simple SIMT tile loop: no wgmma,
// TMA or cp.async pipeline.  A narrow N leaves part of a tile idle (the
// autoencoder's deconv forward has N = C = 1, 1/64 of a tile).

#include "fastdiv.cuh"
#include "gemm_tile.cuh"

namespace {

// a row that no output pixel has: every tap index built on it is negative
constexpr int kFar = -(1 << 29);

struct ConvShape {
  int B, H, W, C;   // the conv's input x
  int KH, KW, OC;   // w (KH, KW, C, OC)
  int OH, OW;       // its output
  int sh, sw, ph, pw;
};

// A of the forward and of the weight gradient's rows: P[m, k] with the
// block's rows (b, oh, ow) decomposed in shared memory (base = b.H.W.C,
// h0 = oh.sh - ph, w0 = ow.sw - pw); depth fastest, so a thread keeps one
// k = (kh, kw, c) across its loads.
struct PatchRows {
  const float* x;
  const int* base;
  const int* h0;
  const int* w0;
  int H, W, C, KW, K;
  FastDiv by_c, by_kw;

  __device__ __forceinline__ void load(Tile& s, int, int t0) const {
    const int kk = depth_fast_kk();
    const int k = t0 + kk;
    const int q = by_c.div(k);
    const int c = k - q * C;
    const int kh = by_kw.div(q);
    const int kw = q - kh * KW;
    const bool k_ok = k < K;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int ii = depth_fast_ii(l);
      const int ih = h0[ii] + kh;
      const int iw = w0[ii] + kw;
      float v = 0.0f;
      if (k_ok && static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
          static_cast<unsigned>(iw) < static_cast<unsigned>(W))
        v = x[base[ii] + (ih * W + iw) * C + c];
      s[kk][ii] = v;
    }
  }
};

// A of the input gradient: E[(b, h, w), (kh, kw, oc)], the block's rows in
// shared memory (base = b.OH.OW.OC, h1 = h + ph, w1 = w + pw); depth
// fastest.  A tap counts where (h1 - kh) and (w1 - kw) are non-negative
// multiples of the stride whose quotients fall inside err.
struct ErrTaps {
  const float* err;
  const int* base;
  const int* h1;
  const int* w1;
  int OH, OW, OC, KW, K, sh, sw;
  FastDiv by_oc, by_kw, by_sh, by_sw;

  __device__ __forceinline__ void load(Tile& s, int, int t0) const {
    const int kk = depth_fast_kk();
    const int k = t0 + kk;
    const int q = by_oc.div(k);
    const int oc = k - q * OC;
    const int kh = by_kw.div(q);
    const int kw = q - kh * KW;
    const bool k_ok = k < K;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int ii = depth_fast_ii(l);
      const int nh = h1[ii] - kh;
      const int nw = w1[ii] - kw;
      float v = 0.0f;
      if (k_ok && nh >= 0 && nw >= 0) {
        const int oh = by_sh.div(nh);
        const int ow = by_sw.div(nw);
        if (oh * sh == nh && ow * sw == nw && oh < OH && ow < OW)
          v = err[base[ii] + (oh * OW + ow) * OC + oc];
      }
      s[kk][ii] = v;
    }
  }
};

// B of the input gradient: W'[(kh, kw, oc), c] = w[kh, kw, c, oc], the IO
// swap as strides; depth fastest (oc is w's innermost axis).
struct TapWeights {
  const float* w;
  int C, OC, K;
  FastDiv by_oc;

  __device__ __forceinline__ void load(Tile& s, int c0, int t0) const {
    const int kk = depth_fast_kk();
    const int k = t0 + kk;
    const int q = by_oc.div(k);   // kh.KW + kw
    const int oc = k - q * OC;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int ii = depth_fast_ii(l);
      const int c = c0 + ii;
      s[kk][ii] = (k < K && c < C) ? w[(q * C + c) * OC + oc] : 0.0f;
    }
  }
};

// A of the weight gradient (C's rows are k = (kh, kw, c), the depth is the
// output pixel m): P[m, k]; index fastest, so a thread keeps one k for the
// whole block, decomposed once, and decomposes each m it loads.
struct PatchCols {
  const float* x;
  int H, W, C, OW, OHW, M, sh, sw;
  FastDiv by_ohw, by_ow;
  int ih0, iw0, c;   // this thread's k: kh - ph, kw - pw, c
  bool k_ok;

  __device__ __forceinline__ void load(Tile& s, int, int t0) const {
    const int ii = index_fast_ii();
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int kk = index_fast_kk(l);
      const int m = t0 + kk;
      float v = 0.0f;
      if (k_ok && m < M) {
        const int b = by_ohw.div(m);
        const int r = m - b * OHW;
        const int oh = by_ow.div(r);
        const int ow = r - oh * OW;
        const int ih = oh * sh + ih0;
        const int iw = ow * sw + iw0;
        if (static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
            static_cast<unsigned>(iw) < static_cast<unsigned>(W))
          v = x[((b * H + ih) * W + iw) * C + c];
      }
      s[kk][ii] = v;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, ConvShape g, FastDiv by_c,
                FastDiv by_kw, FastDiv by_ohw, FastDiv by_ow) {
  __shared__ __align__(16) Tile as;
  __shared__ __align__(16) Tile bs;
  __shared__ int base[kBM], h0[kBM], w0[kBM];
  const int m_total = g.B * g.OH * g.OW;
  const int k_total = g.KH * g.KW * g.C;
  const int m0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBN;
  if (threadIdx.x < kBM) {
    const int m = m0 + threadIdx.x;
    int bb = 0, hh = kFar, ww = kFar;
    if (m < m_total) {
      const int b = by_ohw.div(m);
      const int r = m - b * (g.OH * g.OW);
      const int oh = by_ow.div(r);
      const int ow = r - oh * g.OW;
      bb = b * g.H * g.W * g.C;
      hh = oh * g.sh - g.ph;
      ww = ow * g.sw - g.pw;
    }
    base[threadIdx.x] = bb;
    h0[threadIdx.x] = hh;
    w0[threadIdx.x] = ww;
  }
  __syncthreads();
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  mainloop(PatchRows{x, base, h0, w0, g.H, g.W, g.C, g.KW, k_total, by_c,
                     by_kw},
           DepthMajor{w, g.OC, k_total, g.OC}, as, bs, m0, c0, 0, k_total,
           acc);
  store_tile(acc, y, m_total, g.OC, m0, c0);
}

__global__ void __launch_bounds__(kThreads)
conv_dgrad_kernel(const float* __restrict__ err, const float* __restrict__ w,
                  float* __restrict__ dx, ConvShape g, FastDiv by_oc,
                  FastDiv by_kw, FastDiv by_hw, FastDiv by_w, FastDiv by_sh,
                  FastDiv by_sw) {
  __shared__ __align__(16) Tile as;
  __shared__ __align__(16) Tile bs;
  __shared__ int base[kBM], h1[kBM], w1[kBM];
  const int m_total = g.B * g.H * g.W;
  const int k_total = g.KH * g.KW * g.OC;
  const int m0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBN;
  if (threadIdx.x < kBM) {
    const int m = m0 + threadIdx.x;
    int bb = 0, hh = kFar, ww = kFar;
    if (m < m_total) {
      const int b = by_hw.div(m);
      const int r = m - b * (g.H * g.W);
      const int h = by_w.div(r);
      const int wc = r - h * g.W;
      bb = b * g.OH * g.OW * g.OC;
      hh = h + g.ph;
      ww = wc + g.pw;
    }
    base[threadIdx.x] = bb;
    h1[threadIdx.x] = hh;
    w1[threadIdx.x] = ww;
  }
  __syncthreads();
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  mainloop(ErrTaps{err, base, h1, w1, g.OH, g.OW, g.OC, g.KW, k_total, g.sh,
                   g.sw, by_oc, by_kw, by_sh, by_sw},
           TapWeights{w, g.C, g.OC, k_total, by_oc}, as, bs, m0, c0, 0,
           k_total, acc);
  store_tile(acc, dx, m_total, g.C, m0, c0);
}

__global__ void __launch_bounds__(kThreads)
conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ err,
                  float* __restrict__ dw, float* __restrict__ ws, ConvShape g,
                  FastDiv by_c, FastDiv by_kw, FastDiv by_ohw, FastDiv by_ow,
                  int chunk) {
  __shared__ __align__(16) Tile as;
  __shared__ __align__(16) Tile bs;
  const int m_total = g.B * g.OH * g.OW;
  const int k_total = g.KH * g.KW * g.C;
  const int k = blockIdx.x * kBM + index_fast_ii();
  const int q = by_c.div(k);
  const int c = k - q * g.C;
  const int kh = by_kw.div(q);
  const int kw = q - kh * g.KW;
  const PatchCols la{x, g.H, g.W, g.C, g.OW, g.OH * g.OW, m_total, g.sh,
                     g.sw, by_ohw, by_ow, kh - g.ph, kw - g.pw, c,
                     k < k_total};
  at_b_block(la, DepthMajor{err, g.OC, m_total, g.OC}, as, bs, dw, ws,
             k_total, g.OC, m_total, chunk);
}

ConvShape make_shape(int B, int H, int W, int C, int KH, int KW, int OC,
                     int OH, int OW, int sh, int sw, int ph, int pw) {
  return ConvShape{B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph, pw};
}

}  // namespace

// The entry points take x's (B, H, W, C), w's (KH, KW, OC) and the output
// extent (OH, OW) the wrapper computed; every tensor contiguous float32
// with fewer than 2^31 elements and every output non-empty (the wrappers
// answer empty shapes without a launch).  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() as an int.

// y (B, OH, OW, OC) = conv(x, w).
extern "C" int znicz_conv_fwd_f32(const float* x, const float* w, float* y,
                                  int B, int H, int W, int C, int KH, int KW,
                                  int OC, int OH, int OW, int sh, int sw,
                                  int ph, int pw, void* stream) {
  const ConvShape g = make_shape(B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph,
                                 pw);
  const int m_total = B * OH * OW;
  const dim3 grid((m_total + kBM - 1) / kBM, (OC + kBN - 1) / kBN);
  conv_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, y, g, make_fastdiv(C), make_fastdiv(KW), make_fastdiv(OH * OW),
      make_fastdiv(OW));
  return static_cast<int>(cudaGetLastError());
}

// dx (B, H, W, C) = the input gradient of conv(x, w) from err (B, OH, OW,
// OC); rows that no window reaches get 0.
extern "C" int znicz_conv_dgrad_f32(const float* err, const float* w,
                                    float* dx, int B, int H, int W, int C,
                                    int KH, int KW, int OC, int OH, int OW,
                                    int sh, int sw, int ph, int pw,
                                    void* stream) {
  const ConvShape g = make_shape(B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph,
                                 pw);
  const int m_total = B * H * W;
  const dim3 grid((m_total + kBM - 1) / kBM, (C + kBN - 1) / kBN);
  conv_dgrad_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      err, w, dx, g, make_fastdiv(OC), make_fastdiv(KW), make_fastdiv(H * W),
      make_fastdiv(W), make_fastdiv(sh), make_fastdiv(sw));
  return static_cast<int>(cudaGetLastError());
}

// dw (KH, KW, C, OC) = the weight gradient of conv(x, w) from err (B, OH,
// OW, OC): `splits` chunks of `chunk` output pixels (a multiple of 16)
// cover B.OH.OW; with splits > 1, ws holds splits.KH.KW.C.OC floats.
extern "C" int znicz_conv_wgrad_f32(const float* x, const float* err,
                                    float* dw, float* ws, int B, int H, int W,
                                    int C, int KH, int KW, int OC, int OH,
                                    int OW, int sh, int sw, int ph, int pw,
                                    int splits, int chunk, void* stream) {
  const ConvShape g = make_shape(B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph,
                                 pw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_total = KH * KW * C;
  const dim3 grid((k_total + kBM - 1) / kBM, (OC + kBN - 1) / kBN, splits);
  conv_wgrad_kernel<<<grid, kThreads, 0, st>>>(
      x, err, dw, ws, g, make_fastdiv(C), make_fastdiv(KW),
      make_fastdiv(OH * OW), make_fastdiv(OW), chunk);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  return launch_split_sum(ws, dw, k_total * OC, splits, st);
}
