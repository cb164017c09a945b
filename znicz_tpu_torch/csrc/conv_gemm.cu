// Implicit-GEMM convolution on NHWC activations and HWIO weights: the
// forward, the input gradient (a transposed conv) and the weight gradient,
// each a product whose patch operand is gathered from the image while a
// tile is loaded into shared memory.
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
//            arithmetic replaces both, and no dilated copy exists.  At
//            stride 1 (every path's input gradient) the quotients are
//            h + ph - kh and w + pw - kw themselves: that form has no
//            division and no exactness test.
//   wgrad    dw(K = KH.KW.C, N = OC) = sum over m < B.OH.OW of
//            P[m, k] . err[m, n]: at_b_block with P gathered as in the
//            forward, split over m (gemm_tile.cuh), summed in a fixed order.
//
// The forward and the input gradient run on csrc/gemm_tc.cuh: a 128-row C
// tile of width BN (8, 16, 32, 96 or 128, picked by the wrapper from N so
// that a tile idles at most a quarter of its columns beyond the 8 of the
// narrowest MMA), eight warps of mma.sync m16n8k8 TF32 products in the
// 3xTF32 split (float32 accuracy: the tier's tolerance holds unchanged),
// and a ring of three shared-memory stages 32 deep filled by cp.async, so
// the gathers of two steps are in flight while one step's products run.
// A copy moves 16 bytes where the gathered axis (C for the forward, OC for
// the input gradient and w's K-major rows) is a multiple of 4 and the
// operand 16-byte aligned, else 4; a padding tap is a copy of 0 bytes,
// which fills zeros.  The weight gradient stays on gemm_tile.cuh's SIMT
// loop (float32 FFMA).
//
// Index math: a block's 128 output rows are decomposed into (b, oh, ow)
// once, into shared memory; a thread's depth index k into (kh, kw, c) once
// a stage (a thread keeps one k, or one group of 4, across its rows), with
// csrc/fastdiv.cuh, since a runtime division costs some twenty
// instructions.  Indices are int32: the wrappers refuse tensors of 2^31
// elements or more.
//
// Bound on an H100: operations at every conv of the paths.  In float32
// FFMA 2.M.N.K over 67 TFLOP/s (AlexNet conv2 forward 114.7 GFLOP, 1.71
// ms); on the tensor cores three TF32 products a multiply-add, 6.M.N.K
// over 495 TFLOP/s (0.695 ms).  mma.sync reaches a part of that rate
// only: on an H100 this loop with one TF32 product instead of three ran
// AlexNet's conv2 forward in 0.93 ms (123 TFLOP/s; python -m
// znicz_tpu_torch.conv_tc_probe, variant one_product), and the three take
// 2.6 times as long, so the rate of mma.sync bounds these kernels, not
// their gathers.  wgmma, which needs both operands K-major in
// swizzled shared memory, with TMA's im2col mode for the gather, is the
// later design.  At N = 1 (the autoencoder's deconv forward) an 8-wide
// tile still idles 7/8 of its columns.

#include <type_traits>

#include "fastdiv.cuh"
#include "gemm_tc.cuh"
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

// A of the forward: P[m, k] with the block's rows (b, oh, ow) decomposed
// in shared memory (base = b.H.W.C, h0 = oh.sh - ph, w0 = ow.sw - pw).  A
// thread keeps one k = (kh, kw, c) (kVec = 4: four neighbouring c of one
// tap, C a multiple of 4) across its rows; neighbouring threads copy
// neighbouring depths of one row.
template <int kVec>
struct PatchRows {
  const float* x;
  const int* base;
  const int* h0;
  const int* w0;
  int H, W, C, KW, K;
  FastDiv by_c, by_kw;

  __device__ __forceinline__ void load(float* s, int t0) const {
    constexpr int kGroups = tc::kBK / kVec;
    constexpr int kRowsAPass = tc::kThreads / kGroups;
    const int kk = static_cast<int>(threadIdx.x) % kGroups * kVec;
    const int k = t0 + kk;
    const int q = by_c.div(k);
    const int c = k - q * C;
    const int kh = by_kw.div(q);
    const int kw = q - kh * KW;
    const bool k_ok = k < K;
#pragma unroll
    for (int l = 0; l < tc::kBM / kRowsAPass; ++l) {
      const int ii = static_cast<int>(threadIdx.x) / kGroups + l * kRowsAPass;
      const int ih = h0[ii] + kh;
      const int iw = w0[ii] + kw;
      const bool ok = k_ok &&
                      static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(W);
      tc::cp_async<kVec>(s + ii * tc::kRowStride + kk,
                         ok ? x + base[ii] + (ih * W + iw) * C + c : x, ok);
    }
  }
};

// A of the input gradient: E[(b, h, w), (kh, kw, oc)], the block's rows in
// shared memory (base = b.OH.OW.OC, h1 = h + ph, w1 = w + pw), copied as
// PatchRows copies P.  A tap counts where (h1 - kh) and (w1 - kw) are
// non-negative multiples of the stride whose quotients fall inside err; at
// stride 1 (kUnit) they are the quotients, and one range test remains.
template <int kVec, bool kUnit>
struct ErrTaps {
  const float* err;
  const int* base;
  const int* h1;
  const int* w1;
  int OH, OW, OC, KW, K, sh, sw;
  FastDiv by_oc, by_kw, by_sh, by_sw;

  __device__ __forceinline__ void load(float* s, int t0) const {
    constexpr int kGroups = tc::kBK / kVec;
    constexpr int kRowsAPass = tc::kThreads / kGroups;
    const int kk = static_cast<int>(threadIdx.x) % kGroups * kVec;
    const int k = t0 + kk;
    const int q = by_oc.div(k);
    const int oc = k - q * OC;
    const int kh = by_kw.div(q);
    const int kw = q - kh * KW;
    const bool k_ok = k < K;
#pragma unroll
    for (int l = 0; l < tc::kBM / kRowsAPass; ++l) {
      const int ii = static_cast<int>(threadIdx.x) / kGroups + l * kRowsAPass;
      const int nh = h1[ii] - kh;
      const int nw = w1[ii] - kw;
      int oh = nh, ow = nw;
      bool ok = k_ok;
      if (!kUnit) {
        oh = by_sh.div(max(nh, 0));
        ow = by_sw.div(max(nw, 0));
        ok = ok && nh >= 0 && nw >= 0 && oh * sh == nh && ow * sw == nw;
      }
      ok = ok && static_cast<unsigned>(oh) < static_cast<unsigned>(OH) &&
           static_cast<unsigned>(ow) < static_cast<unsigned>(OW);
      tc::cp_async<kVec>(s + ii * tc::kRowStride + kk,
                         ok ? err + base[ii] + (oh * OW + ow) * OC + oc : err,
                         ok);
    }
  }
};

// B of the forward: w as the dense (K, N = OC) matrix, kept N-major in
// shared memory as it lies in device memory; neighbouring threads copy
// neighbouring columns.
template <class T, int kVec>
struct DenseRows {
  const float* w;
  int N, K, n0;

  __device__ __forceinline__ void load(float* s, int t0) const {
    constexpr int kGroups = T::kBN / kVec;   // per depth row
    constexpr int kCopies = tc::kBK * kGroups;
#pragma unroll
    for (int l = 0; l < (kCopies + tc::kThreads - 1) / tc::kThreads; ++l) {
      const int idx = static_cast<int>(threadIdx.x) + l * tc::kThreads;
      if (kCopies % tc::kThreads == 0 || idx < kCopies) {
        const int kk = idx / kGroups;
        const int nn = idx % kGroups * kVec;
        const int k = t0 + kk;
        const int n = n0 + nn;
        const bool ok = k < K && n < N;
        tc::cp_async<kVec>(s + kk * T::kBStrideN + nn, ok ? w + k * N + n : w,
                           ok);
      }
    }
  }
};

// B of the input gradient: W'[(kh, kw, oc), c] = w[kh, kw, c, oc], the IO
// swap as strides, kept K-major in shared memory (oc is w's innermost
// axis, so a copy of 4 takes four neighbouring oc where OC is a multiple
// of 4).
template <class T, int kVec>
struct TapWeights {
  const float* w;
  int C, OC, K, n0;
  FastDiv by_oc;

  __device__ __forceinline__ void load(float* s, int t0) const {
    constexpr int kGroups = tc::kBK / kVec;
    constexpr int kRowsAPass = tc::kThreads / kGroups;
    const int kk = static_cast<int>(threadIdx.x) % kGroups * kVec;
    const int k = t0 + kk;
    const int q = by_oc.div(k);   // kh.KW + kw
    const int oc = k - q * OC;
    const bool k_ok = k < K;
#pragma unroll
    for (int l = 0; l < (T::kBN + kRowsAPass - 1) / kRowsAPass; ++l) {
      const int nn = static_cast<int>(threadIdx.x) / kGroups + l * kRowsAPass;
      if (T::kBN % kRowsAPass == 0 || nn < T::kBN) {
        const int c = n0 + nn;
        const bool ok = k_ok && c < C;
        tc::cp_async<kVec>(s + nn * tc::kRowStride + kk,
                           ok ? w + (q * C + c) * OC + oc : w, ok);
      }
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

template <int BN, int kVecA, int kVecB>
__global__ void __launch_bounds__(tc::kThreads, tc::Tile<BN, false>::kMinBlocks)
conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, ConvShape g, FastDiv by_c,
                FastDiv by_kw, FastDiv by_ohw, FastDiv by_ow) {
  using T = tc::Tile<BN, false>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int base[tc::kBM], h0[tc::kBM], w0[tc::kBM];
  const int m_total = g.B * g.OH * g.OW;
  const int k_total = g.KH * g.KW * g.C;
  const int m0 = blockIdx.x * tc::kBM;
  const int n0 = blockIdx.y * BN;
  if (threadIdx.x < tc::kBM) {
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
  float acc[T::kMT][T::kNT][4] = {};
  tc::mainloop<T>(PatchRows<kVecA>{x, base, h0, w0, g.H, g.W, g.C, g.KW,
                                   k_total, by_c, by_kw},
                  DenseRows<T, kVecB>{w, g.OC, k_total, n0}, smem, k_total,
                  acc);
  tc::store_tile<T>(acc, y, m_total, g.OC, m0, n0);
}

template <int BN, int kVec, bool kUnit>
__global__ void __launch_bounds__(tc::kThreads, tc::Tile<BN, true>::kMinBlocks)
conv_dgrad_kernel(const float* __restrict__ err, const float* __restrict__ w,
                  float* __restrict__ dx, ConvShape g, FastDiv by_oc,
                  FastDiv by_kw, FastDiv by_hw, FastDiv by_w, FastDiv by_sh,
                  FastDiv by_sw) {
  using T = tc::Tile<BN, true>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int base[tc::kBM], h1[tc::kBM], w1[tc::kBM];
  const int m_total = g.B * g.H * g.W;
  const int k_total = g.KH * g.KW * g.OC;
  const int m0 = blockIdx.x * tc::kBM;
  const int n0 = blockIdx.y * BN;
  if (threadIdx.x < tc::kBM) {
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
  float acc[T::kMT][T::kNT][4] = {};
  tc::mainloop<T>(ErrTaps<kVec, kUnit>{err, base, h1, w1, g.OH, g.OW, g.OC,
                                       g.KW, k_total, g.sh, g.sw, by_oc,
                                       by_kw, by_sh, by_sw},
                  TapWeights<T, kVec>{w, g.C, g.OC, k_total, n0, by_oc}, smem,
                  k_total, acc);
  tc::store_tile<T>(acc, dx, m_total, g.C, m0, n0);
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

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<BN>{}) for the tile widths the kernels are built for.
template <class F>
int with_bn(int bn, F&& f) {
  switch (bn) {
    case 8: return f(Int<8>{});
    case 16: return f(Int<16>{});
    case 32: return f(Int<32>{});
    case 96: return f(Int<96>{});
    case 128: return f(Int<128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(Int<4>{}) or f(Int<1>{}): a copy width of 4 or 1 floats.
template <class F>
int with_vec(int vec, F&& f) {
  if (vec == 4) return f(Int<4>{});
  if (vec == 1) return f(Int<1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(Int<1>{}) or f(Int<0>{}): a flag.
template <class F>
int with_flag(int flag, F&& f) {
  if (flag == 1) return f(Int<1>{});
  if (flag == 0) return f(Int<0>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Allows `kernel` its dynamic shared memory and launches it.
template <class... P, class... A>
int launch_tc(void (*kernel)(P...), int smem, dim3 grid, cudaStream_t st,
              A... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, tc::kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points take x's (B, H, W, C), w's (KH, KW, OC) and the output
// extent (OH, OW) the wrapper computed; every tensor contiguous float32
// with fewer than 2^31 elements and every output non-empty (the wrappers
// answer empty shapes without a launch).  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() as an int.
//
// The forward and the input gradient also take the wrapper's tile choice
// (ops/conv.py _tc_config): the C tile's width bn (8, 16, 32, 96 or 128),
// the floats a copy of A and of B moves (vec_a, vec_b: 4 or 1; 4 needs the
// gathered axis a multiple of 4 and the operand 16-byte aligned) and
// unit_stride (1: the input gradient's stride is 1 and its taps need no
// exactness test; the forward takes 0).  They return cudaErrorInvalidValue
// for a choice the shape does not allow.

// y (B, OH, OW, OC) = conv(x, w).
extern "C" int znicz_conv_fwd_f32(const float* x, const float* w, float* y,
                                  int B, int H, int W, int C, int KH, int KW,
                                  int OC, int OH, int OW, int sh, int sw,
                                  int ph, int pw, int bn, int vec_a,
                                  int vec_b, int unit_stride, void* stream) {
  if ((vec_a == 4 && (C % 4 != 0 || !aligned16(x))) ||
      (vec_b == 4 && (OC % 4 != 0 || !aligned16(w))) || unit_stride != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape g = make_shape(B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph,
                                 pw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_total = B * OH * OW;
  return with_bn(bn, [&](auto n) {
    return with_vec(vec_a, [&](auto va) {
      return with_vec(vec_b, [&](auto vb) {
        constexpr int kBN = decltype(n)::value;
        const dim3 grid((m_total + tc::kBM - 1) / tc::kBM,
                        (OC + kBN - 1) / kBN);
        return launch_tc(
            conv_fwd_kernel<kBN, decltype(va)::value, decltype(vb)::value>,
            tc::Tile<kBN, false>::kSmemBytes, grid, st, x, w, y, g,
            make_fastdiv(C), make_fastdiv(KW), make_fastdiv(OH * OW),
            make_fastdiv(OW));
      });
    });
  });
}

// dx (B, H, W, C) = the input gradient of conv(x, w) from err (B, OH, OW,
// OC); rows that no window reaches get 0.  Both operands are copied along
// oc, so vec_a and vec_b must agree.
extern "C" int znicz_conv_dgrad_f32(const float* err, const float* w,
                                    float* dx, int B, int H, int W, int C,
                                    int KH, int KW, int OC, int OH, int OW,
                                    int sh, int sw, int ph, int pw, int bn,
                                    int vec_a, int vec_b, int unit_stride,
                                    void* stream) {
  if (vec_a != vec_b ||
      (vec_a == 4 && (OC % 4 != 0 || !aligned16(err) || !aligned16(w))) ||
      (unit_stride == 1 && (sh != 1 || sw != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape g = make_shape(B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph,
                                 pw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_total = B * H * W;
  return with_bn(bn, [&](auto n) {
    return with_vec(vec_a, [&](auto v) {
      return with_flag(unit_stride, [&](auto unit) {
        constexpr int kBN = decltype(n)::value;
        const dim3 grid((m_total + tc::kBM - 1) / tc::kBM,
                        (C + kBN - 1) / kBN);
        return launch_tc(
            conv_dgrad_kernel<kBN, decltype(v)::value,
                              decltype(unit)::value == 1>,
            tc::Tile<kBN, true>::kSmemBytes, grid, st, err, w, dx, g,
            make_fastdiv(OC), make_fastdiv(KW), make_fastdiv(H * W),
            make_fastdiv(W), make_fastdiv(sh), make_fastdiv(sw));
      });
    });
  });
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
