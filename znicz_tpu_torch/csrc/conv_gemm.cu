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
//            P[m, k] . err[m, n]: C's rows are the patch index k, its
//            depth the output pixel m, split across gridDim.z and summed
//            in a fixed order (gemm_tc.cuh split_block).
//
// All three run on csrc/gemm_tc.cuh: a 128-row C tile of width BN (8, 16,
// 32, 96 or 128, picked by the wrapper from N so that a tile idles at most
// a quarter of its columns beyond the 8 of the narrowest MMA), eight warps
// of mma.sync m16n8k8 TF32 products in the 3xTF32 split (float32
// accuracy: the tier's tolerance holds unchanged), and a ring of three
// shared-memory stages 32 deep filled by cp.async, so the gathers of two
// steps are in flight while one step's products run.  A copy moves 16
// bytes where the axis it runs along (C for the forward's and the weight
// gradient's patches, OC for the input gradient's err and w and for the
// dense err and w) is a multiple of 4 and the operand 16-byte aligned,
// else 4; a padding tap is a copy of 0 bytes, which fills zeros.  The
// weight gradient keeps its patch operand M-major in shared memory (k
// innermost, as c is in x) and err N-major, as they lie in device memory.
// Its output is small and its depth long (CIFAR conv2: 7 tiles over
// 25,600 pixels), so the wrapper splits the depth until the card is full.
//
// Index math: a block's 128 output rows are decomposed into (b, oh, ow)
// once, into shared memory; a thread's depth index k into (kh, kw, c) once
// a stage (a thread keeps one k, or one group of 4, across its rows).  In
// the weight gradient a thread keeps its k (or group of 4) for the whole
// block, decomposed once, and each stage's 32 pixels are decomposed once,
// into a table in shared memory.  Divisions go through csrc/fastdiv.cuh,
// since a runtime division costs some twenty instructions.  Indices are
// int32: the wrappers refuse tensors of 2^31 elements or more.
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
// swizzled shared memory (the weight gradient's M-major patches too), with
// TMA's im2col mode for the gather, is the later design.  At N = 1 (the
// autoencoder's deconv forward) an 8-wide tile still idles 7/8 of its
// columns, and at the autoencoder's weight gradient (K = 25 rows) a
// 128-row tile 80% of its rows.

#include "fastdiv.cuh"
#include "gemm_tc.cuh"

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

// A of the weight gradient, A(k, m) = P[m, k]: C's rows are k = (kh, kw,
// c), the depth the output pixel m.  Kept M-major in shared memory (k
// innermost, as c is in x): a thread keeps a group of kVec neighbouring k
// (kVec = 4: four c of one tap, C a multiple of 4) for the whole block,
// decomposed once by the kernel, and copies it at kBK / (kThreads /
// (kBM / kVec)) pixels of a stage.  Each stage's kBK pixels are
// decomposed into (b, oh, ow) once, by the first kBK threads, into a
// table in shared memory (base = b.H.W.C, h0 = oh.sh - ph, w0 = ow.sw -
// pw; two tables, for neighbouring stages), which load() then waits on
// with a barrier: every thread of the block calls it.  Two tables suffice:
// the writes of stage t + 2 come after the barrier of stage t + 1, which
// every thread reaches only after its reads of stage t.
template <int kVec>
struct PixelTaps {
  const float* x;
  int (*base)[tc::kBK];
  int (*h0)[tc::kBK];
  int (*w0)[tc::kBK];
  int H, W, C, OW, OHW, M, sh, sw, ph, pw;
  FastDiv by_ohw, by_ow;
  int kh, kw, c;   // this thread's (first) k
  bool k_ok;

  __device__ __forceinline__ void load(float* s, int t0) const {
    constexpr int kGroups = tc::kBM / kVec;
    constexpr int kPixelsAPass = tc::kThreads / kGroups;
    const int slot = (t0 / tc::kBK) & 1;
    if (threadIdx.x < tc::kBK) {
      const int m = t0 + static_cast<int>(threadIdx.x);
      int bb = 0, hh = kFar, ww = kFar;
      if (m < M) {
        const int b = by_ohw.div(m);
        const int r = m - b * OHW;
        const int oh = by_ow.div(r);
        const int ow = r - oh * OW;
        bb = b * H * W * C;
        hh = oh * sh - ph;
        ww = ow * sw - pw;
      }
      base[slot][threadIdx.x] = bb;
      h0[slot][threadIdx.x] = hh;
      w0[slot][threadIdx.x] = ww;
    }
    __syncthreads();
    const int ii = static_cast<int>(threadIdx.x) % kGroups * kVec;
#pragma unroll
    for (int l = 0; l < tc::kBK / kPixelsAPass; ++l) {
      const int kk =
          static_cast<int>(threadIdx.x) / kGroups + l * kPixelsAPass;
      const int ih = h0[slot][kk] + kh;
      const int iw = w0[slot][kk] + kw;
      const bool ok = k_ok &&
                      static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(W);
      tc::cp_async<kVec>(s + kk * tc::kAStrideM + ii,
                         ok ? x + base[slot][kk] + (ih * W + iw) * C + c : x,
                         ok);
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
  // B: w as the dense (K, N = OC) matrix, N-major as it lies in memory
  tc::mainloop<T>(PatchRows<kVecA>{x, base, h0, w0, g.H, g.W, g.C, g.KW,
                                   k_total, by_c, by_kw},
                  tc::Dense<BN, T::kBStrideN, false, kVecB, int>{
                      w, 1, g.OC, g.OC, k_total, n0},
                  smem, 0, k_total, acc);
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
                  0, k_total, acc);
  tc::store_tile<T>(acc, dx, m_total, g.C, m0, n0);
}

template <int BN, int kVecA, int kVecB>
__global__ void __launch_bounds__(tc::kThreads,
                                  tc::Tile<BN, false, true>::kMinBlocks)
conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ err,
                  float* __restrict__ dw, float* __restrict__ ws, ConvShape g,
                  FastDiv by_c, FastDiv by_kw, FastDiv by_ohw, FastDiv by_ow,
                  int chunk) {
  using T = tc::Tile<BN, false, true>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int base[2][tc::kBK], h0[2][tc::kBK], w0[2][tc::kBK];
  const int m_total = g.B * g.OH * g.OW;
  const int k_total = g.KH * g.KW * g.C;
  const int m0 = blockIdx.x * tc::kBM;   // C's rows: the patch index k
  const int n0 = blockIdx.y * BN;
  const int k = m0 + static_cast<int>(threadIdx.x) % (tc::kBM / kVecA) * kVecA;
  const int q = by_c.div(k);
  const int c = k - q * g.C;
  const int kh = by_kw.div(q);
  const int kw = q - kh * g.KW;
  const PixelTaps<kVecA> la{x, base, h0, w0, g.H, g.W, g.C, g.OW,
                            g.OH * g.OW, m_total, g.sh, g.sw, g.ph, g.pw,
                            by_ohw, by_ow, kh, kw, c, k < k_total};
  // B: err as the dense (B.OH.OW, OC) matrix, N-major
  const tc::Dense<BN, T::kBStrideN, false, kVecB, int> lb{
      err, 1, g.OC, g.OC, m_total, n0};
  tc::split_block<T>(la, lb, smem, m_total, chunk, dw, ws, k_total, g.OC, m0,
                     n0);
}

ConvShape make_shape(int B, int H, int W, int C, int KH, int KW, int OC,
                     int OH, int OW, int sh, int sw, int ph, int pw) {
  return ConvShape{B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph, pw};
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// The entry points take x's (B, H, W, C), w's (KH, KW, OC) and the output
// extent (OH, OW) the wrapper computed; every tensor contiguous float32
// with fewer than 2^31 elements and every output non-empty (the wrappers
// answer empty shapes without a launch).  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() as an int.
//
// They also take the wrapper's tile choice (ops/conv.py _tc_config,
// wgrad_plan): the C tile's width bn (8, 16, 32, 96 or 128) and the
// floats a copy of A and of B moves (vec_a, vec_b: 4 or 1; 4 needs the
// axis the copy runs along a multiple of 4 and the operand 16-byte
// aligned); the forward and the input gradient unit_stride (1: the input
// gradient's stride is 1 and its taps need no exactness test; the forward
// takes 0), the weight gradient its split of the depth.  They return
// cudaErrorInvalidValue for a choice the shape does not allow.

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
  return tc::with_width(bn, [&](auto n) {
    return tc::with_vec(vec_a, [&](auto va) {
      return tc::with_vec(vec_b, [&](auto vb) {
        constexpr int kBN = decltype(n)::value;
        const dim3 grid((m_total + tc::kBM - 1) / tc::kBM,
                        (OC + kBN - 1) / kBN);
        return tc::launch(
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
  return tc::with_width(bn, [&](auto n) {
    return tc::with_vec(vec_a, [&](auto v) {
      return tc::with_flag(unit_stride, [&](auto unit) {
        constexpr int kBN = decltype(n)::value;
        const dim3 grid((m_total + tc::kBM - 1) / tc::kBM,
                        (C + kBN - 1) / kBN);
        return tc::launch(
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
// OW, OC): vec_a is the copy width along x's C, vec_b along err's OC;
// `splits` chunks of `chunk` output pixels (a multiple of 32, none empty)
// cover B.OH.OW, and with splits > 1 ws holds splits.KH.KW.C.OC floats.
// The split sum runs after the product, on the same stream.
extern "C" int znicz_conv_wgrad_f32(const float* x, const float* err,
                                    float* dw, float* ws, int B, int H, int W,
                                    int C, int KH, int KW, int OC, int OH,
                                    int OW, int sh, int sw, int ph, int pw,
                                    int bn, int vec_a, int vec_b, int splits,
                                    int chunk, void* stream) {
  const int m_total = B * OH * OW;
  const bool bad_split =
      splits < 1 || splits > 65535 || chunk <= 0 || chunk % tc::kBK != 0 ||
      static_cast<long long>(splits) * chunk < m_total ||
      (splits > 1 && (static_cast<long long>(splits - 1) * chunk >= m_total ||
                      ws == nullptr));
  if ((vec_a == 4 && (C % 4 != 0 || !aligned16(x))) ||
      (vec_b == 4 && (OC % 4 != 0 || !aligned16(err))) || bad_split)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape g = make_shape(B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph,
                                 pw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_total = KH * KW * C;
  const int status = tc::with_width(bn, [&](auto n) {
    return tc::with_vec(vec_a, [&](auto va) {
      return tc::with_vec(vec_b, [&](auto vb) {
        constexpr int kBN = decltype(n)::value;
        const dim3 grid((k_total + tc::kBM - 1) / tc::kBM,
                        (OC + kBN - 1) / kBN, splits);
        return tc::launch(
            conv_wgrad_kernel<kBN, decltype(va)::value, decltype(vb)::value>,
            tc::Tile<kBN, false, true>::kSmemBytes, grid, st, x, err, dw, ws,
            g, make_fastdiv(C), make_fastdiv(KW), make_fastdiv(OH * OW),
            make_fastdiv(OW), chunk);
      });
    });
  });
  if (status != 0) return status;
  return launch_split_sum(ws, dw, k_total * OC, splits, st);
}
