// Cross-channel LRN fused into the max pool that follows it (AlexNet's
// conv -> LRN -> pool 3/2 pairs), forward and backward, over NHWC float32
// tensors with padding 0.  The LRN output y and its gradient err_y never
// reach device memory.
//
// lrn_maxpool_kernel replaces the TPU kernel znicz_tpu/ops/lrn_pool.py
// pallas_lrn_maxpool_split (_lrn_pool_fwd_kernel).  A block takes one
// image, a band of R output rows and a chunk of 32 channels.  Pass 1
// computes the LRN output (lrn_math.cuh) of every input element the band's
// windows cover, once, into a shared-memory tile ((R-1)*sh + kh rows, all
// W columns, 32 channels).  Pass 2, per pooled element: the window taps
// t = i*kw + j are read from the tile in flat row-major order and a tap
// replaces the running winner only when its score (|y| for max-abs) is
// strictly greater, so ties go to the first tap.  It writes the winner's
// signed value and its int32 slot t: bit-equal to LRN then max pooling
// composed, as the reference's.
//
// gd_lrn_maxpool_kernel replaces znicz_tpu/ops/lrn_pool.py
// pallas_gd_lrn_maxpool_split (_lrn_pool_bwd_kernel).  A block takes whole
// pixel rows of C channels (about 1024 elements) and works in two
// passes through shared memory.  Pass 1, per element: err_y is gathered
// from the windows that contain it, in ascending tap order from 0.0f,
// adding err * (offset == t) (pooling.cu's pool_scatter_kernel and the
// reference's order); then d is recomputed from x, and q = err_y * x *
// (p/d) and err_y * p go to the tile.  Pass 2, per element: the window sum
// of q from the tile gives the LRN backward dx, and the preceding layer's
// activation derivative, evaluated at its output y = x, is folded in
// (strict ReLU, scaled tanh, sigmoid, smooth ReLU or mul; 0 folds none),
// by act_math.cuh's fold_act, which the standalone activation backward
// (activation.cu) shares.
//
// The Pallas kernels read x as column-parity halves, because Mosaic has no
// strided loads; these read x unsplit.
//
// Bound on an H100: bytes.  AlexNet pair 1, (128,55,55,96) -> (128,27,27,96):
// the forward reads 148.7 MB and writes 2 x 35.8 MB (~66 us at 3.35 TB/s);
// the backward reads 35.8 MB of err, 35.8 MB of offsets and 148.7 MB of x
// and writes 148.7 MB (~110 us).  Pair 2, (128,27,27,256) -> (128,13,13,256):
// ~42 us and ~70 us.  The forward recomputes the LRN at each of a pooled
// element's kh*kw taps, about (kh*kw)/(sh*sw) = 2.25 times per element of
// x for 3/2 windows, and the LRN's correctly rounded square roots and
// divide make it instruction-bound; the tile computes it (R*sh + kh - sh) /
// (R*sh) times per element instead (1.25 at pair 1, 1.08 at pair 2), the
// bands sized to fit 48 KB of shared memory.  Index arithmetic is
// 32-bit (the wrappers refuse 2^31 elements or more) through FastDiv
// (fastdiv.cuh).  The rounding is lrn_math.cuh's, shared with lrn.cu; the
// folded derivatives are act_math.cuh's: __fmul_rn/__fsub_rn as the
// reference's elementwise ops round, and expf (smooth ReLU) within 2 ulp
// of the host's exp.

#include <cuda_runtime.h>

#include "act_math.cuh"
#include "fastdiv.cuh"
#include "lrn_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBackwardElements = 1024;   // a backward block's elements

struct Geometry {
  FastDiv C, W, H, OW, OH, sh, sw;   // the divisors
  int kh, kw;
};

constexpr int kChunk = 32;            // channels a forward block takes
constexpr int kChunkShift = 5;
constexpr int kTileBytes = 48 * 1024;  // the forward tile's budget

// The forward's blocks: (image, band of `rows` output rows, channel
// chunk), the block index decomposed through the two inner counts.
struct Bands {
  FastDiv n_bands, n_chunks;
  int rows;
};

__global__ void lrn_maxpool_kernel(const float* __restrict__ x,
                                   float* __restrict__ y,
                                   int* __restrict__ offsets, Geometry g,
                                   Bands bands, LrnParams p, int use_abs) {
  extern __shared__ float ytile[];
  const int H = g.H.d, W = g.W.d, C = g.C.d, OH = g.OH.d, OW = g.OW.d;
  const int sh = g.sh.d, sw = g.sw.d, kw = g.kw;
  const int q = bands.n_chunks.div(blockIdx.x);
  const int chunk = blockIdx.x - q * bands.n_chunks.d;
  const int b = bands.n_bands.div(q);
  const int oh0 = (q - b * bands.n_bands.d) * bands.rows;
  const int n_rows = min(bands.rows, OH - oh0);
  const int ih0 = oh0 * sh;
  const int in_rows = (n_rows - 1) * sh + g.kh;
  const int c0 = chunk * kChunk;
  const int n_c = min(kChunk, C - c0);
  // pass 1: ytile[(r * W + w) * kChunk + cc] = LRN at (ih0 + r, w, c0 + cc)
  const float* xb = x + (b * H + ih0) * W * C;
  const int n_in = in_rows * W * kChunk;
  for (int t = threadIdx.x; t < n_in; t += blockDim.x) {
    const int cc = t & (kChunk - 1);
    if (cc < n_c) {
      ytile[t] = lrn_y_at(xb + (t >> kChunkShift) * C, c0 + cc, p);
    }
  }
  __syncthreads();
  // pass 2: one pooled element (oh0 + r, ow, c0 + cc) per iteration
  const int n_out = n_rows * OW * kChunk;
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    const int cc = t & (kChunk - 1);
    if (cc >= n_c) continue;
    const int rw = t >> kChunkShift;
    const int r = g.OW.div(rw);
    const int ow = rw - r * OW;
    const float* tap0 = ytile + ((r * sh) * W + ow * sw) * kChunk + cc;
    float best = 0.0f, best_val = 0.0f;
    int best_t = 0;
    for (int i = 0, tp = 0; i < g.kh; ++i) {
      for (int j = 0; j < kw; ++j, ++tp) {
        const float v = tap0[(i * W + j) * kChunk];
        const float s = use_abs ? fabsf(v) : v;
        if (tp == 0 || s > best) {
          best = s;
          best_val = v;
          best_t = tp;
        }
      }
    }
    const int o = ((b * OH + oh0 + r) * OW + ow) * C + c0 + cc;
    y[o] = best_val;
    offsets[o] = best_t;
  }
}

// err_y at input position (ih, iw) of image b, channel c: the windows
// holding row ih are oh in [lo, hi] with tap row ih - oh*sh in [0, kh);
// ascending t = i*kw + j means descending oh, then descending ow.
__device__ __forceinline__ float gather_err(const float* __restrict__ err,
                                            const int* __restrict__ offsets,
                                            int b, int ih, int iw, int c,
                                            const Geometry& g) {
  const int C = g.C.d, OH = g.OH.d, OW = g.OW.d, sh = g.sh.d, sw = g.sw.d;
  const int first_h = ih - g.kh + 1, first_w = iw - g.kw + 1;
  const int oh_lo = first_h <= 0 ? 0 : g.sh.div(first_h + sh - 1);
  const int oh_hi = min(OH - 1, g.sh.div(ih));
  const int ow_lo = first_w <= 0 ? 0 : g.sw.div(first_w + sw - 1);
  const int ow_hi = min(OW - 1, g.sw.div(iw));
  const int ob = b * OH * OW * C + c;
  float acc = 0.0f;
  for (int oh = oh_hi; oh >= oh_lo; --oh) {
    const int ti = (ih - oh * sh) * g.kw;
    for (int ow = ow_hi; ow >= ow_lo; --ow) {
      const int o = ob + (oh * OW + ow) * C;
      const float e = err[o];
      // err * (offsets == t), as the reference multiplies: err*1 or err*0
      acc = __fadd_rn(acc, offsets[o] == ti + iw - ow * sw
                               ? e : __fmul_rn(e, 0.0f));
    }
  }
  return acc;
}

// One block per `rows_per_block` pixel rows of C channels (about 1024
// elements, so each thread takes several); shared memory holds q and
// err_y * p for each element of those rows.
__global__ void gd_lrn_maxpool_kernel(const float* __restrict__ err,
                                      const int* __restrict__ offsets,
                                      const float* __restrict__ x,
                                      float* __restrict__ dx, int rows,
                                      int rows_per_block, Geometry g,
                                      LrnParams p, int act) {
  extern __shared__ float tile[];
  const int C = g.C.d;
  float* q_s = tile;
  float* ep_s = tile + rows_per_block * C;
  const int row0 = blockIdx.x * rows_per_block;
  const int n_el = min(rows_per_block, rows - row0) * C;
  const float* xb = x + row0 * C;
  for (int t = threadIdx.x; t < n_el; t += blockDim.x) {
    const int r = g.C.div(t);
    const int c = t - r * C;
    const int pix = row0 + r;
    const int q = g.W.div(pix);
    const int iw = pix - q * g.W.d;
    const int b = g.H.div(q);
    const int ih = q - b * g.H.d;
    const float e = gather_err(err, offsets, b, ih, iw, c, g);
    const float d = lrn_denom(xb + (t - c), c, p);
    const float pc = lrn_dpow_nbeta(d, p);
    q_s[t] = lrn_q(e, xb[t], d, pc);
    ep_s[t] = __fmul_rn(e, pc);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_el; t += blockDim.x) {
    const int c = t - g.C.div(t) * C;
    const float ws = lrn_q_window(q_s + (t - c), c, p);
    const float xv = xb[t];
    dx[row0 * C + t] =
        act_math::fold_act(lrn_dx(ep_s[t], xv, ws, p), xv, act);
  }
}

Geometry make_geometry(int H, int W, int C, int OH, int OW, int kh, int kw,
                       int sh, int sw) {
  return Geometry{make_fastdiv(C),  make_fastdiv(W),  make_fastdiv(H),
                  make_fastdiv(OW), make_fastdiv(OH), make_fastdiv(sh),
                  make_fastdiv(sw), kh, kw};
}

}  // namespace

// Both entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int, 0 on success.

extern "C" int znicz_lrn_maxpool_f32(const float* x, float* y, int* offsets,
                                     int B, int H, int W, int C, int kh,
                                     int kw, int sh, int sw, int n,
                                     double alpha, double beta, double k,
                                     int use_abs, void* stream) {
  const int OH = (H - kh) / sh + 1;
  const int OW = (W - kw) / sw + 1;
  if (B <= 0 || OH <= 0 || OW <= 0 || C <= 0) return 0;
  // the most output rows whose input rows fit the tile budget; one band
  // row past it takes the shared memory that it needs (the wrapper refuses
  // what exceeds the card's 227 KB)
  const size_t row_bytes = sizeof(float) * kChunk * W;
  int rows = 1;
  while (rows < OH && (rows * sh + kh) * row_bytes <= kTileBytes) ++rows;
  const size_t smem = ((rows - 1) * sh + kh) * row_bytes;
  if (smem > kTileBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        lrn_maxpool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_bands = (OH + rows - 1) / rows;
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const Bands bands{make_fastdiv(n_bands), make_fastdiv(n_chunks), rows};
  lrn_maxpool_kernel<<<B * n_bands * n_chunks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, y, offsets, make_geometry(H, W, C, OH, OW, kh, kw, sh, sw), bands,
      make_lrn_params(C, n, alpha, beta, k), use_abs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int znicz_gd_lrn_maxpool_f32(const float* err, const int* offsets,
                                        const float* x, float* dx, int B,
                                        int H, int W, int C, int kh, int kw,
                                        int sh, int sw, int n, double alpha,
                                        double beta, double k, int act,
                                        void* stream) {
  const int OH = (H - kh) / sh + 1;
  const int OW = (W - kw) / sw + 1;
  const int rows = B * H * W;
  if (rows <= 0 || C <= 0) return 0;
  const int rows_per_block = C >= kBackwardElements ? 1
                                                    : kBackwardElements / C;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * sizeof(float) * rows_per_block * C;
  gd_lrn_maxpool_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      err, offsets, x, dx, rows, rows_per_block,
      make_geometry(H, W, C, OH, OW, kh, kw, sh, sw),
      make_lrn_params(C, n, alpha, beta, k), act);
  return static_cast<int>(cudaGetLastError());
}
