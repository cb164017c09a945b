// Cross-channel LRN fused into the max pool that follows it (AlexNet's
// conv -> LRN -> pool 3/2 pairs), forward and backward, over NHWC tensors
// with padding 0.  The LRN output y and its gradient err_y never reach
// device memory.
//
// lrn_maxpool_kernel replaces the TPU kernel znicz_tpu/ops/lrn_pool.py
// pallas_lrn_maxpool_split (_lrn_pool_fwd_kernel), gd_lrn_maxpool_kernel
// replaces pallas_gd_lrn_maxpool_split (_lrn_pool_bwd_kernel).  x comes in
// either layout (struct Cols): unsplit, or as the reference's column-parity
// halves (column iw of half iw & 1 at iw >> 1, widths ceil(W/2) and
// floor(W/2)), which a conv of the fused2 routing emits directly
// (ops/conv.py conv2d_split); the backward writes dx in either layout, the
// halves for that conv's gradients.  A block's tile is laid out in logical
// columns either way, so the layout changes only the address of a pixel's
// copy and of its dx store, and no pass ever interleaves the halves.
//
// x and y are in the fused step's storage type T (float, __nv_bfloat16 or
// __half; narrow.cuh); err and dx are float.  x is converted to float as it
// is staged (a narrow x by plain loads, float by cp.async), and each LRN
// output is rounded to T before the pooling compares it, so the winners are
// those of the LRN stored in T and then pooled (the split routing's); the
// folded derivative is taken at the stored x.
//
// Bound on an H100: bytes.  AlexNet pair 1, (128,55,55,96) -> (128,27,27,96):
// the forward reads 148.7 MB and writes 2 x 35.8 MB (~66 us at 3.35 TB/s);
// the backward reads 35.8 MB of err, 35.8 MB of offsets and 148.7 MB of x
// and writes 148.7 MB (~110 us).  Pair 2, (128,27,27,256) ->
// (128,13,13,256): ~42 us and ~70 us.  Each element also costs a chain of
// correctly rounded operations: two square roots and a reciprocal for
// d^-0.75, backward also a divide p/d.  nvcc emits each as its own branch
// region (a fast path and a call for the rest), so a thread's four
// channels do not interleave and the chains' latency is hidden only by
// other warps; at the plan's one block an SM that, and the barriers
// between a row's passes, keep the kernels near half their byte bound.
//
// The plan (ops/lrn_pool.py lrn_pool_plan) gives each block one image, a
// strip of rows and a tile of columns (at AlexNet's shapes the whole image:
// 128 blocks, one an SM); the block walks down its strip one row at a
// time, the loop taking the place of the TPU's sequential grid.  A thread
// takes V = 4 consecutive channels of a pixel as one 16-byte vector (V = 1,
// the scalar form, where C % 4 != 0 or a base is not 16-byte aligned), so
// a pixel is decoded once per vector and x, y, err, offsets and dx move
// as 16-byte loads and stores.
//
// - x is read once.  Each x row the block needs is copied by cp.async into
//   a shared tile, two rows ahead of the one in use, so the copies overlap
//   the arithmetic.  The tile keeps `halo` zeros on each side of a pixel's
//   channels, so the LRN window reads its +-(n-1)/2 neighbours without a
//   bounds test; a zero stands for the reference's clipped slot, which
//   adds 0.0f (and past the first, adds nothing: the plan clips n to
//   2C + 1).
// - Forward, each LRN output is computed once: a row's LRN output goes to a
//   ring of kh + 1 rows in shared memory, so the kh - sh rows that two
//   windows share are kept, not recomputed, and the pass that computes a
//   row also pools the output row whose window the previous row completed
//   (one barrier a row).  Pooling reads the taps t = i*kw + j in flat
//   row-major order; a tap replaces the running winner only when its
//   score (|y| for max-abs) is strictly greater, so ties go to the first
//   tap.  It writes the winner's value and its int32 slot t: bit-equal to
//   LRN then max pooling composed, as the reference's.
// - Backward, err and offsets are read once: the pooled rows that the x
//   rows in use and in flight need are copied into a ring as the walk
//   reaches them.  For each element err_y is gathered from the ring in
//   ascending tap order (descending oh, then descending ow) from 0.0f,
//   adding err * (offset == t), as pooling.cu's scatter and the reference
//   add; then d is recomputed from the x tile, and q = err_y * x * (p/d)
//   goes to a zero-haloed q row in shared memory and err_y * p to another.
//   After a barrier, the window sum of q gives the LRN backward dx, and the
//   preceding layer's activation derivative, evaluated at its output
//   y = x, is folded in (strict ReLU, scaled tanh, sigmoid, smooth ReLU or
//   mul; 0 folds none) by act_math.cuh's fold_act, which the standalone
//   activation backward (activation.cu) shares.
//
// Rounding: lrn_math.cuh's, shared with lrn.cu (every window sum in
// ascending slot order from slot 0 with __fadd_rn, never a sliding sum;
// the vector loads, window sums and halos are lrn_vec.cuh's, which lrn.cu's
// lrn_y and gd_lrn_x kernels share);
// the folded derivatives are act_math.cuh's, expf (smooth ReLU) within 2
// ulp of the host's exp.  Index arithmetic is 32-bit (the wrappers refuse
// 2^31 elements or more) through FastDiv (fastdiv.cuh).

#include <cuda_runtime.h>

#include "act_math.cuh"
#include "fastdiv.cuh"
#include "lrn_math.cuh"
#include "lrn_vec.cuh"
#include "narrow.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kAhead = 2;            // x rows in flight past the one in use
constexpr int kSlots = kAhead + 1;   // x tile rows

struct Geometry {
  FastDiv C, W, H, OW, OH, sh, sw;   // the divisors
  int kh, kw;
};

// A block's share: blockIdx.x = (b * strips + strip) * col_tiles + tile,
// the strip `rows` rows and the tile `cols` columns (output rows and
// columns forward, input ones backward); `vecs` divides by C / V.
struct Tiling {
  FastDiv strips, col_tiles, vecs;
  int rows, cols, halo;
};

// dst (shared) = sizeof(T) * V bytes at src (global), in flight until
// cp_async_wait; 16-byte copies skip L1.
template <int V, typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) * V == 16 || sizeof(T) * V == 4, "16 or 4 bytes");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (sizeof(T) * V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until the groups committed before the last kAhead - 1 are in.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// Where a tensor of W columns lives: unsplit (h0, W columns a row), or as
// the column-parity halves, column iw in half iw & 1 (h0 even, h1 odd) at
// column iw >> 1 of its we = ceil(W/2) or wo = floor(W/2).
template <typename T>
struct Cols {
  T* h0;
  T* h1;
  int split, we, wo;

  // pixel iw of row bh (b * H + row) of C channels
  __device__ __forceinline__ T* at(int bh, int W, int iw, int C) const {
    if (!split) return h0 + (bh * W + iw) * C;
    return (iw & 1) ? h1 + (bh * wo + (iw >> 1)) * C
                    : h0 + (bh * we + (iw >> 1)) * C;
  }
};

// Copy `pixels` pixels of C channels, contiguous at src, into a tile
// whose pixel j starts at dst + j * stride, V channels a copy.
template <int V, typename T>
__device__ __forceinline__ void copy_pixels(T* dst, const T* src, int pixels,
                                            int stride, const FastDiv& vecs) {
  const int n = pixels * vecs.d;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int j = vecs.div(t);
    cp_async<V>(dst + j * stride + (t - j * vecs.d) * V, src + t * V);
  }
}

// Stage `pixels` pixels of row bh of x from column iw0 on into the float
// tile at dst (pixel j at dst + j * stride), V channels a copy: cp.async
// for float (in flight until cp_async_wait), a load converted to float and
// a shared store for a narrow T (done when the next barrier is passed).
template <int V, typename T>
__device__ __forceinline__ void copy_x_row(float* dst, const Cols<const T>& x,
                                           int bh, int W, int iw0, int pixels,
                                           int stride, const FastDiv& vecs) {
  const int n = pixels * vecs.d, C = vecs.d * V;
  const T* row = x.h0 + (bh * W + iw0) * C;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int j = vecs.div(t);
    const int c = (t - j * vecs.d) * V;
    const T* src = x.split ? x.at(bh, W, iw0 + j, C) + c : row + t * V;
    if constexpr (kNarrow<T>) {
      float v[V];
      load_vec<V>(src, v);
      store_vec<V>(dst + j * stride + c, v);
    } else {
      cp_async<V>(dst + j * stride + c, src);
    }
  }
}

template <int V, int kN, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_maxpool_kernel(Cols<const T> x, T* __restrict__ y,
                       int* __restrict__ offsets, Geometry g, Tiling tl,
                       LrnParams p, int use_abs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = g.H.d, W = g.W.d, C = g.C.d, OH = g.OH.d, OW = g.OW.d;
  const int kh = g.kh, kw = g.kw, sh = g.sh.d, sw = g.sw.d;
  const int halo = tl.halo, P = C + 2 * halo;
  const int q = tl.col_tiles.div(blockIdx.x);
  const int tile = blockIdx.x - q * tl.col_tiles.d;
  const int b = tl.strips.div(q);
  const int r0 = (q - b * tl.strips.d) * tl.rows;
  const int r1 = min(OH, r0 + tl.rows);
  const int ow0 = tile * tl.cols, n_ow = min(OW - ow0, tl.cols);
  const int wi_max = (tl.cols - 1) * sw + kw;   // the tile's layout
  const int wi = (n_ow - 1) * sw + kw;          // its input columns
  const int x_slot = wi_max * P;                // floats a tile row
  const int ring_rows = kh + 1;                 // LRN output rows kept
  float* ring = smem + kSlots * x_slot;         // of wi_max x C each
  zero_halos(smem, kSlots, wi_max, C, halo);

  const int bh = b * H, iw0 = ow0 * sw;
  const int last = (r1 - 1) * sh + kh - 1;      // the strip's last x row
  // the next row after `row` that some window holds (rows that no window
  // holds, where sh > kh, are skipped)
  auto next_row = [&](int row) {
    const int top = g.sh.div(row + 1) * sh;
    return row + 1 - top < kh ? row + 1 : top + sh;
  };
  // the row in use and the kAhead rows after it in flight, in tile slots
  // taken in turn: one commit group a row (empty past the strip), so
  // cp_async_wait finds the row in use in
  int ih = r0 * sh, ahead = ih;
  for (int a = 0; a < kAhead; ++a) {
    if (a > 0) ahead = next_row(ahead);
    if (ahead <= last) {
      copy_x_row<V>(smem + a * x_slot + halo, x, bh + ahead, W, iw0, wi, P,
                    tl.vecs);
    }
    cp_async_commit();
  }
  // pool output row r from its kh ring rows, the first at ring row `first`
  auto pool = [&](int r, int first) {
    const int nv = n_ow * tl.vecs.d;
    for (int t = threadIdx.x; t < nv; t += blockDim.x) {
      const int jo = tl.vecs.div(t);
      const int c = (t - jo * tl.vecs.d) * V;
      float best[V], val[V];
      int slot_of[V];
      int ring_row = first, tp = 0;
      for (int i = 0; i < kh; ++i) {
        const float* row = ring + ring_row * wi_max * C + jo * sw * C + c;
        for (int j = 0; j < kw; ++j, ++tp) {
          float v[V];
          load_vec<V>(row + j * C, v);
#pragma unroll
          for (int l = 0; l < V; ++l) {
            const float sc = use_abs ? fabsf(v[l]) : v[l];
            if (tp == 0 || sc > best[l]) {
              best[l] = sc;
              val[l] = v[l];
              slot_of[l] = tp;
            }
          }
        }
        ring_row = ring_row + 1 == ring_rows ? 0 : ring_row + 1;
      }
      const int o = ((b * OH + r) * OW + ow0 + jo) * C + c;
      store_vec<V>(y + o, val);
      store_vec<V>(offsets + o, slot_of);
    }
  };
  // slot: the x tile row of row ih; at: its ring row; pending: the output
  // row whose window is complete but not yet pooled (-1: none)
  int pending = -1, pending_at = 0;
  for (int slot = 0, at = 0, r = r0;;) {
    cp_async_wait();
    __syncthreads();   // row ih is in; no thread reads the slot the next
                       // copy takes, nor the ring row that ih replaces
    ahead = next_row(ahead);
    if (ahead <= last) {
      const int to = slot + kAhead < kSlots ? slot + kAhead
                                            : slot + kAhead - kSlots;
      copy_x_row<V>(smem + to * x_slot + halo, x, bh + ahead, W, iw0, wi, P,
                    tl.vecs);
    }
    cp_async_commit();
    // LRN of row ih into ring row `at`, and in the same pass the window
    // that the previous row completed (its kh ring rows precede `at`)
    {
      const float* xr = smem + slot * x_slot + halo;
      float* yr = ring + at * wi_max * C;
      const int nv = wi * tl.vecs.d;
      for (int t = threadIdx.x; t < nv; t += blockDim.x) {
        const int j = tl.vecs.div(t);
        const float* xv = xr + j * P + (t - j * tl.vecs.d) * V;
        float s[V], xa[V], ya[V];
        window_sums<V, kN, true>(xv, p, s);
        load_vec<V>(xv, xa);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ya[i] = __fmul_rn(xa[i], lrn_dpow_nbeta(lrn_d(s[i], p), p));
        }
        if constexpr (kNarrow<T>) {   // y as stored, before the compare
#pragma unroll
          for (int i = 0; i < V; ++i) ya[i] = round_to<T>(ya[i]);
        }
        store_vec<V>(yr + t * V, ya);
      }
    }
    if (pending >= 0) pool(pending, pending_at);
    pending = -1;
    if (ih == r * sh + kh - 1) {   // output row r's window is complete
      pending = r++;
      pending_at = at >= kh - 1 ? at - (kh - 1) : at - (kh - 1) + ring_rows;
    }
    if (ih == last) break;
    ih = next_row(ih);
    slot = slot + 1 == kSlots ? 0 : slot + 1;
    at = at + 1 == ring_rows ? 0 : at + 1;
  }
  __syncthreads();
  pool(pending, pending_at);
}

template <int V, int kN, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gd_lrn_maxpool_kernel(const float* __restrict__ err,
                          const int* __restrict__ offsets, Cols<const T> x,
                          Cols<float> dx, Geometry g, Tiling tl, LrnParams p,
                          int act) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = g.H.d, W = g.W.d, C = g.C.d, OH = g.OH.d, OW = g.OW.d;
  const int kh = g.kh, kw = g.kw, sh = g.sh.d, sw = g.sw.d;
  const int halo = tl.halo, P = C + 2 * halo;
  const int q = tl.col_tiles.div(blockIdx.x);
  const int tile = blockIdx.x - q * tl.col_tiles.d;
  const int b = tl.strips.div(q);
  const int h0 = (q - b * tl.strips.d) * tl.rows;
  const int h1 = min(H, h0 + tl.rows);
  const int w0 = tile * tl.cols, n_w = min(W - w0, tl.cols);
  // the pooled columns whose windows reach the tile: [oc0, oc0 + n_oc)
  const int first_w = w0 - kw + 1;
  const int oc0 = first_w <= 0 ? 0 : g.sw.div(first_w + sw - 1);
  const int n_oc = min(OW - 1, g.sw.div(w0 + n_w - 1)) - oc0 + 1;
  const int ecols = min(OW, (tl.cols + kw - 2) / sw + 1);   // layout
  // the pooled rows that rows ih .. ih + kAhead need at once
  const int ring_rows = (kh - 1 + kAhead) / sh + 1;
  const int x_slot = tl.cols * P;
  float* qs = smem + kSlots * x_slot;
  float* eps = qs + tl.cols * P;
  float* ering = eps + tl.cols * C;
  int* oring = reinterpret_cast<int*>(ering + ring_rows * ecols * C);
  zero_halos(smem, kSlots + 1, tl.cols, C, halo);

  // pooled rows whose windows hold input row ih: [oh_lo(ih), oh_hi(ih)]
  auto oh_lo = [&](int ih) {
    const int first = ih - kh + 1;
    return first <= 0 ? 0 : g.sh.div(first + sh - 1);
  };
  auto oh_hi = [&](int ih) { return min(OH - 1, g.sh.div(ih)); };
  const int eb = (b * OH * OW + oc0) * C;
  int loaded = -1;   // pooled rows up to this one are in the ring
  // x row ih into tile slot `slot` and the pooled rows it needs into the
  // ring, as one commit group (empty past the strip)
  auto copy_rows = [&](int ih, int slot) {
    if (ih >= h1) {
      cp_async_commit();
      return;
    }
    copy_x_row<V>(smem + slot * x_slot + halo, x, b * H + ih, W, w0, n_w, P,
                  tl.vecs);
    const int hi = oh_hi(ih);
    for (int oh = max(loaded + 1, oh_lo(ih)); oh <= hi; ++oh) {
      const int ring_row = oh % ring_rows;
      copy_pixels<V>(ering + ring_row * ecols * C, err + eb + oh * OW * C,
                     n_oc, C, tl.vecs);
      copy_pixels<V>(oring + ring_row * ecols * C,
                     offsets + eb + oh * OW * C, n_oc, C, tl.vecs);
    }
    loaded = max(loaded, hi);
    cp_async_commit();
  };
  for (int a = 0; a < kAhead; ++a) copy_rows(h0 + a, a);
  for (int ih = h0, slot = 0; ih < h1; ++ih) {
    cp_async_wait();
    __syncthreads();   // row ih and its pooled rows are in; q, eps free
    copy_rows(ih + kAhead, slot + kAhead < kSlots ? slot + kAhead
                                                  : slot + kAhead - kSlots);
    const float* xr = smem + slot * x_slot + halo;
    const int lo = oh_lo(ih), hi = oh_hi(ih);
    const int ring_hi = hi % ring_rows;
    const int nv = n_w * tl.vecs.d;
    for (int t = threadIdx.x; t < nv; t += blockDim.x) {
      const int j = tl.vecs.div(t);
      const int c = (t - j * tl.vecs.d) * V;
      const int iw = w0 + j;
      const int fw = iw - kw + 1;
      const int ow_lo = fw <= 0 ? 0 : g.sw.div(fw + sw - 1);
      const int ow_hi = min(OW - 1, g.sw.div(iw));
      float e[V];
#pragma unroll
      for (int l = 0; l < V; ++l) e[l] = 0.0f;
      int ring_row = ring_hi;
      for (int oh = hi; oh >= lo; --oh) {
        const int ti = (ih - oh * sh) * kw + iw;   // tap = ti - ow * sw
        const int ro = ring_row * ecols * C - oc0 * C + c;
        for (int ow = ow_hi; ow >= ow_lo; --ow) {
          float ev[V];
          int ov[V];
          load_vec<V>(ering + ro + ow * C, ev);
          load_vec<V>(oring + ro + ow * C, ov);
          const int tap = ti - ow * sw;
          // err * (offsets == t), as the reference multiplies: err*1 or
          // err*0
#pragma unroll
          for (int l = 0; l < V; ++l) {
            e[l] = __fadd_rn(e[l], ov[l] == tap ? ev[l]
                                                : __fmul_rn(ev[l], 0.0f));
          }
        }
        ring_row = ring_row == 0 ? ring_rows - 1 : ring_row - 1;
      }
      const float* xv = xr + j * P + c;
      float s[V], xa[V], qa[V], ep[V];
      window_sums<V, kN, true>(xv, p, s);
      load_vec<V>(xv, xa);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const float d = lrn_d(s[l], p);
        const float pc = lrn_dpow_nbeta(d, p);
        qa[l] = lrn_q(e[l], xa[l], d, pc);
        ep[l] = __fmul_rn(e[l], pc);
      }
      store_vec<V>(qs + halo + j * P + c, qa);
      store_vec<V>(eps + t * V, ep);
    }
    __syncthreads();   // the q row is in
    float* dxr = dx.h0 + ((b * H + ih) * W + w0) * C;
    for (int t = threadIdx.x; t < nv; t += blockDim.x) {
      const int j = tl.vecs.div(t);
      const int c = (t - j * tl.vecs.d) * V;
      float ws[V], xa[V], ep[V], out[V];
      window_sums<V, kN, false>(qs + halo + j * P + c, p, ws);
      load_vec<V>(xr + j * P + c, xa);
      load_vec<V>(eps + t * V, ep);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        out[l] = act_math::fold_act(lrn_dx(ep[l], xa[l], ws[l], p), xa[l],
                                    act);
      }
      store_vec<V>(dx.split ? dx.at(b * H + ih, W, w0 + j, C) + c
                            : dxr + t * V, out);
    }
    slot = slot + 1 == kSlots ? 0 : slot + 1;
  }
}

Geometry make_geometry(int H, int W, int C, int OH, int OW, int kh, int kw,
                       int sh, int sw) {
  return Geometry{make_fastdiv(C),  make_fastdiv(W),  make_fastdiv(H),
                  make_fastdiv(OW), make_fastdiv(OH), make_fastdiv(sh),
                  make_fastdiv(sw), kh, kw};
}

template <typename T>
using ForwardKernel = void (*)(Cols<const T>, T*, int*, Geometry, Tiling,
                               LrnParams, int);
template <typename T>
using BackwardKernel = void (*)(const float*, const int*, Cols<const T>,
                                Cols<float>, Geometry, Tiling, LrnParams,
                                int);

// The kernel instance of a plan: V = 4 or 1, n = 5 fixed at compile time
// (AlexNet's and every shipped config's) or read at run time.
template <typename T>
ForwardKernel<T> forward_kernel(int vec, int n) {
  if (vec == 4) {
    return n == 5 ? lrn_maxpool_kernel<4, 5, T> : lrn_maxpool_kernel<4, 0, T>;
  }
  return lrn_maxpool_kernel<1, 0, T>;
}

template <typename T>
BackwardKernel<T> backward_kernel(int vec, int n) {
  if (vec == 4) {
    return n == 5 ? gd_lrn_maxpool_kernel<4, 5, T>
                  : gd_lrn_maxpool_kernel<4, 0, T>;
  }
  return gd_lrn_maxpool_kernel<1, 0, T>;
}

template <typename T>
int lrn_maxpool(Cols<const T> x, T* y, int* offsets, int B, int H, int W,
                int C, int kh, int kw, int sh, int sw, double alpha,
                double beta, double k, int use_abs, int vec, int n, int halo,
                int rows, int strips, int cols, int col_tiles, int threads,
                int smem, void* stream) {
  const int OH = (H - kh) / sh + 1;
  const int OW = (W - kw) / sw + 1;
  if (B <= 0 || OH <= 0 || OW <= 0 || C <= 0) return 0;
  const Tiling tl{make_fastdiv(strips), make_fastdiv(col_tiles),
                  make_fastdiv(C / vec), rows, cols, halo};
  return launch(forward_kernel<T>(vec, n), B * strips * col_tiles, threads,
                smem, stream, x, y, offsets,
                make_geometry(H, W, C, OH, OW, kh, kw, sh, sw), tl,
                make_lrn_params(C, n, alpha, beta, k), use_abs);
}

template <typename T>
int gd_lrn_maxpool(const float* err, const int* offsets, Cols<const T> x,
                   Cols<float> dx, int B, int H, int W, int C, int kh,
                   int kw, int sh, int sw, double alpha, double beta,
                   double k, int act, int vec, int n, int halo, int rows,
                   int strips, int cols, int col_tiles, int threads,
                   int smem, void* stream) {
  const int OH = (H - kh) / sh + 1;
  const int OW = (W - kw) / sw + 1;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  const Tiling tl{make_fastdiv(strips), make_fastdiv(col_tiles),
                  make_fastdiv(C / vec), rows, cols, halo};
  return launch(backward_kernel<T>(vec, n), B * strips * col_tiles, threads,
                smem, stream, err, offsets, x, dx,
                make_geometry(H, W, C, OH, OW, kh, kw, sh, sw), tl,
                make_lrn_params(C, n, alpha, beta, k), act);
}

template <typename T>
Cols<T> unsplit(T* p) {
  return Cols<T>{p, nullptr, 0, 0, 0};
}

template <typename T>
Cols<T> halves(T* e, T* o, int W) {
  return Cols<T>{e, o, 1, (W + 1) / 2, W / 2};
}

}  // namespace

// The entry points take the plan of ops/lrn_pool.py lrn_pool_plan (vec,
// n clipped to 2C + 1, halo, rows, strips, cols, col_tiles, threads,
// smem), launch on `stream`, do not synchronise, and return the launch
// status (cudaGetLastError) as an int, 0 on success.  Each comes in the
// three storage types of x and y (suffix f32, bf16, f16); W is the logical
// width.  The _split forms take x as its halves xe (B, H, ceil(W/2), C)
// and xo (B, H, floor(W/2), C); the backward's writes dx as halves into
// dxe and dxo where dx_split is 1, else unsplit into dxe.

#define ZNICZ_LRN_POOL_ENTRIES(T, SFX)                                        \
  extern "C" int znicz_lrn_maxpool_##SFX(                                     \
      const T* x, T* y, int* offsets, int B, int H, int W, int C, int kh,     \
      int kw, int sh, int sw, double alpha, double beta, double k,            \
      int use_abs, int vec, int n, int halo, int rows, int strips, int cols,  \
      int col_tiles, int threads, int smem, void* stream) {                   \
    return lrn_maxpool<T>(unsplit(x), y, offsets, B, H, W, C, kh, kw, sh, sw, \
                          alpha, beta, k, use_abs, vec, n, halo, rows,        \
                          strips, cols, col_tiles, threads, smem, stream);    \
  }                                                                           \
  extern "C" int znicz_lrn_maxpool_split_##SFX(                               \
      const T* xe, const T* xo, T* y, int* offsets, int B, int H, int W,      \
      int C, int kh, int kw, int sh, int sw, double alpha, double beta,       \
      double k, int use_abs, int vec, int n, int halo, int rows, int strips,  \
      int cols, int col_tiles, int threads, int smem, void* stream) {         \
    return lrn_maxpool<T>(halves(xe, xo, W), y, offsets, B, H, W, C, kh, kw,  \
                          sh, sw, alpha, beta, k, use_abs, vec, n, halo,      \
                          rows, strips, cols, col_tiles, threads, smem,       \
                          stream);                                            \
  }                                                                           \
  extern "C" int znicz_gd_lrn_maxpool_##SFX(                                  \
      const float* err, const int* offsets, const T* x, float* dx, int B,     \
      int H, int W, int C, int kh, int kw, int sh, int sw, double alpha,      \
      double beta, double k, int act, int vec, int n, int halo, int rows,     \
      int strips, int cols, int col_tiles, int threads, int smem,             \
      void* stream) {                                                         \
    return gd_lrn_maxpool<T>(err, offsets, unsplit(x), unsplit(dx), B, H, W,  \
                             C, kh, kw, sh, sw, alpha, beta, k, act, vec, n,  \
                             halo, rows, strips, cols, col_tiles, threads,    \
                             smem, stream);                                   \
  }                                                                           \
  extern "C" int znicz_gd_lrn_maxpool_split_##SFX(                            \
      const float* err, const int* offsets, const T* xe, const T* xo,         \
      float* dxe, float* dxo, int dx_split, int B, int H, int W, int C,       \
      int kh, int kw, int sh, int sw, double alpha, double beta, double k,    \
      int act, int vec, int n, int halo, int rows, int strips, int cols,      \
      int col_tiles, int threads, int smem, void* stream) {                   \
    return gd_lrn_maxpool<T>(                                                 \
        err, offsets, halves(xe, xo, W),                                      \
        dx_split ? halves(dxe, dxo, W) : unsplit(dxe), B, H, W, C, kh, kw,    \
        sh, sw, alpha, beta, k, act, vec, n, halo, rows, strips, cols,        \
        col_tiles, threads, smem, stream);                                    \
  }

ZNICZ_FOR_EACH_STORAGE(ZNICZ_LRN_POOL_ENTRIES)
