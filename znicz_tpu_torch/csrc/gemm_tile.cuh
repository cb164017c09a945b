// The SIMT tile loop of matmul_at_b (csrc/matmul_at_b.cu), with the
// operands' loaders as template parameters.  (The port's other products,
// the convs and the unit graph's matmul, run on the tensor-core loop of
// csrc/gemm_tc.cuh.)
//
// A block computes a 64x64 tile of C = A.B: 256 threads, each accumulating
// a 4x4 register micro-tile, the reduction stepped 16 at a time through
// shared memory.  A loader says where an operand element comes from: a
// dense matrix (DepthMajor below).
//
// Words used here: a tile has kBM rows of C, kBN columns, and a depth (the
// reduction index t).  A loader's load(s, i0, t0) fills
//   s[kk][ii] = operand(i0 + ii, t0 + kk),  ii < 64, kk < kBK,
// with 0 outside the operand; the A loader's index runs over C's rows, the
// B loader's over its columns.  A loader walks either its depth fastest
// (depth_fast_*: neighbouring threads on neighbouring t, for operands
// stored with t innermost) or its index fastest (index_fast_*: for
// operands stored with t outermost), so that neighbouring threads read
// neighbouring addresses.
//
// at_b_block is C (rows, cols) = sum over t of A(t, row) B(t, col), the
// shape of a weight gradient: C is small and the depth (an image's pixels)
// is huge, so a grid of C's tiles alone would leave most SMs idle.  The
// depth is split into chunks across gridDim.z; each split writes its
// partial tile to its own slice of a float32 workspace, and
// split_sum_kernel (csrc/split_sum.cuh) adds the slices in ascending
// order.  No atomics: the card repeats a result bit for bit.
//
// Arithmetic: float32 operands, FFMA into float32 accumulators; no TF32,
// no tensor cores (the reference pins float32 products; its bf16 operand
// cast is TPU-only).

#pragma once

#include <cuda_runtime.h>

#include "split_sum.cuh"

namespace {

constexpr int kBM = 64;   // rows of C a block
constexpr int kBN = 64;   // columns of C a block
constexpr int kBK = 16;   // depth a shared-memory step
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kPad = 4;   // keeps rows 16-byte aligned for the float4 reads
constexpr int kLoads = kBM * kBK / kThreads;          // 4 elements a thread
static_assert(kBM == kBN, "one loader type serves either operand");
static_assert(kThreads % kBK == 0 && kThreads % kBM == 0,
              "a thread keeps one depth (or one index) across its loads");

typedef float Tile[kBK][kBM + kPad];

// depth fastest: thread tid loads (ii, kk) = (tid / kBK + l * 16, tid % kBK)
__device__ __forceinline__ int depth_fast_kk() {
  return static_cast<int>(threadIdx.x) % kBK;
}
__device__ __forceinline__ int depth_fast_ii(int l) {
  return static_cast<int>(threadIdx.x) / kBK + l * (kThreads / kBK);
}
// index fastest: thread tid loads (ii, kk) = (tid % kBM, tid / kBM + l * 4)
__device__ __forceinline__ int index_fast_ii() {
  return static_cast<int>(threadIdx.x) % kBM;
}
__device__ __forceinline__ int index_fast_kk(int l) {
  return static_cast<int>(threadIdx.x) / kBM + l * (kThreads / kBM);
}

// operand(i, t) = p[t * ld + i] for i < n, t < depth: a row-major matrix
// whose rows are the depth (aT.b's a and b, a conv's HWIO weights as
// (K, OC), an NHWC error as (B.OH.OW, OC)).
struct DepthMajor {
  const float* p;
  int n;
  int depth;
  int ld;

  __device__ __forceinline__ void load(Tile& s, int i0, int t0) const {
    const int ii = index_fast_ii();
    const int i = i0 + ii;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int kk = index_fast_kk(l);
      const int t = t0 + kk;
      s[kk][ii] = (i < n && t < depth)
                      ? p[static_cast<long long>(t) * ld + i] : 0.0f;
    }
  }
};

// acc += A(r0.., t) B(t, c0..) over t in [t_begin, t_end), kBK at a time.
template <class LoadA, class LoadB>
__device__ __forceinline__ void mainloop(const LoadA& la, const LoadB& lb,
                                         Tile& as, Tile& bs, int r0, int c0,
                                         int t_begin, int t_end,
                                         float (&acc)[kTM][kTN]) {
  const int tx = static_cast<int>(threadIdx.x) % (kBN / kTN);
  const int ty = static_cast<int>(threadIdx.x) / (kBN / kTN);
  for (int t0 = t_begin; t0 < t_end; t0 += kBK) {
    la.load(as, r0, t0);
    lb.load(bs, c0, t0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * kTN]);
      const float ar[kTM] = {av.x, av.y, av.z, av.w};
      const float br[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// C's tile at (r0, c0) into the row-major (rows, cols) matrix c.
__device__ __forceinline__ void store_tile(const float (&acc)[kTM][kTN],
                                           float* __restrict__ c, int rows,
                                           int cols, int r0, int c0) {
  const int tx = static_cast<int>(threadIdx.x) % (kBN / kTN);
  const int ty = static_cast<int>(threadIdx.x) / (kBN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty * kTM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = c0 + tx * kTN + j;
      if (col < cols) c[static_cast<long long>(r) * cols + col] = acc[i][j];
    }
  }
}

// One block of C (rows, cols) = sum over t < depth of A(t, row) B(t, col):
// tile (blockIdx.x, blockIdx.y), depth chunk blockIdx.z of `chunk` (a
// multiple of kBK).  With one split the tile goes to `out`; with more, to
// the split's slice of `ws` (splits, rows, cols), summed by split_sum.
template <class LoadA, class LoadB>
__device__ __forceinline__ void at_b_block(const LoadA& la, const LoadB& lb,
                                           Tile& as, Tile& bs,
                                           float* __restrict__ out,
                                           float* __restrict__ ws, int rows,
                                           int cols, int depth, int chunk) {
  const int r0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBN;
  const int t_begin = blockIdx.z * chunk;
  const int t_end = min(depth, t_begin + chunk);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  mainloop(la, lb, as, bs, r0, c0, t_begin, t_end, acc);
  float* dst = gridDim.z == 1
                   ? out
                   : ws + static_cast<long long>(blockIdx.z) * rows * cols;
  store_tile(acc, dst, rows, cols, r0, c0);
}

}  // namespace
