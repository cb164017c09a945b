// Fused SOM winner search: for each sample b of x (B, F) and every neuron
// n of the codebook w (N, F),
//   d[b, n] = (|x_b|^2 - 2 * x_b . w_n) + |w_n|^2,
// keeping a running (min, argmin) per sample; the (B, N) matrix is never
// written.  Outputs: win int32 (B,), dmin float32 (B,).
//
// dist_argmin_kernel replaces the TPU kernel znicz_tpu/ops/kohonen.py
// pallas_distance_argmin (_dist_argmin_kernel).  Ties keep the lowest
// neuron index, as the reference's (jnp.argmin takes the first index in a
// tile, and tiles merge with a strict <): a thread walks its neurons in
// ascending order with a strict <, and the eight threads of a row reduce
// with "smaller value, else smaller index".
//
// Design.  A block takes 32 rows of x and walks neuron tiles of 32 through
// shared memory, 32 features at a time; thread (row r, slot s) owns
// neurons s, s+8, s+16, s+24 of each tile and accumulates their cross
// terms in float32 FFMA (no tensor cores: the reference pins full float32
// products, so TF32 is not allowed).  The squares |x_b|^2 and |w_n|^2 are
// summed in the same pass, each thread taking four features of its row
// and of one neuron, reduced over the slots with shuffles.  One block a
// row tile walks every neuron tile, so the grid is ceil(B / 32) blocks.
//
// Bound on an H100: at the SOM sample's (100, 64, 2) the launch (the work
// is ~26k multiply-adds); at a 32x32 sheet on MNIST-width inputs (256,
// 1024, 784) float operations, 2*B*N*F = 411 MFLOP, ~6.1 us at 67 TFLOP/s,
// against 4 MB of operands (~1.2 us).  Each multiply-add here reads its
// neuron's feature from shared memory (the row's is shared by four), so
// the kernel is bound by shared-memory loads, at some fraction of the
// float32 peak; register tiling over rows is the next step.
//
// Rounding: the cross term is summed in another order than the plain
// version's cuBLAS product, so dmin agrees within a tolerance and a winner
// can differ only where the plain version's two smallest distances lie
// within that rounding.  Inputs are taken as finite.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kRows = 32;     // rows of x a block
constexpr int kNeurons = 32;  // neurons a tile
constexpr int kChunk = 32;    // features a shared-memory chunk
constexpr int kSlots = 8;     // threads a row
constexpr int kPerSlot = kNeurons / kSlots;
constexpr int kThreads = kRows * kSlots;
static_assert(kRows == kNeurons, "a thread sums the squares of row r and "
              "of neuron r of the tile");
static_assert(kChunk == kSlots * 4, "each slot squares four features");

// (v, i) <- (ov, oi) when ov is smaller, or equal with a smaller index
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
dist_argmin_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   int* __restrict__ win, float* __restrict__ dmin, int B,
                   int N, int F) {
  __shared__ float xs[kRows][kChunk + 1];
  __shared__ float ws[kNeurons][kChunk + 1];
  __shared__ float x2s[kRows];
  __shared__ float w2s[kNeurons];

  const int t = threadIdx.x;
  const int r = t / kSlots;
  const int slot = t % kSlots;
  const int row0 = blockIdx.x * kRows;

  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = INT_MAX;
  for (int n0 = 0; n0 < N; n0 += kNeurons) {
    float acc[kPerSlot];
#pragma unroll
    for (int q = 0; q < kPerSlot; ++q) acc[q] = 0.0f;
    float x2 = 0.0f, w2 = 0.0f;  // this thread's four features of each
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      for (int e = t; e < kRows * kChunk; e += kThreads) {
        const int rr = e / kChunk;
        const int k = e % kChunk;
        const int f = f0 + k;
        const int row = row0 + rr;
        const int n = n0 + rr;
        xs[rr][k] = (row < B && f < F) ? x[row * F + f] : 0.0f;
        ws[rr][k] = (n < N && f < F) ? w[n * F + f] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xv = xs[r][slot * 4 + q];
        const float wv = ws[r][slot * 4 + q];
        x2 = fmaf(xv, xv, x2);
        w2 = fmaf(wv, wv, w2);
      }
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        const float xv = xs[r][k];
#pragma unroll
        for (int q = 0; q < kPerSlot; ++q) {
          acc[q] = fmaf(xv, ws[slot + kSlots * q][k], acc[q]);
        }
      }
      __syncthreads();
    }
    // the eight slots of a row are eight neighbouring lanes
#pragma unroll
    for (int o = kSlots / 2; o > 0; o >>= 1) {
      x2 += __shfl_xor_sync(0xffffffffu, x2, o);
      w2 += __shfl_xor_sync(0xffffffffu, w2, o);
    }
    if (slot == 0) {
      x2s[r] = x2;
      w2s[r] = w2;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPerSlot; ++q) {
      const int j = slot + kSlots * q;
      const int n = n0 + j;
      if (n < N) {
        // 2 * acc is exact; two rounded steps, never contracted
        const float d = __fadd_rn(__fsub_rn(x2s[r], 2.0f * acc[q]), w2s[j]);
        if (d < best) {  // ascending n: a tie keeps the earlier neuron
          best = d;
          best_i = n;
        }
      }
    }
    __syncthreads();  // x2s and w2s are the next tile's
  }
#pragma unroll
  for (int o = kSlots / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    take_better(best, best_i, ov, oi);
  }
  const int row = row0 + r;
  if (slot == 0 && row < B) {
    win[row] = best_i;
    dmin[row] = best;
  }
}

}  // namespace

// B > 0 rows, N > 0 neurons, F features, contiguous float32 x (B, F) and w
// (N, F), B*F and N*F below 2^31.  Launches on `stream`, does not
// synchronise; returns cudaGetLastError() as an int.
extern "C" int znicz_distance_argmin_f32(const float* x, const float* w,
                                         int* win, float* dmin, int B, int N,
                                         int F, void* stream) {
  dist_argmin_kernel<<<(B + kRows - 1) / kRows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, w, win, dmin,
                                                            B, N, F);
  return static_cast<int>(cudaGetLastError());
}
