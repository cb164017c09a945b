// Tiled float32 matrix product C = A·B for the unit graph's fc units.
//
// Replaces the TPU kernel znicz_tpu/ops/matmul.py pallas_matmul
// (_matmul_kernel): a block-tiled product with a float32 accumulator over a
// K-innermost grid.  Used by All2All's forward (x·W) and GradientDescent's
// weight gradient (xᵀ·err_y) and input error (err_y·Wᵀ).
//
// Precision: full float32 operands and a float32 accumulator, as the
// reference's CPU tier runs it.  The reference casts operands to bf16 on a
// TPU (_mxu_cast); this kernel does not, and uses no TF32 or bf16, so no
// tensor cores: it is a SIMT SGEMM.  A wgmma version with bf16 or TF32
// inputs changes the numbers and needs its own stated tolerance.
//
// Operands are strided views: A is read at a[m*sam + k*sak] and B at
// b[k*sbk + n*sbn], so xᵀ and Wᵀ reach the kernel as views of the row-major
// tensors and no transposed copy is made.  C is written contiguous
// row-major.  Ragged M, N and K are masked at the tile edge (zeros are
// loaded outside the matrix), never padded in device memory.
//
// Bound on an H100: operations at large shapes (2·M·N·K flops over the
// 67 TFLOP/s float32 peak; (128, 9216)·(9216, 4096) needs 0.144 ms), the
// launch at MNIST's (100 × 784 × 100 is 15.7 Mflop, 0.23 µs of work).  The
// design: a 64×64 tile of C a block, 256 threads each accumulating a 4×4
// register micro-tile, K stepped 16 at a time through shared memory, so
// each operand element loaded from device memory feeds 64 fused
// multiply-adds.  The tile loaders read along whichever of an operand's
// two strides is 1, so both a row-major operand and a transposed view load
// with neighbouring threads on neighbouring addresses; the shared tiles are
// padded by 4 floats to spread the transposing stores over banks, and read
// back as float4.  No double buffering or split-K yet: at (128, 9216,
// 4096) the grid is 128 blocks on 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kPad = 4;   // keeps rows 16-byte aligned for the float4 reads

__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int m, int n, int k, long long sam,
              long long sak, long long sbk, long long sbn) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];   // as[kk][mm]
  __shared__ __align__(16) float bs[kBK][kBN + kPad];   // bs[kk][nn]
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);   // column group of the micro-tile
  const int ty = tid / (kBN / kTN);   // row group
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const bool a_k_fast = (sak == 1);   // row-major A: walk k first
  const bool b_n_fast = (sbn == 1);   // row-major B: walk n first

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int mm = a_k_fast ? i / kBK : i % kBM;
      const int kk = a_k_fast ? i % kBK : i / kBM;
      const int gm = row0 + mm;
      const int gk = k0 + kk;
      as[kk][mm] = (gm < m && gk < k) ? a[gm * sam + gk * sak] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int nn = b_n_fast ? i % kBN : i / kBK;
      const int kk = b_n_fast ? i / kBN : i % kBK;
      const int gk = k0 + kk;
      const int gn = col0 + nn;
      bs[kk][nn] = (gk < k && gn < n) ? b[gk * sbk + gn * sbn] : 0.0f;
    }
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
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = row0 + ty * kTM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = col0 + tx * kTN + j;
      if (gn < n) c[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
}

}  // namespace

// C (m, n) contiguous = A·B with A, B given by base pointer and element
// strides.  m, n > 0 (the wrapper returns an empty product without a
// launch); k may be 0 (C = 0).  Launches on `stream`, does not synchronise;
// returns cudaGetLastError() as an int, 0 on success.
extern "C" int znicz_matmul_f32(const float* a, const float* b, float* c,
                                int m, int n, int k, long long sam,
                                long long sak, long long sbk, long long sbn,
                                void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, n, k, sam, sak, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}
