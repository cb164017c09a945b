// C = aT.b for row-major a (M, K) and b (M, N): the (K, N) float32 product
// over the shared row index, without a transposed copy of a.
//
// Replaces the TPU kernel znicz_tpu/ops/matmul.py pallas_matmul_at_b
// (_matmul_at_b_kernel), which keeps a (K, N) accumulator in VMEM while
// the M rows stream through the sequential grid axis.  Here the M rows are
// the depth of csrc/gemm_tile.cuh's at_b_block: both operands are read
// with the index fastest (neighbouring threads on neighbouring columns of
// one row), so a is read in its own layout and aT never exists.
//
// Bound on an H100: float operations at the conv weight-gradient shapes
// (2.M.K.N over the 67 TFLOP/s float32 peak; AlexNet conv2's patch matrix
// (93312, 2400)T.(93312, 256) is 115 GFLOP, 1.71 ms), bytes for small K.N
// over a long M.  The output is small and M huge (CIFAR conv1's weight
// gradient is 2 tiles of C over 102,400 rows), so M is split across
// gridDim.z until the grid has about 264 blocks (two on each of 132 SMs);
// the splits' partial tiles go to a float32 workspace and split_sum_kernel
// adds them in ascending order, so the sum is the same on every run.  The
// wrapper (ops/matmul.py matmul_at_b) chooses the split and allocates the
// workspace.

#include "gemm_tile.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
matmul_at_b_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, float* __restrict__ ws, int m,
                   int k, int n, int chunk) {
  __shared__ __align__(16) Tile as;
  __shared__ __align__(16) Tile bs;
  at_b_block(DepthMajor{a, k, m, k}, DepthMajor{b, n, m, n}, as, bs, out, ws,
             k, n, m, chunk);
}

}  // namespace

// out (k, n) contiguous = aT.b.  m, k, n > 0 (the wrapper answers empty
// shapes without a launch); `splits` chunks of `chunk` rows (a multiple of
// 16) cover m; with splits > 1, ws holds splits * k * n floats.  Launches
// on `stream`, does not synchronise; returns cudaGetLastError() as an int.
extern "C" int znicz_matmul_at_b_f32(const float* a, const float* b,
                                     float* out, float* ws, int m, int k,
                                     int n, int splits, int chunk,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((k + kBM - 1) / kBM, (n + kBN - 1) / kBN, splits);
  matmul_at_b_kernel<<<grid, kThreads, 0, st>>>(a, b, out, ws, m, k, n,
                                                chunk);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  return launch_split_sum(ws, out, k * n, splits, st);
}
