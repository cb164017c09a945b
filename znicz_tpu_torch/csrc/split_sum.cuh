// The second pass of a product whose depth is split across gridDim.z
// (csrc/gemm_tc.cuh split_block): each
// split wrote its partial C to its own slice of a float32 workspace
// (splits, rows, cols), and split_sum_kernel adds the slices in ascending
// split order.  No atomics: the card repeats a result bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

// out[i] = ws[0][i] + ws[1][i] + ... in ascending split order.
__global__ void split_sum_kernel(const float* __restrict__ ws,
                                 float* __restrict__ out, int n, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z)
      s += ws[static_cast<long long>(z) * n + i];
    out[i] = s;
  }
}

// Launches split_sum_kernel over n elements when there is more than one
// split; returns cudaGetLastError() as an int.
inline int launch_split_sum(const float* ws, float* out, int n, int splits,
                            cudaStream_t stream) {
  if (splits > 1) {
    const int wanted = (n + 255) / 256;
    const int blocks = wanted < 4096 ? wanted : 4096;
    split_sum_kernel<<<blocks, 256, 0, stream>>>(ws, out, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
