// Fused softmax + cross-entropy + error head for the fused train step.
//
// Replaces the TPU kernel znicz_tpu/ops/softmax.py
// pallas_softmax_ce_from_logits (_softmax_ce_kernel): per row of float32
// logits x (N, C) with an int32 label, it writes
//   probs = exp(x - max) / sum(exp(x - max)),
//   loss  = -((x[label] - max) - log(sum)),
//   err   = probs - onehot(label).
// A label outside [0, C) one-hots to an all-zero row, as the reference's
// iota comparison does: loss = 0 and err = probs.  It is never read out of
// bounds.
//
// Bound on an H100: bytes.  The function must read N*C*4 + N*4 bytes and
// write 2*N*C*4 + N*4, against ~6 flops per element, far below the card's
// ~20 flop/byte float32 balance; at 3.35 TB/s the MNIST step (100, 10)
// needs 3.8 ns and the (1024, 1000) case 3.7 us.  The design keeps every
// row in one warp, so the three passes over a row (max, sum, write) re-read
// it from L1/L2 rather than device memory: each element is fetched from
// HBM once and each output written once, which is the bound's traffic.
// Small rows (C = 10) leave most lanes idle and the launch dominates; that
// is left for a later change.
//
// expf/logf are the accurate versions (no --use_fast_math): the card must
// agree with the plain PyTorch version to 1e-6 absolute on probs and err.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;   // one warp per row, 256 threads a block

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void softmax_ce_kernel(const float* __restrict__ logits,
                                  const int* __restrict__ labels,
                                  float* __restrict__ probs,
                                  float* __restrict__ loss,
                                  float* __restrict__ err, int n, int c) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;   // whole warp leaves together: shuffles stay full
  const float* x = logits + row * c;
  float* y = probs + row * c;
  float* e = err + row * c;

  // pass 1: row max
  float m = -CUDART_INF_F;
  for (int j = lane; j < c; j += kWarp) m = fmaxf(m, x[j]);
  m = warp_max(m);

  // pass 2: sum of exp(x - m)
  float s = 0.0f;
  for (int j = lane; j < c; j += kWarp) s += expf(x[j] - m);
  s = warp_sum(s);

  // pass 3: probs, err and (lane 0) the row's loss
  const int label = labels[row];
  for (int j = lane; j < c; j += kWarp) {
    const float p = expf(x[j] - m) / s;
    y[j] = p;
    e[j] = p - (j == label ? 1.0f : 0.0f);
  }
  if (lane == 0) {
    loss[row] = (label >= 0 && label < c) ? -((x[label] - m) - logf(s))
                                          : 0.0f;
  }
}

}  // namespace

// Launches on `stream` and does not synchronise; returns the launch status
// (cudaGetLastError) as an int, 0 on success.
extern "C" int znicz_softmax_ce_f32(const float* logits, const int* labels,
                                    float* probs, float* loss, float* err,
                                    int n, int c, void* stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  softmax_ce_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      logits, labels, probs, loss, err, n, c);
  return static_cast<int>(cudaGetLastError());
}
