// Fused SGD + momentum + L1/L2 decay update of one parameter tensor, for
// the unit graph's gradient-descent units.
//
// Replaces the TPU kernel znicz_tpu/ops/update.py pallas_sgd_update
// (_update_kernel).  Per element, in the reference's order of operations:
//   reg = wd * ((1 - l1) * w + (0.5 * l1) * sign(w))
//   v'  = mom * v - lr * (g + reg)
//   w'  = w + v'
// with sign(±0) = 0.  The four hypers arrive by value, already rounded to
// float32 on the host, so a schedule change rebuilds nothing and no host
// tensor is copied (a later CUDA graph can capture the launch); 1 - l1 and
// 0.5 * l1 are formed in float32 as the reference forms them from its f32
// hypers array.
//
// Rounding: every operation is the correctly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts into a
// fused multiply-add, so the kernel equals the plain PyTorch version (one
// rounding per operation) bit for bit.
//
// In place: w_out may equal w and v_out may equal v (each element is read
// before it is written, by the same thread), so the pointers carry no
// __restrict__.  The PyTorch wrapper allocates fresh outputs.
//
// Bound on an H100: bytes.  Three float32 reads and two writes an element
// (20 bytes) against ~10 flops, far below the card's float32 balance:
// 0.47 µs at (784, 100), 0.225 ms at (9216, 4096) over 3.35 TB/s.  The
// design is a grid-stride loop with neighbouring threads on neighbouring
// elements, so every access is coalesced; the unit graph's MNIST sizes
// (100 to 78,400 elements) are launch-bound.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks a streaming multiprocessor

__global__ void __launch_bounds__(kThreads)
sgd_update_kernel(const float* w, const float* g, const float* v,
                  float* w_out, float* v_out, long long n, float lr,
                  float wd, float l1, float mom) {
  const float one_minus_l1 = __fsub_rn(1.0f, l1);
  const float half_l1 = __fmul_rn(0.5f, l1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float wi = w[i];
    const float s = wi > 0.0f ? 1.0f : (wi < 0.0f ? -1.0f : 0.0f);
    const float reg = __fmul_rn(
        wd, __fadd_rn(__fmul_rn(one_minus_l1, wi), __fmul_rn(half_l1, s)));
    const float vn = __fsub_rn(__fmul_rn(mom, v[i]),
                               __fmul_rn(lr, __fadd_rn(g[i], reg)));
    v_out[i] = vn;
    w_out[i] = __fadd_rn(wi, vn);
  }
}

}  // namespace

// n > 0 elements of contiguous float32 w, g, v → w_out, v_out.  Launches on
// `stream`, does not synchronise; returns cudaGetLastError() as an int.
extern "C" int znicz_sgd_update_f32(const float* w, const float* g,
                                    const float* v, float* w_out,
                                    float* v_out, long long n, float lr,
                                    float wd, float l1, float mom,
                                    void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sgd_update_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      w, g, v, w_out, v_out, n, lr, wd, l1, mom);
  return static_cast<int>(cudaGetLastError());
}
