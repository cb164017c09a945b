// Row softmax + argmax for the unit graph's All2AllSoftmax.
//
// Replaces the TPU kernel znicz_tpu/ops/softmax.py pallas_softmax
// (_softmax_kernel): per row of float32 x (N, C) it writes
//   y   = e / sum(e),  e = exp(x - max(x)),
//   idx = argmax(x), the first index of the maximum (jnp.argmax).
// A NaN counts as the largest value, as in torch.argmax and jnp.argmax, so
// a row holding one gives the first NaN's index and NaN probabilities, as
// the plain version does.
//
// expf and the division are the accurate, correctly rounded versions (no
// --use_fast_math, no __expf): y agrees with the plain PyTorch version to
// rtol 1e-6 (the sums are taken in another order), idx exactly.
//
// Bound on an H100: bytes.  N*C*4 read and N*C*4 + N*4 written against ~5
// flops an element: 0.31 us at (128, 1000) over 3.35 TB/s; the unit
// graph's (100, 10) is launch-bound.  The design (softmax_row.cuh) reads
// each element once into registers, keeps e = exp(x - m) there for the
// write, and runs expf once an element; the maximum is reduced as a value
// and the first index of it beside the sum (two reductions, no index
// carried through the maximum's), in one of three forms that
// ops/softmax.py softmax_plan picks:
// - narrow rows (C <= 32): G lanes a row, several rows a warp, small
//   blocks, so that (100, 10) spreads over tens of SMs; the reductions are
//   log2(G) shuffle steps;
// - register rows (C up to the plan's register limit): one block a row,
//   each thread a few 16-byte vectors of it, one block reduction for the
//   maximum and one for the sum and the index;
// - streaming rows (wider): one block a row, three passes over the row
//   (the maximum, the sum, the write), re-read from L2.

#include <climits>

#include "softmax_row.cuh"

namespace {

using namespace softmax_row;

using RowFn = void (*)(const float*, float*, int*, int, int);

// v is the row's maximum m, or a NaN where m is NaN.
__device__ __forceinline__ bool is_max(float v, float m) {
  return v == m || (m != m && v != v);
}

// The narrow (G > 0) and register (G == 0) forms: each team member holds K
// vectors of V floats of its row in registers.
template <int G, int V, int K>
__global__ void __launch_bounds__(1024)
    row_softmax_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int* __restrict__ idx, int n, int c) {
  __shared__ float s_max[kMaxWarps], s_sum[kMaxWarps];
  __shared__ int s_nan[kMaxWarps], s_arg[kMaxWarps];
  const int rank = team_rank<G>();
  const int size = team_size<G>();
  const long long row = team_row<G>();
  // a dead group of the last block keeps to the shuffles with no row
  const bool live = row < n;
  const float* xr = x + row * c;

  float v[K][V];
  float m = -CUDART_INF_F;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (k * size + rank) * V;
    if (live && j < c) {
      load_vec<V>(xr + j, v[k]);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        nan = nan || v[k][u] != v[k][u];
        m = fmaxf(m, v[k][u]);
      }
    }
  }
  m = team_max_nan<G>(m, nan, s_max, s_nan);

  // a member's columns rise with k and u: its first maximum is the first
  float s = 0.0f;
  int arg = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (k * size + rank) * V;
    if (live && j < c) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (arg == INT_MAX && is_max(v[k][u], m)) arg = j + u;
        v[k][u] = expf(v[k][u] - m);
        s += v[k][u];
      }
    }
  }
  s = team_sum_min<G>(s, arg, s_sum, s_arg);

  float* yr = y + row * c;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (k * size + rank) * V;
    if (live && j < c) {
#pragma unroll
      for (int u = 0; u < V; ++u) v[k][u] = v[k][u] / s;
      store_vec<V>(yr + j, v[k]);
    }
  }
  if (live && rank == 0) idx[row] = arg;
}

// The streaming form: one block a row, three passes over it.
template <int V>
__global__ void __launch_bounds__(1024)
    row_softmax_stream_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int* __restrict__ idx,
                              int n, int c) {
  __shared__ float s_max[kMaxWarps], s_sum[kMaxWarps];
  __shared__ int s_nan[kMaxWarps], s_arg[kMaxWarps];
  const long long row = blockIdx.x;
  const float* xr = x + row * c;
  float* yr = y + row * c;
  const long long step = static_cast<long long>(blockDim.x) * V;
  const long long first = static_cast<long long>(threadIdx.x) * V;

  float m = -CUDART_INF_F;
  bool nan = false;
  for (long long j = first; j < c; j += step) {
    float v[V];
    load_vec<V>(xr + j, v);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      nan = nan || v[u] != v[u];
      m = fmaxf(m, v[u]);
    }
  }
  m = team_max_nan<0>(m, nan, s_max, s_nan);

  float s = 0.0f;
  int arg = INT_MAX;
  for (long long j = first; j < c; j += step) {
    float v[V];
    load_vec<V>(xr + j, v);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (arg == INT_MAX && is_max(v[u], m)) arg = static_cast<int>(j) + u;
      s += expf(v[u] - m);
    }
  }
  s = team_sum_min<0>(s, arg, s_sum, s_arg);

  for (long long j = first; j < c; j += step) {
    float v[V];
    load_vec<V>(xr + j, v);
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = expf(v[u] - m) / s;
    store_vec<V>(yr + j, v);
  }
  if (threadIdx.x == 0) idx[row] = arg;
}

template <int G, int V, int K>
struct RowKernel {
  static RowFn get() { return row_softmax_kernel<G, V, K>; }
};

template <int V>
struct RowStream {
  static RowFn get() { return row_softmax_stream_kernel<V>; }
};

}  // namespace

// n > 0 rows of c > 0 contiguous float32 values under the plan of
// ops/softmax.py softmax_plan (form, threads a block, lanes a row, vector
// width, vectors a lane or thread).  Launches on `stream`, does not
// synchronise; returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for a plan the kernels do not take (vectors where
// C % 4 != 0 or a base is unaligned among them).
extern "C" int znicz_row_softmax_f32(const float* x, float* y, int* idx,
                                     int n, int c, int form, int threads,
                                     int group, int vec, int per,
                                     void* stream) {
  const long long blocks = plan_blocks(n, c, form, threads, group, vec, per,
                                       aligned16(x) && aligned16(y));
  const RowFn fn = pick_kernel<RowFn, RowKernel, RowStream>(form, group, vec,
                                                            per);
  if (blocks <= 0 || blocks > INT_MAX || fn == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  fn<<<static_cast<unsigned>(blocks), threads, 0,
       static_cast<cudaStream_t>(stream)>>>(x, y, idx, n, c);
  return static_cast<int>(cudaGetLastError());
}
