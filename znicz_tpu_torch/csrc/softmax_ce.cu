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
// bounds.  The loss is the reference's -sum(logp * onehot): where a column
// other than the label's has a shifted logit that is not finite (a -inf or
// NaN logit), its logp * 0 is NaN and so is the loss, as in the plain
// version; the kernel flags such a column in the sum's reduction.
//
// Bound on an H100: bytes.  The function must read N*C*4 + N*4 bytes and
// write 2*N*C*4 + N*4, against ~6 flops per element, far below the card's
// ~20 flop/byte float32 balance; at 3.35 TB/s the MNIST step (100, 10)
// needs 3.8 ns, AlexNet's (128, 1000) 0.46 us and (1024, 1000) 3.7 us.  The
// design is softmax.cu's (softmax_row.cuh): each element read once into
// registers, e = exp(x - m) kept there for the write, expf once an
// element; narrow rows (C <= 32) G lanes a row in small blocks, register
// rows one block a row in 16-byte vectors, streaming rows (wider than the
// plan's register limit) one block a row in three passes.  The thread
// that holds column `label` writes the loss from m and log(sum).
//
// expf/logf and the division are the accurate versions (no
// --use_fast_math): the card agrees with the plain PyTorch version to rtol
// 1e-5 / atol 1e-6 on probs and err.

#include <climits>

#include "softmax_row.cuh"

namespace {

using namespace softmax_row;

using CeFn = void (*)(const float*, const int*, float*, float*, float*, int,
                      int);

// The loss of a row: NaN where a column other than the label's has a
// shifted logit that is not finite, else -(sh[label] - log s), 0 for a
// label outside [0, C).
__device__ __forceinline__ float row_loss(bool bad, bool in_range,
                                          float sh_label, float s) {
  if (bad) return CUDART_NAN_F;
  return in_range ? -(sh_label - logf(s)) : 0.0f;
}

// The narrow (G > 0) and register (G == 0) forms: each team member holds K
// vectors of V floats of its row in registers.
template <int G, int V, int K>
__global__ void __launch_bounds__(1024)
    softmax_ce_kernel(const float* __restrict__ logits,
                      const int* __restrict__ labels,
                      float* __restrict__ probs, float* __restrict__ loss,
                      float* __restrict__ err, int n, int c) {
  __shared__ float s_max[kMaxWarps], s_sum[kMaxWarps];
  __shared__ int s_bad[kMaxWarps];
  const int rank = team_rank<G>();
  const int size = team_size<G>();
  const long long row = team_row<G>();
  // a dead group of the last block keeps to the shuffles with no row
  const bool live = row < n;
  const float* xr = logits + row * c;
  const int label = live ? labels[row] : -1;

  float v[K][V];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (k * size + rank) * V;
    if (live && j < c) {
      load_vec<V>(xr + j, v[k]);
#pragma unroll
      for (int u = 0; u < V; ++u) m = fmaxf(m, v[k][u]);
    }
  }
  m = team_max<G>(m, s_max);

  float s = 0.0f, sh_label = 0.0f;
  bool bad = false, mine = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (k * size + rank) * V;
    if (live && j < c) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float sh = v[k][u] - m;
        if (j + u == label) {
          sh_label = sh;
          mine = true;
        } else {
          bad = bad || !isfinite(sh);
        }
        v[k][u] = expf(sh);
        s += v[k][u];
      }
    }
  }
  s = team_sum_any<G>(s, bad, s_sum, s_bad);

  float* pr = probs + row * c;
  float* er = err + row * c;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (k * size + rank) * V;
    if (live && j < c) {
      float e[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        v[k][u] = v[k][u] / s;
        e[u] = v[k][u] - (j + u == label ? 1.0f : 0.0f);
      }
      store_vec<V>(pr + j, v[k]);
      store_vec<V>(er + j, e);
    }
  }
  const bool in_range = label >= 0 && label < c;
  if (live && (mine || (!in_range && rank == 0)))
    loss[row] = row_loss(bad, in_range, sh_label, s);
}

// The streaming form: one block a row, three passes over it.
template <int V>
__global__ void __launch_bounds__(1024)
    softmax_ce_stream_kernel(const float* __restrict__ logits,
                             const int* __restrict__ labels,
                             float* __restrict__ probs,
                             float* __restrict__ loss,
                             float* __restrict__ err, int n, int c) {
  __shared__ float s_max[kMaxWarps], s_sum[kMaxWarps];
  __shared__ int s_bad[kMaxWarps];
  const long long row = blockIdx.x;
  const float* xr = logits + row * c;
  const int label = labels[row];
  const long long step = static_cast<long long>(blockDim.x) * V;
  const long long first = static_cast<long long>(threadIdx.x) * V;

  float m = -CUDART_INF_F;
  for (long long j = first; j < c; j += step) {
    float v[V];
    load_vec<V>(xr + j, v);
#pragma unroll
    for (int u = 0; u < V; ++u) m = fmaxf(m, v[u]);
  }
  m = team_max<0>(m, s_max);

  float s = 0.0f, sh_label = 0.0f;
  bool bad = false, mine = false;
  for (long long j = first; j < c; j += step) {
    float v[V];
    load_vec<V>(xr + j, v);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float sh = v[u] - m;
      if (j + u == label) {
        sh_label = sh;
        mine = true;
      } else {
        bad = bad || !isfinite(sh);
      }
      s += expf(sh);
    }
  }
  s = team_sum_any<0>(s, bad, s_sum, s_bad);

  float* pr = probs + row * c;
  float* er = err + row * c;
  for (long long j = first; j < c; j += step) {
    float v[V], e[V];
    load_vec<V>(xr + j, v);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      v[u] = expf(v[u] - m) / s;
      e[u] = v[u] - (j + u == label ? 1.0f : 0.0f);
    }
    store_vec<V>(pr + j, v);
    store_vec<V>(er + j, e);
  }
  const bool in_range = label >= 0 && label < c;
  if (mine || (!in_range && threadIdx.x == 0))
    loss[row] = row_loss(bad, in_range, sh_label, s);
}

template <int G, int V, int K>
struct CeKernel {
  static CeFn get() { return softmax_ce_kernel<G, V, K>; }
};

template <int V>
struct CeStream {
  static CeFn get() { return softmax_ce_stream_kernel<V>; }
};

}  // namespace

// n > 0 rows of c > 0 contiguous float32 logits and n int32 labels under
// the plan of ops/softmax.py softmax_plan (form, threads a block, lanes a
// row, vector width, vectors a lane or thread).  Launches on `stream` and
// does not synchronise; returns the launch status (cudaGetLastError) as an
// int, 0 on success, or cudaErrorInvalidValue for a plan the kernels do not
// take (vectors where C % 4 != 0 or a base is unaligned among them).
extern "C" int znicz_softmax_ce_f32(const float* logits, const int* labels,
                                    float* probs, float* loss, float* err,
                                    int n, int c, int form, int threads,
                                    int group, int vec, int per,
                                    void* stream) {
  const bool aligned =
      aligned16(logits) && aligned16(probs) && aligned16(err);
  const long long blocks =
      plan_blocks(n, c, form, threads, group, vec, per, aligned);
  const CeFn fn = pick_kernel<CeFn, CeKernel, CeStream>(form, group, vec, per);
  if (blocks <= 0 || blocks > INT_MAX || fn == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  fn<<<static_cast<unsigned>(blocks), threads, 0,
       static_cast<cudaStream_t>(stream)>>>(logits, labels, probs, loss, err,
                                            n, c);
  return static_cast<int>(cudaGetLastError());
}
