// Fused SGD + momentum + L1/L2 decay update of a list of parameter
// tensors in one launch, for the fused train step and the unit graph's
// gradient-descent units.
//
// Replaces the TPU kernel znicz_tpu/ops/update.py pallas_sgd_update
// (_update_kernel).  Per element, in the reference's order of operations:
//   reg = wd * ((1 - l1) * w + (0.5 * l1) * sign(w))
//   v'  = mom * v - (lr * s) * (g + reg)
//   w'  = w + v'
// with sign(±0) = 0.  Each entry of the table carries its five constants
// lr, wd, 1 - l1, 0.5 * l1 and mom as float32, formed by the caller: the
// unit graph forms 1 - l1 in float32 from float32 hypers (the reference's
// f32 hypers array), the fused step rounds the double 1 - l1 once, and the
// kernel forms nothing, so neither path moves.  s is the learning-rate
// scale of the step (the fused path's LR schedule), a float32 the kernel
// loads from device memory, so a CUDA graph that captured the launch
// follows the schedule; lr * s is rounded to float32 first, as the
// reference's lr * lr_scale * (g + reg) does.  A null pointer means s = 1,
// and at s = 1 the kernel computes what it did before the scale (lr * 1 is
// lr exactly).
//
// Rounding: every operation is the correctly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts into a
// fused multiply-add, so the kernel equals the plain PyTorch version (one
// rounding per operation) bit for bit.
//
// The table goes by value as a __grid_constant__ parameter of at most 4 KB
// (kMaxEntries entries), so nothing rests on CUDA 12.1's larger parameter
// limit, no host-to-device copy is made per call, and a CUDA graph can
// capture the launch.  The C entry point splits a longer list into as many
// launches as it needs.  No entry may read another entry's output of the
// same launch: an update that must read a new w' (the fused step's tied
// deconv) goes in a later call.
//
// Work split: fixed chunks of kChunk elements (256 threads x 1 float4);
// entry i owns the chunks [start[i], start[i+1]) and a block finds its
// entry by a binary search over the starts.  A full chunk of an entry whose
// five pointers are all 16-byte aligned (the entry point's flag) moves in
// 16-byte vectors; the tail chunk and unaligned entries take the scalar
// path.  Each thread issues all of its w, g and v loads before it computes
// (12 KB a block in flight).  A small chunk spreads a small table over
// many SMs (MNIST's 79,510 elements take 80 blocks); at AlexNet's sizes 1,
// 2, 4 or 8 float4s a thread measure within 1% (`update_probe`).
//
// In place: w_out may equal w and v_out may equal v (each element is read
// before it is written, by the same thread), so the pointers carry no
// __restrict__.  The fused step updates its parameters and velocities in
// place; the unit graph's wrapper calls allocate fresh outputs.
//
// Bound on an H100: bytes.  Three float32 reads and two writes an element
// (20 bytes) against ~10 flops, far below the card's float32 balance:
// 0.225 ms at AlexNet fc6 (9216, 4096) and 0.372 ms for AlexNet's 16
// tensors (62,378,344 elements) over 3.35 TB/s.  One launch a list pays
// the card's launch floor once, where one launch a tensor paid it per
// tensor.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 1;                          // float4s a thread, per array
constexpr int kChunk = kThreads * kVecs * 4;      // elements a block
constexpr int kScalar = kChunk / kThreads;        // elements a thread, scalar
constexpr int kMaxEntries = 48;

struct Entry {
  const float* w;
  const float* g;
  const float* v;
  float* w_out;
  float* v_out;
  const float* scale;                             // s; null: s = 1
  long long n;
  float lr, wd, one_minus_l1, half_l1, mom;
  int vec;                                        // 16-byte path allowed
};

struct Table {
  int count;
  int start[kMaxEntries + 1];                     // first chunk of each entry
  Entry e[kMaxEntries];
};
static_assert(sizeof(Table) <= 4096, "the table must fit the 4 KB limit");

__device__ __forceinline__ float4 load4(const float4* p) { return *p; }
__device__ __forceinline__ void store4(float4* p, float4 x) { *p = x; }

// lr is the entry's rate times its step's scale, rounded once
__device__ __forceinline__ void step(const Entry& e, float lr, float w,
                                     float g, float v, float& w_new,
                                     float& v_new) {
  const float s = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  const float reg = __fmul_rn(
      e.wd, __fadd_rn(__fmul_rn(e.one_minus_l1, w), __fmul_rn(e.half_l1, s)));
  v_new = __fsub_rn(__fmul_rn(e.mom, v), __fmul_rn(lr, __fadd_rn(g, reg)));
  w_new = __fadd_rn(w, v_new);
}

__device__ __forceinline__ void step4(const Entry& e, float lr,
                                      const float4& w, const float4& g,
                                      const float4& v, float4& w_new,
                                      float4& v_new) {
  step(e, lr, w.x, g.x, v.x, w_new.x, v_new.x);
  step(e, lr, w.y, g.y, v.y, w_new.y, v_new.y);
  step(e, lr, w.z, g.z, v.z, w_new.z, v_new.z);
  step(e, lr, w.w, g.w, v.w, w_new.w, v_new.w);
}

__global__ void __launch_bounds__(kThreads)
sgd_update_multi_kernel(const __grid_constant__ Table t) {
  const int chunk = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.count - 1;                  // last entry starting <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const Entry& e = t.e[lo];
  const float lr = e.scale != nullptr ? __fmul_rn(e.lr, *e.scale) : e.lr;
  const long long base = static_cast<long long>(chunk - t.start[lo]) * kChunk;
  if (e.vec && base + kChunk <= e.n) {
    const float4* w4 = reinterpret_cast<const float4*>(e.w + base);
    const float4* g4 = reinterpret_cast<const float4*>(e.g + base);
    const float4* v4 = reinterpret_cast<const float4*>(e.v + base);
    float4 w[kVecs], g[kVecs], v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = k * kThreads + static_cast<int>(threadIdx.x);
      w[k] = load4(w4 + i);
      g[k] = load4(g4 + i);
      v[k] = load4(v4 + i);
    }
    float4* wo = reinterpret_cast<float4*>(e.w_out + base);
    float4* vo = reinterpret_cast<float4*>(e.v_out + base);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = k * kThreads + static_cast<int>(threadIdx.x);
      float4 wn, vn;
      step4(e, lr, w[k], g[k], v[k], wn, vn);
      store4(vo + i, vn);
      store4(wo + i, wn);
    }
    return;
  }
  float w[kScalar], g[kScalar], v[kScalar];
#pragma unroll
  for (int k = 0; k < kScalar; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < e.n) {
      w[k] = e.w[i];
      g[k] = e.g[i];
      v[k] = e.v[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kScalar; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < e.n) {
      float wn, vn;
      step(e, lr, w[k], g[k], v[k], wn, vn);
      e.v_out[i] = vn;
      e.w_out[i] = wn;
    }
  }
}

int launch(const Table& t, int chunks, cudaStream_t stream) {
  sgd_update_multi_kernel<<<chunks, kThreads, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Updates `count` entries: entry i has the pointers ptrs[6i .. 6i+5] (w, g,
// v, w_out, v_out: contiguous float32, w_out and v_out either w and v or
// apart from every input; then its scale s, one float32, or null for 1),
// ns[i] elements and the constants consts[5i .. 5i+4] (lr, wd, 1 - l1,
// 0.5 * l1, mom); it takes the 16-byte path where its five tensors are
// 16-byte aligned.  Empty entries are
// skipped; the rest go kMaxEntries to a launch, in order.  Launches on
// `stream`, does not synchronise; *launched gets the number of launches
// made, and the return is cudaGetLastError() as an int
// (cudaErrorInvalidValue for an entry past 2^31 - 1 chunks).
extern "C" int znicz_sgd_update_many_f32(const unsigned long long* ptrs,
                                         const long long* ns,
                                         const float* consts, int count,
                                         int* launched, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr long long kMaxChunks = 0x7fffffffLL;
  Table t;
  t.count = 0;
  long long chunks = 0;
  *launched = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = ns[i];
    if (n <= 0) continue;
    const long long need = (n + kChunk - 1) / kChunk;
    if (need > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
    if (t.count == kMaxEntries || chunks + need > kMaxChunks) {
      t.start[t.count] = static_cast<int>(chunks);
      const int status = launch(t, static_cast<int>(chunks), st);
      if (status != 0) return status;
      ++*launched;
      t.count = 0;
      chunks = 0;
    }
    const unsigned long long* p = ptrs + 6LL * i;
    const float* c = consts + 5LL * i;
    Entry& e = t.e[t.count];
    e.w = reinterpret_cast<const float*>(p[0]);
    e.g = reinterpret_cast<const float*>(p[1]);
    e.v = reinterpret_cast<const float*>(p[2]);
    e.w_out = reinterpret_cast<float*>(p[3]);
    e.v_out = reinterpret_cast<float*>(p[4]);
    e.scale = reinterpret_cast<const float*>(p[5]);
    e.n = n;
    e.lr = c[0];
    e.wd = c[1];
    e.one_minus_l1 = c[2];
    e.half_l1 = c[3];
    e.mom = c[4];
    e.vec = ((p[0] | p[1] | p[2] | p[3] | p[4]) & 15ULL) == 0;
    t.start[t.count] = static_cast<int>(chunks);
    ++t.count;
    chunks += need;
  }
  if (t.count > 0) {
    t.start[t.count] = static_cast<int>(chunks);
    const int status = launch(t, static_cast<int>(chunks), st);
    if (status != 0) return status;
    ++*launched;
  }
  return static_cast<int>(cudaSuccess);
}
