// Fused SOM winner search: for each sample b of x (B, F) and every neuron
// n of the codebook w (N, F),
//   d[b, n] = (|x_b|^2 - 2 * x_b . w_n) + |w_n|^2,
// keeping a running (min, argmin) per sample; the (B, N) matrix is never
// written.  Outputs: win int32 (B,), dmin float32 (B,).
//
// Both forms replace the TPU kernel znicz_tpu/ops/kohonen.py
// pallas_distance_argmin (_dist_argmin_kernel).  Ties keep the lowest
// neuron index, as the reference's (jnp.argmin takes the first index in a
// tile, and tiles merge with a strict <): a thread walks its neurons in
// ascending order with a strict <, and every merge across lanes, warps
// and blocks keeps the smaller value, or the smaller index where the
// values are equal.  Products are float32 FFMA: the reference pins full
// float32 products (Precision.HIGHEST) so that near-tie winners do not
// flip, which rules out TF32 and so the tensor cores; 3xTF32 would triple
// the operations of a kernel that is already bound by them at MNIST
// widths and still not give float32's rounding.
//
// The launch is chosen in Python (ops/kohonen.py dist_argmin_plan) and
// passed as a DistLaunch; the entry point refuses a plan it does not take.
//
// Small form (dist_argmin_small_kernel), for codebooks whose N*F floats,
// their squares and the block's rows fit in 48 KB (the SOM sample's 8x8
// sheet of 2-D points is 512 bytes).  A block stages the codebook once (by
// 4-byte cp.async, all in flight at once) and sums |w|^2 once for all its
// rows; each row goes to a group of G lanes (a power of two up to 32),
// which walk the neurons G apart, F features a neuron (not a padded
// chunk), and reduce with shuffles.  At (100, 64, 2) the work is ~13k
// multiply-adds: the launch is the bound.
//
// Large form (dist_argmin_large_kernel<V>), for MNIST-width codebooks.
// A block takes BM rows and a range of neuron tiles of BN (one tile as
// planned) and walks its tiles' F axis in steps of two 32-feature chunks,
// staged in a ring of four steps, three in flight while one is multiplied
// (one barrier a step).  V = 4 (F % 4 == 0, both bases 16-byte aligned):
// the tensor memory accelerator copies each chunk as two boxes (BM rows of
// x, BN of w) described by tensor maps, with zeros past the operands'
// edges, completing on the slot's mbarrier; V = 1: every thread's 4-byte
// cp.async, zero-filled.  Either way a staged row is 128 bytes whose
// 16-byte pieces are swizzled (the accelerator's 128-byte mode), so eight
// rows read at one feature hit eight bank groups.  Each thread holds a
// register tile of 4 rows x 4 neurons and reads its operands as float4s
// along the features: 8 shared loads for 64 multiply-adds (1/8 of a load
// each).  8 x 4 tiles (kohonen_probe's tm8 build) were 2-3% faster at the
// planned launches of the MNIST-width sheets on an H100, and up to 26%
// slower at others (PERF.md).  Where the rows and neurons of a
// tile leave threads over, the block's KS groups of threads split each
// chunk's features and their partial sums are added in group order in
// shared memory.  |x|^2 (on the block's first tile) and |w|^2 are summed
// from the staged chunks in the same pass, in four partial sums a row
// added in order.  The neuron axis is split across the S blocks of a row
// tile: each leaves its rows' (min, index) in a scratch and takes a
// ticket, and the last to arrive merges them in ascending split (=
// ascending neurons), writes win and dmin and resets its ticket: one
// launch, and a CUDA graph can capture it.  (A thread-block cluster merged
// through distributed shared memory was as fast at up to four blocks, 25%
// slower at eight, and caps the split at eight blocks; kohonen_probe keeps
// it as a variant.)
//
// Bound on an H100 (67 TFLOP/s float32 FFMA, 3.35 TB/s): 2*B*N*F float
// operations against (B + N) * F * 4 bytes: at (256, 400, 784) 160.6
// MFLOP, 2.40 us; at a 32x32 sheet (256, 1024, 784) 411 MFLOP, 6.14 us;
// both above the bytes (0.61 and 1.20 us).  At B = 256 a card's worth
// of blocks leaves each 16-32 rows, so a block stages (BM + BN) * F
// floats for BM * BN * F multiply-adds, and its per-step loop (a barrier,
// the squares, the register tile's FFMAs) runs well below the FFMA rate:
// the large form reaches 12-22% of the bound (PERF.md).
//
// Rounding: the cross term is summed in another order than the plain
// version's cuBLAS product, so dmin agrees within a tolerance and a winner
// can differ only where the plain version's two smallest distances lie
// within that rounding.  Inputs are taken as finite.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
// the small form's shared memory at most (the default limit)
constexpr int kSmallSmem = 48 * 1024;
// -- the large form's fixed sizes
constexpr int kChunk = 32;           // features a staged row: 128 bytes,
                                     // its 16-byte pieces swizzled
constexpr int kVecs = kChunk / 4;    // float4s a staged row
constexpr int kAlign = 1024;         // a swizzled stage's alignment
constexpr int kTm = 4;               // rows a thread holds
constexpr int kTn = 4;               // neurons a thread holds
constexpr int kParts = 4;            // partial square sums a staged row
constexpr int kPartLen = kChunk / kParts;
constexpr int kMaxSplits = 32;       // blocks a row tile at most
constexpr int kSub = 2;              // chunks a step (64 features)
constexpr int kStages = 4;           // steps in the ring: three in flight
static_assert(kPartLen == 8, "a part is two float4s");

// (v, i) <- (ov, oi) when ov is smaller, or equal with a smaller index
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// ascending n within a thread: a strict <, so a tie keeps the earlier one
__device__ __forceinline__ void consider(float& best, int& best_i, float d,
                                         int n) {
  if (d < best) {
    best = d;
    best_i = n;
  }
}

// component u of a float4 (u a constant once unrolled)
__device__ __forceinline__ float elem(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float distance(float x2, float acc, float w2) {
  // 2 * acc is exact; two rounded steps, never contracted
  return __fadd_rn(__fsub_rn(x2, 2.0f * acc), w2);
}

// (min, lowest index) over `width` neighbouring lanes (a power of two that
// divides 32); every lane of the warp takes part
__device__ __forceinline__ void lanes_best(float& v, int& i, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    take_better(v, i, ov, oi);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst (shared) = kVec floats at src, or zeros where !valid (src is then
// not read; it must still point into the operand)
template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// -- small form ---------------------------------------------------------------
__global__ void __launch_bounds__(kMaxThreads)
dist_argmin_small_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, int* __restrict__ win,
                         float* __restrict__ dmin, int B, int N, int F,
                         int group) {
  extern __shared__ __align__(16) float smem[];
  const int T = static_cast<int>(blockDim.x);
  const int t = static_cast<int>(threadIdx.x);
  const int rows = T / group;
  const int row0 = static_cast<int>(blockIdx.x) * rows;
  const int nrows = min(rows, B - row0);
  float* ws = smem;        // [N][F]
  float* w2s = ws + N * F;  // [N]
  float* xs = w2s + N;      // [rows][F]
  const int nf = N * F;
  for (int e = t; e < nf; e += T) cp_async<1>(ws + e, w + e, true);
  const float* xb = x + row0 * F;
  for (int e = t; e < nrows * F; e += T) cp_async<1>(xs + e, xb + e, true);
  cp_async_commit();  // every copy in flight at once, one wait
  cp_async_wait<0>();
  __syncthreads();
  for (int n = t; n < N; n += T) {  // |w|^2 once a block
    const float* wn = ws + n * F;
    float s = 0.0f;
    for (int f = 0; f < F; ++f) s = fmaf(wn[f], wn[f], s);
    w2s[n] = s;
  }
  __syncthreads();
  const int r = t / group;
  const int lane = t - r * group;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = INT_MAX;
  if (r < nrows) {
    const float* xr = xs + r * F;
    float x2 = 0.0f;
    for (int f = 0; f < F; ++f) x2 = fmaf(xr[f], xr[f], x2);
    const int step = group * F;
    int n = lane;
    for (; n + 3 * group < N; n += 4 * group) {  // four neurons in flight
      const float* w0 = ws + n * F;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int f = 0; f < F; ++f) {
        const float xv = xr[f];
        a0 = fmaf(xv, w0[f], a0);
        a1 = fmaf(xv, w0[step + f], a1);
        a2 = fmaf(xv, w0[2 * step + f], a2);
        a3 = fmaf(xv, w0[3 * step + f], a3);
      }
      consider(best, best_i, distance(x2, a0, w2s[n]), n);
      consider(best, best_i, distance(x2, a1, w2s[n + group]), n + group);
      consider(best, best_i, distance(x2, a2, w2s[n + 2 * group]),
               n + 2 * group);
      consider(best, best_i, distance(x2, a3, w2s[n + 3 * group]),
               n + 3 * group);
    }
    for (; n < N; n += group) {
      const float* wn = ws + n * F;
      float a = 0.0f;
      for (int f = 0; f < F; ++f) a = fmaf(xr[f], wn[f], a);
      consider(best, best_i, distance(x2, a, w2s[n]), n);
    }
  }
  lanes_best(best, best_i, group);  // a row's lanes share a warp
  if (lane == 0 && r < nrows) {
    win[row0 + r] = best_i;
    dmin[row0 + r] = best;
  }
}

// -- large form ---------------------------------------------------------------
// Float k of staged row r: rows of 32 floats whose 16-byte pieces are
// swizzled as the tensor memory accelerator's 128-byte mode lays them
// (piece c of row r at piece c ^ (r % 8) of a 1024-byte-aligned stage), so
// that eight rows read at one feature hit eight different bank groups.
__device__ __forceinline__ int swz(int r, int k) {
  return r * kChunk + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}

// V = 1: stage `count` rows (of `total`, from `first`) of a row-major
// (., F) operand, features [f0, f0 + kChunk), into swizzled rows by 4-byte
// cp.async; zeros past the rows and the features.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int first, int count, int total,
                                           int F, int f0, int t, int T) {
  for (int e = t; e < count * kChunk; e += T) {
    const int r = e / kChunk;
    const int k = e - r * kChunk;
    const int row = first + r;
    const bool ok = row < total && f0 + k < F;
    cp_async<1>(dst + swz(r, k), ok ? src + row * F + f0 + k : src, ok);
  }
}

// -- V = 4: the tensor memory accelerator and its barriers
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the barrier's phase completes once `bytes` more have landed
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// the box of `map` at (feature f0, row r0) into dst (its zeros past the
// operand's edges included), counted on bar
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int f0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(f0), "r"(r0),
      "r"(smem_u32(bar))
      : "memory");
}

// Each row's (min, index) over the S blocks of its row tile: every block
// leaves its rows' in the scratch and takes a ticket; the last to arrive
// merges them in ascending split (ascending neurons), writes win and dmin,
// and resets the ticket for the next launch.
__device__ __forceinline__ void merge_splits(
    const float* bestv, const int* besti, int BM, int row0, int B, int S,
    float* __restrict__ sv, int* __restrict__ si,
    unsigned* __restrict__ tickets, int* __restrict__ win,
    float* __restrict__ dmin) {
  __shared__ int last;
  const int t = static_cast<int>(threadIdx.x);
  const int T = static_cast<int>(blockDim.x);
  const int tile = static_cast<int>(blockIdx.x) / S;
  const int q = static_cast<int>(blockIdx.x) - tile * S;
  __syncthreads();  // every row's best is in shared memory
  if (S == 1) {
    for (int r = t; r < BM && row0 + r < B; r += T) {
      win[row0 + r] = besti[r];
      dmin[row0 + r] = bestv[r];
    }
    return;
  }
  float* v = sv + tile * S * BM;
  int* ix = si + tile * S * BM;
  for (int r = t; r < BM; r += T) {
    v[q * BM + r] = bestv[r];
    ix[q * BM + r] = besti[r];
  }
  __threadfence();  // the rows are visible before the ticket is taken
  __syncthreads();
  if (t == 0) last = atomicAdd(tickets + tile, 1u) == unsigned(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = t; r < BM && row0 + r < B; r += T) {
    float bv = __ldcg(v + r);
    int bi = __ldcg(ix + r);
    for (int k = 1; k < S; ++k)
      take_better(bv, bi, __ldcg(v + k * BM + r), __ldcg(ix + k * BM + r));
    win[row0 + r] = bi;
    dmin[row0 + r] = bv;
  }
  if (t == 0) tickets[tile] = 0u;
}

// Floats of the large form's shared memory (the layout below; 1024 bytes
// of slack align the stages, the ring's barriers close it).
__host__ __device__ constexpr int large_smem_floats(int BM, int BN, int KS) {
  return kAlign / 4 + kStages * kSub * (BM + BN) * kChunk + KS * BM * BN +
         (BM + BN) * kParts + BN + 3 * BM + 2 * kStages;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
dist_argmin_large_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, int* __restrict__ win,
                         float* __restrict__ dmin, float* __restrict__ sv,
                         int* __restrict__ si, unsigned* __restrict__ tickets,
                         const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw, int B,
                         int N, int F, int BM, int BN, int KS, int S,
                         int tiles) {
  extern __shared__ __align__(16) float smem_raw[];
  const int T = static_cast<int>(blockDim.x);
  const int t = static_cast<int>(threadIdx.x);
  const int CT = BN / kTn;  // threads across a tile's neurons
  const int RT = BM / kTm;  // threads across the rows
  const int ct = t % CT;
  const int rt = (t / CT) % RT;
  const int g = t / (CT * RT);  // feature group
  float* xs =
      smem_raw + (kAlign - smem_u32(smem_raw) % kAlign) % kAlign / 4;
  // [kStages][kSub][BM][kChunk], then [kStages][kSub][BN][kChunk]: each
  // chunk 1024-byte aligned while BM and BN are multiples of 8
  float* ws = xs + kStages * kSub * BM * kChunk;
  float* part = ws + kStages * kSub * BN * kChunk;  // [KS][BM][BN]
  float* sq = part + KS * BM * BN;       // [BM + BN][kParts]
  float* w2s = sq + (BM + BN) * kParts;  // [BN]
  float* x2s = w2s + BN;                 // [BM]
  float* bestv = x2s + BM;               // [BM]
  int* besti = reinterpret_cast<int*>(bestv + BM);  // [BM]
  uint64_t* bars = reinterpret_cast<uint64_t*>(  // [kStages], 8-aligned
      (reinterpret_cast<uintptr_t>(besti + BM) + 7) & ~uintptr_t{7});

  const int split = static_cast<int>(blockIdx.x) % S;
  const int row0 = (static_cast<int>(blockIdx.x) / S) * BM;
  const int tile0 = split * tiles / S;
  const int tile1 = (split + 1) * tiles / S;
  const int chunks = (F + kSub * kChunk - 1) / (kSub * kChunk);  // a tile
  const int steps = (tile1 - tile0) * chunks;
  const int per = kSub * kVecs / KS;  // float4 steps of a group a step
  const int slots = T / BM;    // threads of a row in the epilogue
  const int er = t / slots;    // its row
  const int es = t - er * slots;
  const int nsq = (BM + BN) * kParts;

  for (int e = t; e < nsq; e += T) sq[e] = 0.0f;
  float acc[kTm][kTn];
#pragma unroll
  for (int i = 0; i < kTm; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) acc[i][j] = 0.0f;
  float x2 = 0.0f;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = INT_MAX;

  // step s: the kSub chunks from feature (s % chunks) * 64 of tile tile0 +
  // s / chunks, into its slot; V = 4: two boxes a chunk from the tensor
  // maps, sent by thread 0 and waited on through the slot's barrier; V =
  // 1: 4-byte copies from every thread
  auto stage = [&](int s) {
    const int tile = tile0 + s / chunks;
    const int buf = s % kStages;
    if constexpr (V == 4)
      mbar_expect(bars + buf, kSub * (BM + BN) * kChunk * 4);
    for (int u = 0; u < kSub; ++u) {
      const int f0 = ((s % chunks) * kSub + u) * kChunk;
      float* xd = xs + (buf * kSub + u) * BM * kChunk;
      float* wd = ws + (buf * kSub + u) * BN * kChunk;
      if constexpr (V == 4) {
        tma_load(xd, &tmx, f0, row0, bars + buf);
        tma_load(wd, &tmw, f0, tile * BN, bars + buf);
      } else {
        stage_rows(xd, x, row0, BM, B, F, f0, t, T);
        stage_rows(wd, w, tile * BN, BN, N, F, f0, t, T);
      }
    }
  };

  if constexpr (V == 4) {
    if (t == 0) {
      for (int b = 0; b < kStages; ++b) mbar_init(bars + b);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps && (V == 1 || t == 0)) stage(s);
    if constexpr (V == 1) cp_async_commit();  // a group each, maybe empty
  }
  int c = 0;  // chunk of step s within its tile
  int tile = tile0;
  for (int s = 0; s < steps; ++s) {
    if constexpr (V == 4) {
      mbar_wait(bars + s % kStages, (s / kStages) & 1);  // step s landed
    } else {
      cp_async_wait<kStages - 2>();
    }
    __syncthreads();  // and every thread is done with step s - 1
    if (s + kStages - 1 < steps && (V == 1 || t == 0))
      stage(s + kStages - 1);  // into step s - 1's slot
    if constexpr (V == 1) cp_async_commit();
    const float* xb = xs + (s % kStages) * kSub * BM * kChunk;
    const float* wb = ws + (s % kStages) * kSub * BN * kChunk;
    // squares: |w|^2 of the tile's neurons, |x|^2 on the block's first
    // tile; w's rows follow x's (BM a multiple of 8 keeps their swizzle)
    for (int e = t; e < nsq; e += T) {
      const int row = e / kParts;
      if (row < BM && tile != tile0) continue;
      const int k = (e - row * kParts) * kPartLen;
      float v = sq[e];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const float* p =
            row < BM ? xb + u * BM * kChunk : wb + (u * BN - BM) * kChunk;
        const float4 a = *reinterpret_cast<const float4*>(p + swz(row, k));
        const float4 b =
            *reinterpret_cast<const float4*>(p + swz(row, k + 4));
        v = fmaf(a.x, a.x, v);
        v = fmaf(a.y, a.y, v);
        v = fmaf(a.z, a.z, v);
        v = fmaf(a.w, a.w, v);
        v = fmaf(b.x, b.x, v);
        v = fmaf(b.y, b.y, v);
        v = fmaf(b.z, b.z, v);
        v = fmaf(b.w, b.w, v);
      }
      sq[e] = v;
    }
    // the register tile: rows rt*kTm + i, neurons ct + CT*j (CT a multiple
    // of 8, so every neuron of a thread has the swizzle of ct)
    for (int q = 0; q < per; ++q) {
      const int ch = (g * per + q) / kVecs;  // its chunk of the step
      const int k4 = (g * per + q) % kVecs;
      const float* xr = xb + (ch * BM + rt * kTm) * kChunk;
      const float* wr = wb + (ch * BN + ct) * kChunk;
      float4 xv[kTm], wv[kTn];
#pragma unroll
      for (int i = 0; i < kTm; ++i)
        xv[i] = *reinterpret_cast<const float4*>(
            xr + i * kChunk + ((k4 ^ ((rt * kTm + i) & 7)) << 2));
#pragma unroll
      for (int j = 0; j < kTn; ++j)
        wv[j] = *reinterpret_cast<const float4*>(
            wr + j * CT * kChunk + ((k4 ^ (ct & 7)) << 2));
#pragma unroll
      for (int u = 0; u < 4; ++u)  // features in order
#pragma unroll
        for (int i = 0; i < kTm; ++i)
#pragma unroll
          for (int j = 0; j < kTn; ++j)
            acc[i][j] = fmaf(elem(xv[i], u), elem(wv[j], u), acc[i][j]);
    }
    if (++c < chunks) continue;
    // the tile is done: the groups' partial sums and the squares
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTm; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        part[(g * BM + rt * kTm + i) * BN + ct + CT * j] = acc[i][j];
        acc[i][j] = 0.0f;
      }
    for (int n = t; n < BN; n += T) {
      float* p = sq + (BM + n) * kParts;
      w2s[n] = ((p[0] + p[1]) + p[2]) + p[3];
      p[0] = p[1] = p[2] = p[3] = 0.0f;
    }
    if (tile == tile0) {
      for (int r = t; r < BM; r += T) {
        const float* p = sq + r * kParts;
        x2s[r] = ((p[0] + p[1]) + p[2]) + p[3];
      }
    }
    __syncthreads();
    if (tile == tile0) x2 = x2s[er];
    const float* pr = part + er * BN;
    for (int nl = es; nl < BN; nl += slots) {  // ascending neurons
      const int n = tile * BN + nl;
      float a = pr[nl];
      for (int h = 1; h < KS; ++h) a += pr[h * BM * BN + nl];
      if (n < N) consider(best, best_i, distance(x2, a, w2s[nl]), n);
    }
    c = 0;
    ++tile;
  }
  lanes_best(best, best_i, slots);  // a row's slots share a warp
  if (es == 0) {
    bestv[er] = best;
    besti[er] = best_i;
  }
  merge_splits(bestv, besti, BM, row0, B, S, sv, si, tickets, win, dmin);
}

// cuTensorMapEncodeTiled from the driver, looked up once
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const auto fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major (rows, F) float32 operand, boxes of 32
// features x `box` rows, swizzled 128-byte rows, zeros past its edges.
bool encode_rows(CUtensorMap* map, const float* base, int rows, int F,
                 int box) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(F) * 4};
  const cuuint32_t boxes[2] = {kChunk, static_cast<cuuint32_t>(box)};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(base), dims, strides, boxes, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int V>
int launch_large(const float* x, const float* w, int* win, float* dmin,
                 float* sv, int* si, unsigned* tickets, int B, int N, int F,
                 int threads, int BM, int BN, int KS, int S, int tiles,
                 int blocks, int smem, cudaStream_t stream) {
  auto kernel = dist_argmin_large_kernel<V>;
  CUtensorMap tmx = {}, tmw = {};
  if (V == 4 && !(encode_rows(&tmx, x, B, F, BM) &&
                  encode_rows(&tmw, w, N, F, BN)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, stream>>>(x, w, win, dmin, sv, si, tickets,
                                            tmx, tmw, B, N, F, BM, BN, KS,
                                            S, tiles);
  return static_cast<int>(cudaGetLastError());
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// A launch of ops/kohonen.py's DistPlan over B rows, N neurons and F
// features (its ctypes mirror is ops/kohonen.py _Launch): form (0 small, 1
// large), threads, group (small: lanes a row), rows a block, tile_n (large:
// neurons a tile, 32 or 64), ksplit (large: feature groups, 1 2 4 or 8),
// splits (large: blocks of a row tile, at most 32 and at most the tiles),
// vec (4: the tensor maps, only where F % 4 == 0 and both bases are
// 16-byte aligned), blocks and dynamic shared bytes.
struct DistLaunch {
  int B, N, F;
  int form, threads, group, rows, tile_n, ksplit, splits, vec, blocks, smem;
};

// B > 0 rows, N > 0 neurons, F > 0 features, contiguous float32 x (B, F)
// and w (N, F), B*F and N*F below 2^31, and the launch `p`, each field
// checked against what the plan implies.  Where the plan splits the
// neurons, `scratch` holds 2 * blocks * rows ints (each block's rows'
// values, then indices) and `tickets` one zeroed counter a row tile, left
// zeroed; launches that overlap must not share them.  Launches on
// `stream`, does not synchronise; returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for a plan it does not take).
extern "C" int znicz_distance_argmin_f32(const float* x, const float* w,
                                         int* win, float* dmin, int* scratch,
                                         unsigned* tickets,
                                         const DistLaunch* p, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int B = p->B, N = p->N, F = p->F;
  const int threads = p->threads, group = p->group, rows = p->rows;
  const int tile_n = p->tile_n, ksplit = p->ksplit, splits = p->splits;
  const int vec = p->vec, blocks = p->blocks, smem = p->smem;
  if (B <= 0 || N <= 0 || F <= 0) return bad;
  if (p->form == 0) {
    if (!pow2(threads) || !pow2(group) || group > 32 || threads < 32 ||
        threads > kMaxThreads || threads % group != 0 ||
        rows != threads / group || tile_n != 0 || ksplit != 1 ||
        splits != 1 || vec != 1)
      return bad;
    const long long need =
        (static_cast<long long>(N) * F + N + static_cast<long long>(rows) * F) *
        4;
    if (need != smem || smem > kSmallSmem || blocks != (B + rows - 1) / rows)
      return bad;
    dist_argmin_small_kernel<<<blocks, threads, smem, st>>>(x, w, win, dmin,
                                                            B, N, F, group);
    return static_cast<int>(cudaGetLastError());
  }
  if (p->form != 1 || (tile_n != 32 && tile_n != 64) ||
      (ksplit != 1 && ksplit != 2 && ksplit != 4 && ksplit != 8) ||
      rows < 8 || rows % 8 != 0 || rows % kTm != 0 || group != 0)
    return bad;
  if (threads != rows / kTm * (tile_n / kTn) * ksplit || threads % 32 != 0 ||
      threads > kMaxThreads)
    return bad;
  const int tiles = (N + tile_n - 1) / tile_n;
  if (splits < 1 || splits > kMaxSplits || splits > tiles) return bad;
  if (splits > 1 && (scratch == nullptr || tickets == nullptr)) return bad;
  if (vec == 4) {
    if (F % 4 != 0 || !aligned16(x) || !aligned16(w)) return bad;
  } else if (vec != 1) {
    return bad;
  }
  const long long row_tiles = (B + rows - 1) / rows;
  if (blocks != row_tiles * splits ||
      smem != large_smem_floats(rows, tile_n, ksplit) * 4)
    return bad;
  // the scratch: each block's rows' (min, index), values then indices
  float* sv = reinterpret_cast<float*>(scratch);
  int* si = scratch == nullptr ? nullptr
                               : scratch + row_tiles * splits * rows;
  const auto launch = vec == 4 ? launch_large<4> : launch_large<1>;
  return launch(x, w, win, dmin, sv, si, tickets, B, N, F, threads, rows,
                tile_n, ksplit, splits, tiles, blocks, smem, st);
}

// Registers a thread and local (spilled) bytes a thread of the kernel a
// plan runs: form 0 small, 1 large with vec as in the plan.
extern "C" int znicz_distance_argmin_attrs(int form, int vec, int* regs,
                                           int* local_bytes) {
  cudaFuncAttributes a = {};
  cudaError_t e = cudaErrorInvalidValue;
  if (form == 0) {
    e = cudaFuncGetAttributes(&a, dist_argmin_small_kernel);
  } else if (form == 1) {
    e = vec == 4 ? cudaFuncGetAttributes(&a, dist_argmin_large_kernel<4>)
                 : cudaFuncGetAttributes(&a, dist_argmin_large_kernel<1>);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
