// The tensor-core tile loop of the port's float32 products: the conv
// forward, input gradient and weight gradient (csrc/conv_gemm.cu) and the
// unit graph's matmul (csrc/matmul.cu).  C = A.B in float32 accuracy on
// TF32 tensor cores, with the operands' loaders as template parameters.
//
// A block computes a kBM x BN tile of C with eight warps, each a
// (kBM / kWarpsM) x (BN / kWarpsN) sub-tile of mma.sync m16n8k8 TF32
// products.  The depth goes kBK = 32 at a time through a ring of kStages
// shared-memory stages filled by cp.async: while the MMAs of step t run,
// the copies of steps t + 1 and t + 2 are in flight.  A loader issues the
// copies of one stage (16 bytes a copy where its axis allows, 4
// otherwise; an element outside the operand, or a tap outside the image,
// is a copy of 0 bytes, which fills zeros), and the loop commits them as
// one group.
//
// Words used here: a loader's load(s, t0) fills one stage of its operand
// for the depth [t0, t0 + kBK), 0 past the end, in one of four layouts:
//   A, K-major (row-major A, the patch rows of the forward):
//                       s[ii * kRowStride + kk] = A(m0 + ii, t0 + kk);
//   A, M-major (kAMMajor: aT views, the weight gradient's patches, whose
//               rows k = (kh, kw, c) have c innermost in x):
//                       s[kk * kAStrideM + ii] = A(m0 + ii, t0 + kk);
//   B, K-major (kBKMajor: WT views, the input gradient's W', oc innermost):
//                       s[nn * kRowStride + kk] = B(t0 + kk, n0 + nn);
//   B, N-major (row-major B, the forward's HWIO weights as (K, OC), err as
//               (B.OH.OW, OC)):
//                       s[kk * kBStrideN + nn] = B(t0 + kk, n0 + nn).
// The row strides keep the fragment reads free of bank conflicts: a
// K-major row of 36 floats puts lane (g, t) of a warp on bank 4g + t, an
// M- or N-major row of 8 mod 32 (or 24) floats on bank 8t + g; all are
// multiples of 4 floats, so a 16-byte copy lands aligned.  Dense (below)
// loads a strided matrix in any of the four; the conv's gathers are in
// csrc/conv_gemm.cu.
//
// Split depth: split_block reduces the depth chunk [z.chunk, (z + 1).chunk)
// of z = blockIdx.z and stores its tile to C with one split, or to its
// slice of a workspace (splits, rows, cols) with more, which
// split_sum_kernel (csrc/split_sum.cuh) adds in ascending split order.
//
// Arithmetic, 3xTF32: each operand v is split as big = tf32(v) and
// small = tf32(v - big) (cvt.rna: to nearest, ties away from zero; TF32
// keeps 10 of float32's 23 mantissa bits), and every product adds
// a_small.b_big + a_big.b_small + a_big.b_big, small terms first.  The
// dropped a_small.b_small is about 2^-22 of |a||b|, far inside the tier's
// tolerance (rtol 1e-5, atol 1e-5.sqrt(R).max|a|.max|b|); the cost is
// three TF32 products a multiply-add.  The tensor core does not round
// its sums as an IEEE add does: chained over a long reduction into one
// accumulator (three MMAs every 8 of the depth) its error grew with the
// depth.  On an H100 that reached 0.88 of the tier's atol at AlexNet
// conv2's input gradient (R = 6400; python -m
// znicz_tpu_torch.conv_tc_probe, variant no_partials) and 6.5 times the
// atol of tests/test_torch_conv_gemm.py's card case dgrad_n96 (R = 2400).
// So each 8-deep step's three products go into a fresh 4-float partial,
// which an IEEE add puts into the float32 accumulator: 0.08 of the atol
// there, for some 13% more time.  Each output element is one thread's sum
// in a fixed order, and the split slices are added in a fixed order: no
// atomics, so the card repeats a result bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "split_sum.cuh"

namespace {
namespace tc {

constexpr int kBM = 128;          // rows of C a block
constexpr int kBK = 32;           // depth a stage
constexpr int kStages = 3;        // copies of two steps in flight
constexpr int kThreads = 256;     // eight warps
constexpr int kRowStride = kBK + 4;
constexpr int kAStrideM = kBM + 8;

// The geometry of a block's tile of width BN, B stored K-major or not, A
// stored M-major or not.
template <int BN, bool kBKMajor, bool kAMMajorA = false>
struct Tile {
  static_assert(BN % 8 == 0 && BN <= 128, "BN is a multiple of the n8 MMA");
  static constexpr int kBN = BN;
  static constexpr bool kKMajor = kBKMajor;
  static constexpr bool kAMMajor = kAMMajorA;
  static constexpr int kWarpsN = BN >= 64 ? 2 : 1;
  static constexpr int kWarpsM = kThreads / 32 / kWarpsN;
  static constexpr int kWM = kBM / kWarpsM;   // a warp's rows: 32 or 16
  static constexpr int kWN = BN / kWarpsN;    // a warp's columns
  static constexpr int kMT = kWM / 16;        // m16 tiles a warp
  static constexpr int kNT = kWN / 8;         // n8 tiles a warp
  static constexpr int kBStrideN = BN % 32 == 8 ? BN : BN + 8;
  static constexpr int kAFloats = kAMMajorA ? kBK * kAStrideM
                                            : kBM * kRowStride;
  static constexpr int kBFloats = kBKMajor ? BN * kRowStride
                                           : kBK * kBStrideN;
  static constexpr int kStageFloats = kAFloats + kBFloats;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
  // two blocks an SM for the wide tiles: ptxas then keeps 128 registers
  // (a few spilled), 3-6% faster at AlexNet's conv2 and conv4 on an H100
  // than one block (conv_tc_probe, variant one_block)
  static constexpr int kMinBlocks = BN >= 96 ? 2 : 1;
  static_assert(kBStrideN % 32 == 8 || kBStrideN % 32 == 24,
                "N-major fragment reads conflict-free");
  static_assert(kAStrideM % 32 == 8 || kAStrideM % 32 == 24,
                "M-major fragment reads conflict-free");
  static_assert(kAStrideM % 4 == 0 && kBStrideN % 4 == 0,
                "16-byte copies land aligned");
  static_assert(kWM % 16 == 0 && kWN % 8 == 0, "warp tile of whole MMAs");
  // two blocks of the widest tile fit an H100's 227 KB
  static_assert(kMinBlocks == 1 || 2 * kSmemBytes <= 220 * 1024,
                "shared memory for two blocks an SM");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst (shared) = kVec floats at src, or zeros where !valid (src is then
// not read; it must still be a pointer into the operand).
template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  static_assert(kVec == 4 || kVec == 1, "16- or 4-byte copies");
  if (kVec == 4) {
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

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A dense strided operand, op(i, t) = p[i * si + t * st] for i < n and
// t < depth, where i runs over the tile's kRows (C's rows for A, its
// columns for B, from i0) and t is the depth.  kDepthInner: the stage
// holds s[ii * kStride + kk] (A or B K-major), else s[kk * kStride + ii]
// (A M-major, B N-major).  A copy moves kVec neighbours along the stage's
// inner axis, neighbouring threads neighbouring copies; kVec = 4 needs that
// axis of stride 1 and of an extent that is a multiple of 4, the other
// stride a multiple of 4 and p 16-byte aligned (the entry points check
// it); kVec = 1 takes any strides.  Offsets are computed in Index: int
// where the operand has fewer than 2^31 elements (the convs), long long
// for any strided view (the matmul).
template <int kRows, int kStride, bool kDepthInner, int kVec, class Index>
struct Dense {
  const float* p;
  Index si, st;
  int n, depth, i0;

  __device__ __forceinline__ void load(float* s, int t0) const {
    constexpr int kGroups = (kDepthInner ? kBK : kRows) / kVec;
    constexpr int kCopies = (kDepthInner ? kRows : kBK) * kGroups;
#pragma unroll
    for (int l = 0; l < (kCopies + kThreads - 1) / kThreads; ++l) {
      const int idx = static_cast<int>(threadIdx.x) + l * kThreads;
      if (kCopies % kThreads == 0 || idx < kCopies) {
        const int outer = idx / kGroups;
        const int inner = idx % kGroups * kVec;
        const int i = i0 + (kDepthInner ? outer : inner);
        const int t = t0 + (kDepthInner ? inner : outer);
        const bool ok = i < n && t < depth;
        cp_async<kVec>(s + outer * kStride + inner,
                       ok ? p + (static_cast<Index>(i) * si +
                                 static_cast<Index>(t) * st)
                          : p,
                       ok);
      }
    }
  }
};

// The 3xTF32 split, shared by every product on this loop:
// v ~ big + small, each a TF32 value in a float32 register.
// The low 13 bits of big are cleared, so big is the value the MMA reads
// and v - big is exact.
__device__ __forceinline__ void split_tf32(float v, unsigned& big,
                                           unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  big &= 0xffffe000u;
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d += a.b for one m16n8k8 tile (fragments as the PTX ISA lays them out:
// lane (g, t) = (lane / 4, lane % 4) holds A at rows g, g + 8 and depths
// t, t + 4, B at depths t, t + 4 and column g, C at rows g, g + 8 and
// columns 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b for one m16n8k8 tile, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// acc += A(m0.., t) B(t, n0..) over t in [t_begin, t_end); the loaders
// know m0 and n0, and every thread calls their load() (a loader may hold
// a barrier).  smem holds kStages stages of T::kStageFloats floats, A
// first.
template <class T, class LoadA, class LoadB>
__device__ __forceinline__ void mainloop(const LoadA& la, const LoadB& lb,
                                         float* smem, int t_begin, int t_end,
                                         float (&acc)[T::kMT][T::kNT][4]) {
  const int steps = (t_end - t_begin + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      float* st = smem + s * T::kStageFloats;
      la.load(st, t_begin + s * kBK);
      lb.load(st + T::kAFloats, t_begin + s * kBK);
    }
    cp_async_commit();
  }
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm0 = (warp / T::kWarpsN) * T::kWM;
  const int wn0 = (warp % T::kWarpsN) * T::kWN;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();   // this step's stage has landed
    __syncthreads();                // and every warp is done with step - 1
    const int next = step + kStages - 1;
    if (next < steps) {             // refill the stage step - 1 used
      float* st = smem + (next % kStages) * T::kStageFloats;
      la.load(st, t_begin + next * kBK);
      lb.load(st + T::kAFloats, t_begin + next * kBK);
    }
    cp_async_commit();
    const float* as = smem + (step % kStages) * T::kStageFloats;
    const float* bs = as + T::kAFloats;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      unsigned a_big[T::kMT][4], a_small[T::kMT][4];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        float v[4];
        if (T::kAMMajor) {
          const float* p = as + (kk + t) * kAStrideM + wm0 + i * 16 + g;
          v[0] = p[0];
          v[1] = p[8];
          v[2] = p[4 * kAStrideM];
          v[3] = p[4 * kAStrideM + 8];
        } else {
          const float* p = as + (wm0 + i * 16 + g) * kRowStride + kk + t;
          v[0] = p[0];
          v[1] = p[8 * kRowStride];
          v[2] = p[4];
          v[3] = p[8 * kRowStride + 4];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(v[e], a_big[i][e], a_small[i][e]);
      }
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        const int n = wn0 + j * 8 + g;
        float v0, v1;
        if (T::kKMajor) {
          v0 = bs[n * kRowStride + kk + t];
          v1 = bs[n * kRowStride + kk + t + 4];
        } else {
          v0 = bs[(kk + t) * T::kBStrideN + n];
          v1 = bs[(kk + t + 4) * T::kBStrideN + n];
        }
        unsigned b0_big, b0_small, b1_big, b1_small;
        split_tf32(v0, b0_big, b0_small);
        split_tf32(v1, b1_big, b1_small);
#pragma unroll
        for (int i = 0; i < T::kMT; ++i) {
          float part[4];
          mma_tf32_first(part, a_small[i], b0_big, b1_big);
          mma_tf32(part, a_big[i], b0_small, b1_small);
          mma_tf32(part, a_big[i], b0_big, b1_big);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// C's tile at (m0, n0) into the row-major (rows, cols) matrix c, masked at
// the ragged edge.  Where cols is a multiple of 4, lanes t and t ^ 1 swap
// half their accumulators so that each stores 4 neighbouring columns of
// one row as a float4.
template <class T>
__device__ __forceinline__ void store_tile(
    const float (&acc)[T::kMT][T::kNT][4], float* __restrict__ c, int rows,
    int cols, int m0, int n0) {
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = m0 + (warp / T::kWarpsN) * T::kWM + g;
  const int c0 = n0 + (warp % T::kWarpsN) * T::kWN + 2 * t;
  const bool odd = t & 1;
  const bool by4 = cols % 4 == 0;
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
      const float* d = acc[i][j];
      const int r = r0 + i * 16;
      const int col = c0 + j * 8;
      if (by4) {
        // an even lane keeps row g and takes its partner's two columns of
        // it; an odd lane keeps row g + 8 and takes its partner's
        const float o0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
        const float o1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
        const int rr = odd ? r + 8 : r;
        const int cc = odd ? col - 2 : col;
        const float4 v = odd ? make_float4(o0, o1, d[2], d[3])
                             : make_float4(d[0], d[1], o0, o1);
        if (rr < rows && cc < cols)
          *reinterpret_cast<float4*>(
              &c[static_cast<long long>(rr) * cols + cc]) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = r + (e / 2) * 8;
          const int cc = col + (e % 2);
          if (rr < rows && cc < cols)
            c[static_cast<long long>(rr) * cols + cc] = d[e];
        }
      }
    }
  }
}

// One block of C (rows, cols) = A.B over the depth: the tile at (m0, n0),
// the depth chunk [blockIdx.z.chunk, min(depth, (blockIdx.z + 1).chunk))
// (chunk a multiple of kBK).  With one split the tile goes to `out`; with
// more, to the split's slice of `ws` (splits, rows, cols), which
// launch_split_sum adds up.
template <class T, class LoadA, class LoadB>
__device__ __forceinline__ void split_block(const LoadA& la, const LoadB& lb,
                                            float* smem, int depth, int chunk,
                                            float* __restrict__ out,
                                            float* __restrict__ ws, int rows,
                                            int cols, int m0, int n0) {
  const int t_begin = blockIdx.z * chunk;
  const int t_end = min(depth, t_begin + chunk);
  float acc[T::kMT][T::kNT][4] = {};
  mainloop<T>(la, lb, smem, t_begin, t_end, acc);
  float* dst = gridDim.z == 1
                   ? out
                   : ws + static_cast<long long>(blockIdx.z) * rows * cols;
  store_tile<T>(acc, dst, rows, cols, m0, n0);
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<BN>{}) for the tile widths the kernels are built for (the
// wrappers' TC_WIDTHS, ops/matmul.py), or cudaErrorInvalidValue.
template <class F>
int with_width(int bn, F&& f) {
  switch (bn) {
    case 8: return f(Int<8>{});
    case 16: return f(Int<16>{});
    case 32: return f(Int<32>{});
    case 96: return f(Int<96>{});
    case 128: return f(Int<128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(Int<4>{}) or f(Int<1>{}): a copy width of 4 or 1 floats, or
// cudaErrorInvalidValue.
template <class F>
int with_vec(int vec, F&& f) {
  if (vec == 4) return f(Int<4>{});
  if (vec == 1) return f(Int<1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(Int<1>{}) or f(Int<0>{}): a flag, or cudaErrorInvalidValue.
template <class F>
int with_flag(int flag, F&& f) {
  if (flag == 1) return f(Int<1>{});
  if (flag == 0) return f(Int<0>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Allows `kernel` its dynamic shared memory and launches it with the
// loop's kThreads.
template <class... P, class... A>
int launch(void (*kernel)(P...), int smem, dim3 grid, cudaStream_t st,
           A... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace
