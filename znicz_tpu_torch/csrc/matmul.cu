// Float32 matrix product C = A.B for the unit graph's fc units and the
// conv tier's aT.b, on the tensor-core tile loop of csrc/gemm_tc.cuh.
//
// Replaces the TPU kernels znicz_tpu/ops/matmul.py pallas_matmul
// (_matmul_kernel): a block-tiled product with a float32 accumulator over a
// K-innermost grid, used by All2All's forward (x.W) and GradientDescent's
// weight gradient (xT.err_y) and input error (err_y.WT); and
// pallas_matmul_at_b, aT.b of row-major a (M, K) and
// b (M, N) with a (K, N) accumulator kept in VMEM while the M rows stream
// through the sequential grid axis.  Here aT.b is this product of the view
// aT (M-major) and b (N-major) with its depth M split across gridDim.z
// (ops/matmul.py matmul_at_b): at CIFAR conv1's patch matrix,
// (102400, 75)T.(102400, 32), one 128 x 32 tile over 247 splits.
//
// Operands are strided views: A is read at a[m*sam + k*sak] and B at
// b[k*sbk + n*sbn], so xT and WT reach the kernel as views of the row-major
// tensors and no transposed copy is made.  C is written contiguous
// row-major.  Ragged M, N and K are masked at the tile edge (zeros are
// copied in outside the matrix), never padded in device memory.
//
// The design: gemm_tc.cuh's block, a 128-row C tile of width BN (128, 96,
// 32, 16 or 8, from N), eight warps of mma.sync m16n8k8 TF32 products, a
// ring of three cp.async stages 32 deep.  Each operand is kept in shared
// memory in the layout it has in device memory, so that neighbouring
// threads copy neighbouring addresses: A K-major where k is its
// stride-1 axis (x, err_y), M-major where m is (the view xT); B N-major
// where n is (W, err_y), K-major where k is (the view WT).  A copy moves
// 16 bytes where that axis has stride 1 and an extent that is a multiple
// of 4, the other stride is a multiple of 4 and the base is 16-byte
// aligned, else 4; a view where neither stride is 1 takes the 4-byte
// copies.  The depth is split across gridDim.z where the tiles alone leave
// the card idle (MNIST's (100, 784).(784, 100) is one tile over 24.5
// stages); the splits' tiles go to a workspace that split_sum_kernel adds
// in ascending order.  The wrapper (ops/matmul.py matmul_plan) picks the
// layouts, copy widths, BN and the split, and allocates the workspace.
//
// Arithmetic: the 3xTF32 split of gemm_tc.cuh (each operand as a big and a
// small TF32 part, three products a multiply-add, a fresh partial every 8
// of the depth added to a float32 accumulator with an IEEE add): float32
// accuracy within the tests' tolerance (rtol 1e-5, atol 1e-5.sqrt(K)).
// The reference casts operands to bf16 on a TPU (_mxu_cast); this kernel
// does not.  TF32 stays off for PyTorch's own products
// (znicz_tpu_torch/__init__.py): this kernel's TF32 parts are its own.
//
// Bound on an H100: operations at large shapes.  In float32 FFMA 2.M.N.K
// over 67 TFLOP/s ((128, 9216).(9216, 4096), AlexNet's fc6, 0.144 ms); on
// the tensor cores three TF32 products a multiply-add, 6.M.N.K over 495
// TFLOP/s (0.0586 ms); mma.sync reaches a part of that rate
// (csrc/conv_gemm.cu's header).  At MNIST's shapes the launch and the
// latency of one block's steps bound it (100 x 784 x 100 is 15.7 Mflop).

#include "gemm_tc.cuh"

namespace {

template <int BN, bool kAMMajor, bool kBKMajor, int kVecA, int kVecB>
__global__ void __launch_bounds__(tc::kThreads,
                                  tc::Tile<BN, kBKMajor, kAMMajor>::kMinBlocks)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, float* __restrict__ ws, int m, int n,
              int k, long long sam, long long sak, long long sbk,
              long long sbn, int chunk) {
  using T = tc::Tile<BN, kBKMajor, kAMMajor>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * tc::kBM;
  const int n0 = blockIdx.y * BN;
  const tc::Dense<tc::kBM, kAMMajor ? tc::kAStrideM : tc::kRowStride,
                  !kAMMajor, kVecA, long long>
      la{a, sam, sak, m, k, m0};
  const tc::Dense<BN, kBKMajor ? tc::kRowStride : T::kBStrideN, kBKMajor,
                  kVecB, long long>
      lb{b, sbn, sbk, n, k, n0};
  tc::split_block<T>(la, lb, smem, k, chunk, c, ws, m, n, m0, n0);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Whether 16-byte copies may run along an operand's stride-1 axis: stride
// 1 there and an extent that is a multiple of 4, the other stride a
// multiple of 4, the base 16-byte aligned.
bool copies_of_4(const float* p, long long inner_stride, int inner_extent,
                 long long outer_stride) {
  return inner_stride == 1 && inner_extent % 4 == 0 &&
         outer_stride % 4 == 0 && aligned16(p);
}

}  // namespace

// C (m, n) contiguous = A.B with A, B given by base pointer and element
// strides.  m, n > 0 (the wrapper returns an empty product without a
// launch); k may be 0 (C = 0).  The wrapper's choice (ops/matmul.py
// MatmulPlan): bn (8, 16, 32, 96 or 128); a_mmajor (1: A kept M-major, its
// m stride 1), b_kmajor (1: B kept K-major, its k stride 1); vec_a, vec_b
// (4: 16-byte copies, allowed as copies_of_4 says; 1: 4-byte copies);
// `splits` chunks of `chunk` (a multiple of 32, none empty) cover k, and
// with splits > 1 ws holds splits.m.n floats.  Launches on `stream` (the
// split sum after the product), does not synchronise; returns
// cudaGetLastError() as an int, cudaErrorInvalidValue for a choice the
// shape or alignment does not allow.
extern "C" int znicz_matmul_f32(const float* a, const float* b, float* c,
                                float* ws, int m, int n, int k,
                                long long sam, long long sak, long long sbk,
                                long long sbn, int bn, int a_mmajor,
                                int b_kmajor, int vec_a, int vec_b,
                                int splits, int chunk, void* stream) {
  const bool bad_a = vec_a == 4 && !(a_mmajor ? copies_of_4(a, sam, m, sak)
                                              : copies_of_4(a, sak, k, sam));
  const bool bad_b = vec_b == 4 && !(b_kmajor ? copies_of_4(b, sbk, k, sbn)
                                              : copies_of_4(b, sbn, n, sbk));
  const bool bad_split =
      splits < 1 || splits > 65535 || chunk <= 0 || chunk % tc::kBK != 0 ||
      static_cast<long long>(splits) * chunk < k ||
      (splits > 1 && (static_cast<long long>(splits - 1) * chunk >= k ||
                      ws == nullptr));
  if (bad_a || bad_b || bad_split)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int status = tc::with_width(bn, [&](auto w) {
    return tc::with_flag(a_mmajor, [&](auto am) {
      return tc::with_flag(b_kmajor, [&](auto bk) {
        return tc::with_vec(vec_a, [&](auto va) {
          return tc::with_vec(vec_b, [&](auto vb) {
            constexpr int kBN = decltype(w)::value;
            constexpr bool kAM = decltype(am)::value == 1;
            constexpr bool kBK = decltype(bk)::value == 1;
            const dim3 grid((m + tc::kBM - 1) / tc::kBM,
                            (n + kBN - 1) / kBN, splits);
            if (grid.y > 65535)
              return static_cast<int>(cudaErrorInvalidValue);
            return tc::launch(
                matmul_kernel<kBN, kAM, kBK, decltype(va)::value,
                              decltype(vb)::value>,
                tc::Tile<kBN, kBK, kAM>::kSmemBytes, grid, st, a, b, c, ws,
                m, n, k, sam, sak, sbk, sbn, chunk);
          });
        });
      });
    });
  });
  if (status != 0) return status;
  return launch_split_sum(ws, c, m * n, splits, st);
}
