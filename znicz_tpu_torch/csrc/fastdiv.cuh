// Division by a divisor fixed at launch, for index arithmetic in kernels.
//
// A 32-bit division by a runtime value costs the GPU some twenty
// instructions; the pooling and LRN kernels decompose every flat index
// into (b, h, w, c) and need several per thread, which made them bound by
// integer division rather than bytes.  FastDiv precomputes on the host a
// multiplier m and shift s (Granlund and Montgomery, as in PyTorch's
// IntDivider) so that n / d = (umulhi(n, m) + n) >> s: a multiply, an add
// and a shift.  Exact for every 0 <= n < 2^31 and 1 <= d < 2^31 (t + n then
// fits 32 bits); the wrappers refuse tensors of 2^31 elements or more.

#pragma once

#include <cstdint>

struct FastDiv {
  unsigned int d;
  unsigned int m;
  unsigned int s;

  __device__ __forceinline__ int div(int n) const {
    const unsigned int u = static_cast<unsigned int>(n);
    return static_cast<int>((__umulhi(u, m) + u) >> s);
  }
};

inline FastDiv make_fastdiv(int divisor) {
  const unsigned int d = static_cast<unsigned int>(divisor);
  unsigned int s = 0;
  while ((1u << s) < d) ++s;
  const uint64_t one = 1;
  const uint64_t m = ((one << 32) * ((one << s) - d)) / d + 1;
  return FastDiv{d, static_cast<unsigned int>(m), s};
}
