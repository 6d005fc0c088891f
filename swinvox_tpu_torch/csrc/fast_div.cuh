// Division by a divisor known only at launch, as a multiply-high and a
// shift, for kernels A (rewindow.cu) and G (window_attention.cu): the
// host computes the magic number once, the device divides in two
// instructions where a runtime integer division takes about twenty.
//
// n / d for 0 <= n < 2^31 and d >= 1 by the round-up reciprocal of
// Granlund and Montgomery (as CUTLASS's FastDivmod): with l = ceil(log2
// d), m = ceil(2^(31 + l) / d) fits 32 bits and q = umulhi(n, m) >> (l -
// 1).
//
// Everything is in an anonymous namespace: each source that includes it
// gets its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

struct FastDiv {
  unsigned m;
  int shift;  // -1: d is 1
  __device__ __forceinline__ int div(int n) const {
    return shift < 0 ? n : (int)(__umulhi((unsigned)n, m) >> shift);
  }
};

inline FastDiv fast_div(int d) {
  if (d == 1) return {0u, -1};
  int l = 0;
  while ((1LL << l) < d) ++l;
  const unsigned long long p = 1ULL << (31 + l);
  return {(unsigned)((p + d - 1) / d), l - 1};
}

}  // namespace
