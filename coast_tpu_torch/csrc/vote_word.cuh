// The word-level compare and vote shared by K1 (vote.cu) and K2 (commit.cu).
//
// Compares are in the leaf's type.  IS_FLOAT compares as float32 (IEEE:
// +0 == -0, NaN != NaN) with subnormal operands read as zero, as the
// reference's compare does (XLA flushes subnormals on the CPU and the TPU);
// otherwise as 32-bit integers (int32 and uint32 leaves).  The voted word is
// always a lane's raw bits.
#pragma once

#include <stdint.h>

namespace coast {

__device__ __forceinline__ uint32_t flush_subnormal(uint32_t w) {
  return (w & 0x7f800000u) ? w : 0u;
}

template <bool IS_FLOAT>
__device__ __forceinline__ bool same(uint32_t a, uint32_t b) {
  if (IS_FLOAT)
    return __uint_as_float(flush_subnormal(a)) ==
           __uint_as_float(flush_subnormal(b));
  return a == b;
}

// TMR (N = 3): (a == b) ? a : c, bad when a != b or b != c.
// DWC (N = 2): a, bad when a != b (c is not read).
template <bool IS_FLOAT, int N>
__device__ __forceinline__ uint32_t vote_word(uint32_t a, uint32_t b,
                                              uint32_t c, bool& bad) {
  const bool ab = same<IS_FLOAT>(a, b);
  if (N == 3) {
    bad |= !ab || !same<IS_FLOAT>(b, c);
    return ab ? a : c;
  }
  bad |= !ab;
  return a;
}

}  // namespace coast
