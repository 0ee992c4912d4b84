// Field constants and helpers shared by the limb kernels (Z_p, p = 2^23 - 15).
//
// A signed-canonical field element s in [-(p-1)/2, (p-1)/2] is held as three
// balanced base-256 int8 digits (limb planes); a field product is nine int8
// limb products grouped by limb power s = i + j, each group reduced mod p
// and shifted by 256^s mod p. See repro_torch/kernels/limb_matmul/ref.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace field {

constexpr int P = (1 << 23) - 15;        // 8388593, prime
constexpr int HALF = (P - 1) / 2;

// Non-negative residue of an int64 (C's % keeps the dividend's sign).
__device__ __forceinline__ int mod_p(long long v) {
  long long r = v % P;
  return static_cast<int>(r < 0 ? r + P : r);
}

// v mod p in [0, p) for any int32 v, without 64-bit arithmetic: with
// v = hi * 2^23 + lo and 2^23 = 15 (mod p), v is congruent to lo + 15 hi,
// which lies in [-3840, p + 3840), one correction from [0, p).
__device__ __forceinline__ int reduce32(int v) {
  int r = (v & ((1 << 23) - 1)) + 15 * (v >> 23);
  r = r < 0 ? r + P : r;
  return r >= P ? r - P : r;
}

// Recombine five power-group sums (any int32 each) into one field element
// in [0, p), in 32-bit arithmetic: the shifts 256^s mod p (1, 256, 65536,
// 30, 7680; 2^24 = 30 mod p) as steps of * 256 and * 30 on residues below
// p < 2^23, so every product stays below 2^31; the five terms sum below 5p.
__device__ __forceinline__ int recombine32(const int g[5]) {
  const int t1 = reduce32(reduce32(g[1]) * 256);
  const int t2 = reduce32(reduce32(reduce32(g[2]) * 256) * 256);
  const int t3 = reduce32(reduce32(g[3]) * 30);
  const int t4 = reduce32(reduce32(reduce32(g[4]) * 30) * 256);
  return reduce32(reduce32(g[0]) + t1 + t2 + t3 + t4);
}

}  // namespace field
