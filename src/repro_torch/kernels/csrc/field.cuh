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

// 256^s mod p for s = 0..4 (2^23 = p + 15, so 2^24 = 30 mod p)
__device__ __forceinline__ long long pow256(int s) {
  return s == 0 ? 1LL : s == 1 ? 256LL : s == 2 ? 65536LL : s == 3 ? 30LL
                                                                   : 7680LL;
}

// Non-negative residue of an int64 (C's % keeps the dividend's sign).
__device__ __forceinline__ int mod_p(long long v) {
  long long r = v % P;
  return static_cast<int>(r < 0 ? r + P : r);
}

// Recombine five power-group sums into one field element in [0, p).
// Each reduced group is < 2^23 and 256^s mod p < 2^13, so the int64 sum
// of the five shifted groups stays below 2^39.
__device__ __forceinline__ int recombine(const long long g[5]) {
  long long acc = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) acc += static_cast<long long>(mod_p(g[s])) * pow256(s);
  return static_cast<int>(acc % P);
}

// v mod p in [0, p) for any int32 v, without 64-bit arithmetic: with
// v = hi * 2^23 + lo and 2^23 = 15 (mod p), v is congruent to lo + 15 hi,
// which lies in [-3840, p + 3840), one correction from [0, p).
__device__ __forceinline__ int reduce32(int v) {
  int r = (v & ((1 << 23) - 1)) + 15 * (v >> 23);
  r = r < 0 ? r + P : r;
  return r >= P ? r - P : r;
}

// recombine() in 32-bit arithmetic: the shifts 256^s mod p (1, 256, 65536,
// 30, 7680) as steps of * 256 and * 30 on residues below p < 2^23, so
// every product stays below 2^31; the five terms sum below 5p.
__device__ __forceinline__ int recombine32(const int g[5]) {
  const int t1 = reduce32(reduce32(g[1]) * 256);
  const int t2 = reduce32(reduce32(reduce32(g[2]) * 256) * 256);
  const int t3 = reduce32(reduce32(g[3]) * 30);
  const int t4 = reduce32(reduce32(reduce32(g[4]) * 30) * 256);
  return reduce32(reduce32(g[0]) + t1 + t2 + t3 + t4);
}

// The nine limb dot products of four packed k positions, added into the
// five power groups: a[i] holds four int8 digits of x-plane i, b[j] the
// matching four digits of w-plane j.
__device__ __forceinline__ void dp4a_groups(const int a[3], const int b[3], int g[5]) {
  g[0] = __dp4a(a[0], b[0], g[0]);
  g[1] = __dp4a(a[0], b[1], __dp4a(a[1], b[0], g[1]));
  g[2] = __dp4a(a[0], b[2], __dp4a(a[1], b[1], __dp4a(a[2], b[0], g[2])));
  g[3] = __dp4a(a[1], b[2], __dp4a(a[2], b[1], g[3]));
  g[4] = __dp4a(a[2], b[2], g[4]);
}

}  // namespace field
