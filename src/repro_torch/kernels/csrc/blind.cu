// blind / unblind: the elementwise passes of the unfused Slalom data path.
//
// Replaces the TPU kernels repro/kernels/blind/blind.py:blind_pallas
// (_blind_kernel) and unblind_pallas (_unblind_kernel), both tiled there by
// _tiled_call. For n elements of any shape, flattened:
//
//   blind:    out = (clip(round_half_even(x * 2^k), -HALF, HALF) mod p + r) mod p
//             x float32, r int32 field in [0, p)  ->  int32 field
//   unblind:  out = signed((y - u + p) mod p) / 2^k_out
//             y, u int32 field in [0, p)           ->  float32
//
// Bound on the H100: bytes. Each element reads 8 bytes and writes 4, with a
// dozen integer and float ops: far below the card's ops-per-byte line.
// Design: a grid-stride loop with 16-byte vector loads and stores (four
// elements a thread a step) when every pointer is 16-byte aligned, and a
// scalar loop for the tail and for unaligned pointers; the element count is
// 64-bit. No padding: the TPU version padded to its (256, 512) tiles, here
// the loop bound masks the ragged end.
//
// Exactness: x * 2^k is one correctly rounded f32 multiply (__fmul_rn, no
// FMA contraction) and rintf rounds half to even, like jnp.round; the
// residues are taken in int64 with a non-negative remainder (jnp.mod);
// dividing by 2^k_out is exact (__fdiv_rn by a power of two).
#include <stdint.h>

#include "field.cuh"

namespace {

__device__ __forceinline__ int blind_one(float x, int r, float two_k) {
  float v = rintf(__fmul_rn(x, two_k));
  v = fminf(fmaxf(v, -static_cast<float>(field::HALF)),
            static_cast<float>(field::HALF));
  const int q = field::mod_p(static_cast<long long>(v));
  return field::mod_p(static_cast<long long>(q) + r);
}

__device__ __forceinline__ float unblind_one(int y, int u, float two_k) {
  const int d = field::mod_p(static_cast<long long>(y) - u + field::P);
  const int s = d > field::HALF ? d - field::P : d;
  return __fdiv_rn(static_cast<float>(s), two_k);
}

template <bool kVec>
__global__ void blind_kernel(const float* __restrict__ x, const int* __restrict__ r,
                             int* __restrict__ out, long long n, int k_bits) {
  const float two_k = ldexpf(1.0f, k_bits);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (kVec) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int4* r4 = reinterpret_cast<const int4*>(r);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const float4 xv = x4[i];
      const int4 rv = r4[i];
      int4 o;
      o.x = blind_one(xv.x, rv.x, two_k);
      o.y = blind_one(xv.y, rv.y, two_k);
      o.z = blind_one(xv.z, rv.z, two_k);
      o.w = blind_one(xv.w, rv.w, two_k);
      o4[i] = o;
    }
    tail = n4 << 2;
  }
  for (long long e = tail + tid; e < n; e += stride) out[e] = blind_one(x[e], r[e], two_k);
}

template <bool kVec>
__global__ void unblind_kernel(const int* __restrict__ y, const int* __restrict__ u,
                               float* __restrict__ out, long long n, int k_out_bits) {
  const float two_k = ldexpf(1.0f, k_out_bits);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (kVec) {
    const long long n4 = n >> 2;
    const int4* y4 = reinterpret_cast<const int4*>(y);
    const int4* u4 = reinterpret_cast<const int4*>(u);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const int4 yv = y4[i];
      const int4 uv = u4[i];
      float4 o;
      o.x = unblind_one(yv.x, uv.x, two_k);
      o.y = unblind_one(yv.y, uv.y, two_k);
      o.z = unblind_one(yv.z, uv.z, two_k);
      o.w = unblind_one(yv.w, uv.w, two_k);
      o4[i] = o;
    }
    tail = n4 << 2;
  }
  for (long long e = tail + tid; e < n; e += stride) out[e] = unblind_one(y[e], u[e], two_k);
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

unsigned grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int repro_blind(const void* x, const void* r, void* out, long long n, int k_bits,
                           void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int* rp = static_cast<const int*>(r);
  int* op = static_cast<int*>(out);
  if (aligned16(x, r, out)) {
    blind_kernel<true><<<grid_for(n >> 2, threads), threads, 0, s>>>(xp, rp, op, n, k_bits);
  } else {
    blind_kernel<false><<<grid_for(n, threads), threads, 0, s>>>(xp, rp, op, n, k_bits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_unblind(const void* y, const void* u, void* out, long long n,
                             int k_out_bits, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* yp = static_cast<const int*>(y);
  const int* up = static_cast<const int*>(u);
  float* op = static_cast<float*>(out);
  if (aligned16(y, u, out)) {
    unblind_kernel<true><<<grid_for(n >> 2, threads), threads, 0, s>>>(yp, up, op, n, k_out_bits);
  } else {
    unblind_kernel<false><<<grid_for(n, threads), threads, 0, s>>>(yp, up, op, n, k_out_bits);
  }
  return static_cast<int>(cudaGetLastError());
}
