// blind_encode: scale + quantize + blind + limb-encode, one pass.
//
// Replaces the TPU kernel repro/kernels/blind/blind.py:blind_encode_pallas
// (_blind_encode_kernel). For each element of x (M, K) float32 and its
// one-time pad r (M, K) int32 in [0, p):
//
//   q = clip(round_half_even(x * inv_scale * 2^k), -HALF, HALF)
//   b = (q mod p + r) mod p  ->  signed canonical  ->  3 balanced base-256
//   digits, written plane-major into (3, M, Kp) int8 (columns K..Kp-1 zero).
//
// Bound on the H100: bytes. 8 bytes read and 3 written per element, a few
// dozen integer and float ops: far below the card's ops-per-byte line.
// Design: one thread per output element in a grid-stride loop, neighbouring
// threads on neighbouring addresses, no shared memory. The kernel writes the
// limb planes in the layout and K padding the limb matmul reads, so no
// separate quantize, pad or limb-split pass over device memory exists.
// Rounding is rintf (round half to even, like jnp.round) of one
// correctly-rounded f32 product per step (__fmul_rn, no FMA contraction).
#include "field.cuh"

namespace {

__global__ void blind_encode_kernel(const float* __restrict__ x,
                                    const int* __restrict__ r,
                                    const float* __restrict__ inv_scale,
                                    int8_t* __restrict__ out, long long M, int K,
                                    int Kp, int k_bits) {
  const long long total = M * Kp;
  const float inv = *inv_scale;
  const float two_k = ldexpf(1.0f, k_bits);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long m = e / Kp;
    const int c = static_cast<int>(e - m * Kp);
    int l0 = 0, l1 = 0, l2 = 0;
    if (c < K) {
      const long long i = m * K + c;
      float v = rintf(__fmul_rn(__fmul_rn(x[i], inv), two_k));
      v = fminf(fmaxf(v, -static_cast<float>(field::HALF)),
                static_cast<float>(field::HALF));
      const int q = static_cast<int>(v);
      const int b = field::mod_p(static_cast<long long>(field::mod_p(q)) + r[i]);
      const int s = b > field::HALF ? b - field::P : b;
      l0 = ((s + 128) & 255) - 128;
      const int s1 = (s - l0) >> 8;
      l1 = ((s1 + 128) & 255) - 128;
      l2 = (s1 - l1) >> 8;
    }
    out[e] = static_cast<int8_t>(l0);
    out[total + e] = static_cast<int8_t>(l1);
    out[2 * total + e] = static_cast<int8_t>(l2);
  }
}

}  // namespace

extern "C" int repro_blind_encode(const void* x, const void* r, const void* inv_scale,
                                  void* out, long long M, int K, int Kp, int k_bits,
                                  void* stream) {
  const long long total = M * Kp;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  blind_encode_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(r),
      static_cast<const float*>(inv_scale), static_cast<int8_t*>(out), M, K, Kp, k_bits);
  return static_cast<int>(cudaGetLastError());
}
