// flash_attention: causal or non-causal GQA softmax attention, forward.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:
// flash_attention_fwd (_kernel). Inputs q (B, Sq, H, D) and k, v (B, Skv, KH,
// D), float32 or bf16, read through their (b, s, h) element strides with a
// unit-stride last dim; output (B, Sq, H, D), contiguous, in q's dtype:
//
//   s    = (q . k) * scale                      scale = 1 / sqrt(D)
//   mask = qpos >= kpos (causal) and kpos < Skv  masked scores are -1e30
//   out  = sum_k softmax(s)_k v_k                online softmax, f32 m, l, acc
//        = acc / max(l, 1e-30)
//
// Bound on the H100: operations. Causal attention at the smollm prefill shape
// (B 4, S 1024, H 9, D 64) does 4 B H S^2 D / 2 = 4.8 GFLOP on 14 MB of
// inputs and output, some 340 operations a byte, above the bf16 tensor cores'
// ~295 a byte. This first kernel runs the products as float32 FMAs on the
// CUDA cores (67 TFLOP/s, not 989), so it is far above its bound; wgmma tiles
// fed by TMA, with bf16 operands, are the later redesign.
//
// Design. One CTA per (q block of BQ = 64 rows, group of GB query heads of one
// KV head, batch). Its BQ * GB threads each own one (query row, head) pair and
// hold that row's q and its f32 accumulator in registers. The CTA loops over
// KV tiles of BK = 64 keys — the loop replaces the TPU
// grid's sequential third dimension — staging each K and V tile once in shared
// memory as f32 for all GB heads (the TPU kernel packs the G heads of a KV head
// into its lanes for the same reason). Causal CTAs stop at the tile holding the
// diagonal of their last row. Inside a tile the online softmax advances in
// chunks of 16 keys: 16 scores in registers, one max, one rescale of the
// accumulator. Every thread of a warp reads the same K or V row, so the shared
// loads are float4 broadcasts. Ragged Sq and Skv are masked here (the TPU
// kernel asserted divisibility): rows past Sq compute and are not stored, keys
// past Skv are staged as zeros and masked to -1e30.
//
// Numbers. Scores and statistics stay f32 with expf (not __expf); masked
// scores are the TPU kernel's finite -1e30, never -inf, and the first chunk of
// the first tile always holds key 0, which every row sees, so no exp argument
// is ever -1e30 - (-1e30) on a real row. Sums run in a fixed order with no
// atomics: the result is deterministic, so two runs of one prompt agree bit
// for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows a CTA
constexpr int CHUNK = 16;      // keys per online-softmax step
constexpr int MAX_GB = 4;      // query heads a CTA (BQ * MAX_GB threads)
constexpr float NEG = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(BQ * MAX_GB)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
                     int H, int G, int GB, Strides qs, Strides ks, Strides vs,
                     float scale) {
  constexpr int BK = 64;
  constexpr int D4 = D / 4;
  __shared__ float4 k_tile[BK][D4];
  __shared__ float4 v_tile[BK][D4];

  const int groups = G / GB;
  const int b = blockIdx.z;
  const int kh = blockIdx.y / groups;
  const int h = kh * G + (blockIdx.y % groups) * GB + threadIdx.x / BQ;
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + threadIdx.x % BQ;

  float qv[D];
  float acc[D];
  {
    const T* qp = q + b * qs.b + static_cast<long long>(min(qpos, Sq - 1)) * qs.s +
                  h * qs.h;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qv[d] = to_f32(qp[d]);
      acc[d] = 0.f;
    }
  }
  float m = NEG, l = 0.f;

  const int q_last = min(q0 + BQ, Sq) - 1;         // last stored row
  const int kv_end = CAUSAL ? min(Skv, q_last + 1) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  float* k_flat = reinterpret_cast<float*>(k_tile);
  float* v_flat = reinterpret_cast<float*>(v_tile);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                   // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * D; e += blockDim.x) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = to_f32(kb[kp * ks.s + d]);
        vx = to_f32(vb[kp * vs.s + d]);
      }
      k_flat[e] = kx;
      v_flat[e] = vx;
    }
    __syncthreads();

    for (int c = 0; c < BK; c += CHUNK) {
      float p[CHUNK];
      float mc = NEG;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const int kp = k0 + c + jj;
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D4; ++d4) {
          const float4 kk = k_tile[c + jj][d4];
          dot = fmaf(qv[4 * d4], kk.x, dot);
          dot = fmaf(qv[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qv[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qv[4 * d4 + 3], kk.w, dot);
        }
        const bool seen = kp < Skv && (!CAUSAL || kp <= qpos);
        p[jj] = seen ? dot * scale : NEG;
        mc = fmaxf(mc, p[jj]);
      }
      const float m_new = fmaxf(m, mc);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        p[jj] = expf(p[jj] - m_new);
        psum += p[jj];
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
#pragma unroll
        for (int d4 = 0; d4 < D4; ++d4) {
          const float4 vv = v_tile[c + jj][d4];
          acc[4 * d4] = fmaf(p[jj], vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p[jj], vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p[jj], vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p[jj], vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (qpos < Sq) {
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    T* op = out + (static_cast<long long>(b) * Sq + qpos) * H * D +
            static_cast<long long>(h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv_l);
  }
}

// Query heads a CTA holds: the largest divisor of G up to MAX_GB.
int heads_per_cta(int G) {
  for (int gb = MAX_GB; gb > 1; --gb)
    if (G % gb == 0) return gb;
  return 1;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Skv, int H, int KH, int causal, Strides qs, Strides ks, Strides vs,
           float scale, cudaStream_t stream) {
  const int G = H / KH;
  const int GB = heads_per_cta(G);
  const dim3 grid(static_cast<unsigned>((Sq + BQ - 1) / BQ),
                  static_cast<unsigned>(KH * (G / GB)), static_cast<unsigned>(B));
  const dim3 block(BQ * GB);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (causal)
    flash_fwd_kernel<T, D, true><<<grid, block, 0, stream>>>(qp, kp, vp, op, Sq, Skv, H,
                                                             G, GB, qs, ks, vs, scale);
  else
    flash_fwd_kernel<T, D, false><<<grid, block, 0, stream>>>(qp, kp, vp, op, Sq, Skv, H,
                                                              G, GB, qs, ks, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int KH, int causal, Strides qs, Strides ks,
               Strides vs, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KH, causal, qs, ks, vs, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KH, causal, qs, ks, vs, scale,
                           stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bf16. Strides are in elements.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int dtype, int B, int Sq, int Skv,
                                     int H, int KH, int D, int causal, long long qsb,
                                     long long qss, long long qsh, long long ksb,
                                     long long kss, long long ksh, long long vsb,
                                     long long vss, long long vsh, float scale,
                                     void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, B, Sq, Skv, H, KH, causal, qs, ks, vs,
                             scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, KH, causal, qs, ks,
                                     vs, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
