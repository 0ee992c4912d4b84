// flash_attention_f32: the float32 kernel of flash_attention.cu (see its
// header comment, "float32"), in a translation unit of its own so that nvcc
// compiles it beside the bf16 kernel.
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

using flash::BK;
using flash::BQ;
using flash::NEG;
using flash::Strides;

constexpr int CHUNK = 16;      // keys per online-softmax step
constexpr int MAX_GB = 4;      // query heads a CTA (BQ * MAX_GB threads)

template <int D, int DV, bool CAUSAL>
__global__ void __launch_bounds__(BQ * MAX_GB)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Skv, int H, int G, int GB,
                         Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int D4 = D / 4, DV4 = DV / 4;
  extern __shared__ float4 kv_tiles[];   // K (BK rows of D4 float4), then V (DV4)
  float4* k_tile = kv_tiles;
  float4* v_tile = kv_tiles + BK * D4;

  const int groups = G / GB;
  const int b = blockIdx.z;
  const int kh = blockIdx.y / groups;
  const int h = kh * G + (blockIdx.y % groups) * GB + threadIdx.x / BQ;
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + threadIdx.x % BQ;

  float qv[D];
  float acc[DV];
  {
    const float* qp = q + b * qs.b + static_cast<long long>(min(qpos, Sq - 1)) * qs.s +
                      h * qs.h;
#pragma unroll
    for (int d = 0; d < D; ++d) qv[d] = qp[d];
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[d] = 0.f;
  }
  float m = NEG, l = 0.f;

  const int q_last = min(q0 + BQ, Sq) - 1;         // last stored row
  const int kv_end = CAUSAL ? min(Skv, q_last + 1) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  float* k_flat = reinterpret_cast<float*>(k_tile);
  float* v_flat = reinterpret_cast<float*>(v_tile);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                   // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * D; e += blockDim.x) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      k_flat[e] = kp < Skv ? kb[kp * ks.s + d] : 0.f;
    }
    for (int e = threadIdx.x; e < BK * DV; e += blockDim.x) {
      const int j = e / DV, d = e % DV;
      const int kp = k0 + j;
      v_flat[e] = kp < Skv ? vb[kp * vs.s + d] : 0.f;
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
          const float4 kk = k_tile[(c + jj) * D4 + d4];
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
      for (int d = 0; d < DV; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
#pragma unroll
        for (int d4 = 0; d4 < DV4; ++d4) {
          const float4 vv = v_tile[(c + jj) * DV4 + d4];
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
    float* op = out + (static_cast<long long>(b) * Sq + qpos) * H * DV +
                static_cast<long long>(h) * DV;
#pragma unroll
    for (int d = 0; d < DV; ++d) op[d] = acc[d] * inv_l;
    if (lse != nullptr)
      lse[(static_cast<long long>(b) * Sq + qpos) * H + h] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <int D, int DV, bool CAUSAL>
int launch_pair(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Sq, int Skv, int H, int KH, Strides qs, Strides ks, Strides vs,
                float scale, cudaStream_t stream) {
  const int G = H / KH;
  const int GB = flash::heads_per_cta(G, MAX_GB);
  const dim3 grid(static_cast<unsigned>((Sq + BQ - 1) / BQ),
                  static_cast<unsigned>(KH * (G / GB)), static_cast<unsigned>(B));
  auto kernel = flash_fwd_f32_kernel<D, DV, CAUSAL>;
  constexpr int smem = BK * (D + DV) * static_cast<int>(sizeof(float));
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, BQ * GB, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, Sq, Skv, H, G, GB, qs, ks, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash::launch_f32(int D, int Dv, bool causal, const void* q, const void* k, const void* v,
                      void* out, float* lse, int B, int Sq, int Skv, int H, int KH,
                      Strides qs, Strides ks, Strides vs, float scale,
                      cudaStream_t stream) {
#define REPRO_FLASH_F32(DQ, DVV)                                                         \
  if (D == DQ && Dv == DVV)                                                            \
    return causal ? launch_pair<DQ, DVV, true>(q, k, v, out, lse, B, Sq, Skv, H, KH, qs, \
                                               ks, vs, scale, stream)                   \
                  : launch_pair<DQ, DVV, false>(q, k, v, out, lse, B, Sq, Skv, H, KH,   \
                                                qs, ks, vs, scale, stream);
  REPRO_FLASH_PAIRS(REPRO_FLASH_F32)
#undef REPRO_FLASH_F32
  return static_cast<int>(cudaErrorInvalidValue);
}
