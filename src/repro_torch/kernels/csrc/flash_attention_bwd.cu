// flash_attention_bwd: causal or non-causal GQA softmax attention, backward.
//
// Replaces no TPU kernel: the Pallas flash kernel has no backward. It is the
// port's kernel for the reference's custom VJP of its attention core,
// repro/models/attention.py:_make_flash (bwd), which training differentiates
// through. Inputs q (B, Sq, H, D), k (B, Skv, KH, D) and v (B, Skv, KH, Dv),
// float32 or bf16, read through their (b, s, h) element strides with a
// unit-stride last dim; the forward's output and its gradient dO (B, Sq, H,
// Dv) and the forward's float32 log-sum-exp (B, Sq, H), contiguous. Outputs
// dq (B, Sq, H, D), dk (B, Skv, KH, D) and dv (B, Skv, KH, Dv), contiguous,
// in q's dtype, every sum in float32:
//
//   Drow = rowsum(dO * O)
//   P    = exp(s * scale - lse)     s = q . k; 0 where the forward masked
//   dV   = P^T dO                   dP = dO V^T
//   dS   = P * (dP - Drow) * scale
//   dQ   = dS K                     dK = dS^T Q
//
// with dK and dV summed over the G = H / KH query heads of each KV head.
// Masks as the forward's: causal is qpos >= kpos, both from 0; keys past Skv
// and rows past Sq are zero-filled and never stored.
//
// Three launches a call, one C entry: (1) Drow, one warp a row; (2) dK and
// dV, one CTA per (key tile of 64, KV head, batch), which walks the query
// tiles that see its keys (causal: from its own tile on) for each of its G
// query heads and keeps dK and dV in registers; (3) dQ, one CTA per (query
// tile of 64, query head, batch), which walks the key tiles its rows see
// (causal: up to the diagonal) and keeps dQ in registers. Each recomputes
// P and dS from the saved lse, as the reference's bwd does, so no (Sq, Skv)
// matrix reaches device memory. Every output element is written by one
// thread after a sum in a fixed order: no atomics, so a training step is
// bit-for-bit repeatable.
//
// The CUDA cores, float32: a CTA of 256 threads is a 16 x 16 grid, each
// thread a 4 x 4 block of the 64 x 64 score tile (rows tr + 16 i, keys
// tc + 16 j), its operands converted to float32 into shared memory rows
// padded by one float (a warp's 16 key columns then fall in 16 banks).
// Bound on the H100: operations. The backward does 2 (3 D + 2 Dv) flops a
// (query, key) pair the mask lets through (this design recomputes S and dP
// in both passes: 8 D + 6 Dv); at SmolLM's training shape (B 8, S 1024,
// 9/3 heads of 64, causal) that is 24.2 GFLOP on 47 MB, 0.0245 ms on the
// bf16 tensor cores. This first design leaves the tensor cores, cp.async
// and wgmma to a later PR: each FMA reads half a shared-memory word, so it
// runs at a fraction of the 67 TFLOP/s float32 peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Strides;

constexpr int BT = 64;          // query rows and keys a tile
constexpr int NTHREADS = 256;   // a 16 x 16 grid; each thread 4 x 4 of a tile
constexpr int ROWDOT_WARPS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Drow[r] = sum_d dO[r, d] O[r, d] over rows r of (B * Sq * H): one warp a row
template <typename T>
__global__ void __launch_bounds__(ROWDOT_WARPS * 32)
    flash_bwd_rowdot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                            float* __restrict__ drow, long long rows, int DV) {
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWDOT_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * DV;
  const T* d = dout + row * DV;
  float s = 0.f;
  for (int i = lane; i < DV; i += 32) s = fmaf(to_f(o[i]), to_f(d[i]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) drow[row] = s;
}

// rows [r0, r0 + BT) of one (batch, head) slice, W wide, into a float tile of
// row stride W + 1; rows past S are zero
template <int W, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ base,
                                          long long s_stride, int r0, int S) {
  for (int e = threadIdx.x; e < BT * W; e += NTHREADS) {
    const int r = e / W, c = e % W;
    const int pos = r0 + r;
    dst[r * (W + 1) + c] = pos < S ? to_f(base[pos * s_stride + c]) : 0.f;
  }
}

// lse and Drow of rows [q0, q0 + BT) of head h: (B, Sq, H) float32
__device__ __forceinline__ void load_rows(float* lse_s, float* drow_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ drow, int b, int h,
                                          int q0, int Sq, int H) {
  for (int r = threadIdx.x; r < BT; r += NTHREADS) {
    const int pos = q0 + r;
    const long long at = (static_cast<long long>(b) * Sq + pos) * H + h;
    lse_s[r] = pos < Sq ? lse[at] : 0.f;
    drow_s[r] = pos < Sq ? drow[at] : 0.f;
  }
}

// This thread's 4 x 4 block (rows tr + 16 i, keys tc + 16 j) of P and dS for
// the query tile at q0 (Qs, dOs) against the key tile at k0 (Ks, Vs).
template <int D, int DV, bool CAUSAL>
__device__ __forceinline__ void probs_and_ds(const float* Qs, const float* Ks,
                                             const float* dOs, const float* Vs,
                                             const float* lse_s, const float* drow_s,
                                             int q0, int k0, int Sq, int Skv, float scale,
                                             float p[4][4], float ds[4][4]) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(tr + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll 8
  for (int d = 0; d < DV; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = dOs[(tr + 16 * i) * (DV + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Vs[(tc + 16 * j) * (DV + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], b[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tc + 16 * j;
      const bool seen = qpos < Sq && kpos < Skv && (!CAUSAL || kpos <= qpos);
      const float pv = seen ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - drow_s[r]) * scale;
    }
  }
}

// shared floats of the dK/dV kernel: K, V, Q, dO tiles, P and dS, lse, Drow
template <int D, int DV>
constexpr int dkdv_floats() {
  return BT * (D + 1) * 2 + BT * (DV + 1) * 2 + 2 * BT * (BT + 1) + 2 * BT;
}
// ... of the dQ kernel: the same but P
template <int D, int DV>
constexpr int dq_floats() {
  return BT * (D + 1) * 2 + BT * (DV + 1) * 2 + BT * (BT + 1) + 2 * BT;
}

template <typename T, int D, int DV, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ drow,
                          T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H,
                          int KH, Strides qs, Strides ks, Strides vs, float scale) {
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + BT * (D + 1);
  float* Qs = Vs + BT * (DV + 1);
  float* dOs = Qs + BT * (D + 1);
  float* Ps = dOs + BT * (DV + 1);
  float* dSs = Ps + BT * (BT + 1);
  float* lse_s = dSs + BT * (BT + 1);
  float* drow_s = lse_s + BT;

  const int kt = blockIdx.x;       // low key tiles first: under a causal mask
  const int kh = blockIdx.y;       // they see the most query tiles
  const int b = blockIdx.z;
  const int k0 = kt * BT;
  const int G = H / KH;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  constexpr int DJ = D / 16, VJ = DV / 16;

  load_tile<D>(Ks, k + b * ks.b + kh * ks.h, ks.s, k0, Skv);
  load_tile<DV>(Vs, v + b * vs.b + kh * vs.h, vs.s, k0, Skv);

  float dk_acc[4][DJ], dv_acc[4][VJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < VJ; ++j) dv_acc[i][j] = 0.f;
  }

  const int n_qt = (Sq + BT - 1) / BT;
  const int qt_first = CAUSAL ? kt : 0;     // earlier query tiles see none of these keys
  const long long do_s = static_cast<long long>(H) * DV;   // dO's row stride
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();             // the previous tile's P, dS, Q and dO are consumed
      load_tile<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
      load_tile<DV>(dOs, dout + static_cast<long long>(b) * Sq * do_s + h * DV, do_s, q0, Sq);
      load_rows(lse_s, drow_s, lse, drow, b, h, q0, Sq, H);
      __syncthreads();
      float p[4][4], ds[4][4];
      probs_and_ds<D, DV, CAUSAL>(Qs, Ks, dOs, Vs, lse_s, drow_s, q0, k0, Sq, Skv, scale, p,
                                  ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(tr + 16 * i) * (BT + 1) + tc + 16 * j] = p[i][j];
          dSs[(tr + 16 * i) * (BT + 1) + tc + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV[c] += sum_r P[r, c] dO[r]; dK[c] += sum_r dS[r, c] Q[r]: this
      // thread's keys c = tr + 16 i, columns tc + 16 j
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pc[4], dsc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pc[i] = Ps[r * (BT + 1) + tr + 16 * i];
          dsc[i] = dSs[r * (BT + 1) + tr + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < VJ; ++j) {
          const float o = dOs[r * (DV + 1) + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dv_acc[i][j] = fmaf(pc[i], o, dv_acc[i][j]);
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float x = Qs[r * (D + 1) + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dk_acc[i][j] = fmaf(dsc[i], x, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + tr + 16 * i;
    if (kpos >= Skv) continue;
    const long long row = (static_cast<long long>(b) * Skv + kpos) * KH + kh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[row * D + tc + 16 * j] = from_f<T>(dk_acc[i][j]);
#pragma unroll
    for (int j = 0; j < VJ; ++j) dv[row * DV + tc + 16 * j] = from_f<T>(dv_acc[i][j]);
  }
}

template <typename T, int D, int DV, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ drow,
                        T* __restrict__ dq, int Sq, int Skv, int H, int KH, int n_qt,
                        Strides qs, Strides ks, Strides vs, float scale) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + BT * (D + 1);
  float* Ks = dOs + BT * (DV + 1);
  float* Vs = Ks + BT * (D + 1);
  float* dSs = Vs + BT * (DV + 1);
  float* lse_s = dSs + BT * (BT + 1);
  float* drow_s = lse_s + BT;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BT;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  constexpr int DJ = D / 16;
  const long long do_s = static_cast<long long>(H) * DV;

  load_tile<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<DV>(dOs, dout + static_cast<long long>(b) * Sq * do_s + h * DV, do_s, q0, Sq);
  load_rows(lse_s, drow_s, lse, drow, b, h, q0, Sq, H);

  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;

  const int q_last = min(q0 + BT, Sq) - 1;
  const int kv_end = CAUSAL ? min(Skv, q_last + 1) : Skv;
  const int n_kt = (kv_end + BT - 1) / BT;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BT;
    __syncthreads();               // the previous tile's K and dS are consumed
    load_tile<D>(Ks, k + b * ks.b + kh * ks.h, ks.s, k0, Skv);
    load_tile<DV>(Vs, v + b * vs.b + kh * vs.h, vs.s, k0, Skv);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_ds<D, DV, CAUSAL>(Qs, Ks, dOs, Vs, lse_s, drow_s, q0, k0, Sq, Skv, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(tr + 16 * i) * (BT + 1) + tc + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ[r] += sum_c dS[r, c] K[c]: rows r = tr + 16 i, columns tc + 16 j
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = dSs[(tr + 16 * i) * (BT + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float x = Ks[c * (D + 1) + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(dsr[i], x, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + tr + 16 * i;
    if (qpos >= Sq) continue;
    const long long row = (static_cast<long long>(b) * Sq + qpos) * H + h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[row * D + tc + 16 * j] = from_f<T>(dq_acc[i][j]);
  }
}

template <typename T, int D, int DV, bool CAUSAL>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* drow, void* dq, void* dk, void* dv,
               int B, int Sq, int Skv, int H, int KH, Strides qs, Strides ks, Strides vs,
               float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dr = static_cast<float*>(drow);

  const long long rows = static_cast<long long>(B) * Sq * H;
  if (rows > 0) {
    const long long blocks = (rows + ROWDOT_WARPS - 1) / ROWDOT_WARPS;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_rowdot_kernel<T><<<static_cast<unsigned>(blocks), ROWDOT_WARPS * 32, 0,
                                 stream>>>(static_cast<const T*>(out), dop, dr, rows, DV);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Skv > 0) {
    auto kernel = flash_bwd_dkdv_kernel<T, D, DV, CAUSAL>;
    constexpr int smem = dkdv_floats<D, DV>() * static_cast<int>(sizeof(float));
    // the limit is per device: set it on the current one at every launch
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned>((Skv + BT - 1) / BT), static_cast<unsigned>(KH),
                    static_cast<unsigned>(B));
    kernel<<<grid, NTHREADS, smem, stream>>>(qp, kp, vp, dop, lp, dr, static_cast<T*>(dk),
                                             static_cast<T*>(dv), Sq, Skv, H, KH, qs, ks, vs,
                                             scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Sq > 0) {
    auto kernel = flash_bwd_dq_kernel<T, D, DV, CAUSAL>;
    constexpr int smem = dq_floats<D, DV>() * static_cast<int>(sizeof(float));
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int n_qt = (Sq + BT - 1) / BT;
    const dim3 grid(static_cast<unsigned>(n_qt), static_cast<unsigned>(H),
                    static_cast<unsigned>(B));
    kernel<<<grid, NTHREADS, smem, stream>>>(qp, kp, vp, dop, lp, dr, static_cast<T*>(dq), Sq,
                                             Skv, H, KH, n_qt, qs, ks, vs, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int DV>
int dispatch_bwd(int causal, const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const void* lse, void* drow, void* dq, void* dk, void* dv,
                 int B, int Sq, int Skv, int H, int KH, Strides qs, Strides ks, Strides vs,
                 float scale, cudaStream_t st) {
  return causal ? launch_bwd<T, D, DV, true>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, Sq,
                                             Skv, H, KH, qs, ks, vs, scale, st)
                : launch_bwd<T, D, DV, false>(q, k, v, out, dout, lse, drow, dq, dk, dv, B,
                                              Sq, Skv, H, KH, qs, ks, vs, scale, st);
}

}  // namespace

// dtype: 0 float32, 1 bf16. D is the width of q and k, Dv of v, the output
// and dO; (D, Dv) must be a built pair. q, k and v are read through their
// (b, s, h) element strides; out, dout, lse and the outputs are contiguous;
// drow is float32 scratch of B * Sq * H.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* drow, void* dq, void* dk, void* dv, int dtype,
                                         int B, int Sq, int Skv, int H, int KH, int D, int Dv,
                                         int causal, long long qsb, long long qss,
                                         long long qsh, long long ksb, long long kss,
                                         long long ksh, long long vsb, long long vss,
                                         long long vsh, float scale, void* stream) {
  if (B == 0) return 0;
  if (KH <= 0 || H % KH != 0 || (dtype != 0 && dtype != 1) || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD_PAIR(DQ, DVV)                                                     \
  if (D == DQ && Dv == DVV)                                                             \
    return dtype == 0 ? dispatch_bwd<float, DQ, DVV>(causal, q, k, v, out, dout, lse,   \
                                                     drow, dq, dk, dv, B, Sq, Skv, H,   \
                                                     KH, qs, ks, vs, scale, st)         \
                      : dispatch_bwd<__nv_bfloat16, DQ, DVV>(                           \
                            causal, q, k, v, out, dout, lse, drow, dq, dk, dv, B, Sq,   \
                            Skv, H, KH, qs, ks, vs, scale, st);
  REPRO_FLASH_PAIRS(REPRO_FLASH_BWD_PAIR)
#undef REPRO_FLASH_BWD_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
