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
// ~295 a byte: 4.9 us at 989 TFLOP/s.
//
// bf16: the tensor cores, FlashAttention-2's register-resident form with
// mma.sync m16n8k16 (bf16 in, f32 sums). mma.sync and not wgmma: at D = 32
// and 64 a warp's 16 query rows against a 64-key tile are a handful of
// m16n8k16 products, P goes from the S accumulators to the A fragment of
// P.V in registers, and wgmma would need P staged in the swizzled shared
// layout of its descriptors. One CTA per (q block of 64 positions, group of
// GB <= 3 query heads of one KV head, batch): the GB heads' rows are stacked
// into the M dimension (GB x 4 warps, 16 rows each, a warp one head), as the
// TPU kernel packs them into its lanes, so each K and V tile is loaded once
// per KV head and q block. K and V tiles of 64 keys arrive by cp.async into
// a ring of two stages, the next tile in flight while this one is
// multiplied; rows are padded by 16 bytes so ldmatrix reads without bank
// conflicts. S = Q.K^T reads K non-transposed as the B operand; P is
// repacked from S's accumulator fragment into P.V's A fragment, in two bf16
// parts (hi = bf16(P), lo = bf16(P - hi): 16 significant bits, so the
// result keeps the TPU kernel's f32 accuracy up to the output's one bf16
// rounding; P in one bf16 part put one output ulp, 0.0156 at |o| in [2, 4),
// against the 2e-2 tolerance); V is read with ldmatrix.trans as P.V's B
// operand, once for both parts. Only tiles that cross the diagonal or the
// ragged end of Skv are masked; a warp whose 16 rows all lie above a tile
// skips it (all its scores would be masked: exp gives exact zeros and the
// running max does not move, so skipping changes no bit). The grid walks the
// q blocks heaviest first, so the long causal rows start before the short
// ones fill the gaps. Rows past Sq and keys past Skv are zero-filled by the
// copies (source size 0) and never stored or seen. The statistics are f32 in
// the exp2 domain (scores scaled by log2(e) / sqrt(D), exp2f). D = 64 takes
// ~160 registers a thread, so one 384-thread CTA an SM; q blocks of 32
// (two CTAs an SM) measured the same. D = 128 (Qwen3-MoE, Arctic) holds
// twice the output tiles and Q fragments (64 + 32 registers a thread beside
// the 32 of S), more than the ~168 a thread that 384 threads leave, so its
// CTA holds at most 2 heads (256 threads, up to 255 registers a thread):
// 2 x 64 q rows and two K/V stages take 104,448 bytes of shared memory. At
// Qwen's 16 query heads a KV head a CTA holds 2 heads at either width.
//
// float32: the CUDA cores (its tolerance, 2e-5, rules out bf16 and TF32
// operands; at the prefill shape it takes 0.56 ms against 0.90 ms for
// scaled_dot_product_attention in float32 on an H100 80GB HBM3 at 700 W).
// One CTA per (q block of 64 rows, group of up to 4 query heads of
// one KV head, batch); a thread owns one (row, head) pair with its q and f32
// accumulator in registers; each 64-key K/V tile is staged once in dynamic
// shared memory for all heads (64 KB at D = 128, past the 48 KB a static
// array may take); the online softmax advances in chunks of 16 keys. At
// D = 128 the thread's q and accumulator (256 floats) exceed the 255
// registers a thread may hold, so they spill to local memory: a sweep-only
// dtype, its spill bytes printed by the build line.
//
// Numbers. Masked scores are the TPU kernel's finite -1e30, never -inf, and
// the first tile always holds key 0, which every row sees, so no exp argument
// is ever -1e30 - (-1e30) on a real row. Sums run in a fixed order with no
// atomics: the result is deterministic, so two runs of one prompt agree bit
// for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int BQ = 64;         // query positions a CTA (both kernels)
constexpr int BK = 64;         // keys a tile
constexpr float NEG = -1e30f;

struct Strides {
  long long b, s, h;
};

// ---- bf16: tensor cores ----

// query heads a CTA: 3 at D <= 64, 2 at D = 128 (registers, above)
template <int D>
constexpr int mma_max_gb() { return D >= 128 ? 2 : 3; }
constexpr int WARPS_PER_HEAD = BQ / 16;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int ROW = 2 * D + 16;    // padded row, bytes
  static constexpr int CHUNKS = 2 * D / 16; // 16-byte chunks a row
  static constexpr int TILE = BK * ROW;
  // q rows of GB heads, then K and V of two stages
  static constexpr int bytes(int GB) { return GB * BQ * ROW + 4 * TILE; }
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// (a, b) = hi + lo in two packed bf16 pairs: lo is the rounding error of hi
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

template <int D>
__device__ __forceinline__ void load_kv(char* kbuf, char* vbuf, const __nv_bfloat16* kb,
                                        const __nv_bfloat16* vb, Strides ks, Strides vs,
                                        int k0, int Skv, int nthreads) {
  using S = Smem<D>;
  for (int e = threadIdx.x; e < 2 * BK * S::CHUNKS; e += nthreads) {
    const bool is_v = e >= BK * S::CHUNKS;
    const int rem = is_v ? e - BK * S::CHUNKS : e;
    const int row = rem / S::CHUNKS, c = rem % S::CHUNKS;
    const int kp = k0 + row;
    const bool ok = kp < Skv;
    const __nv_bfloat16* src =
        is_v ? vb + (ok ? kp : 0) * vs.s + 8 * c : kb + (ok ? kp : 0) * ks.s + 8 * c;
    tiles::cp_async16((is_v ? vbuf : kbuf) + row * S::ROW + 16 * c, src, ok);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(mma_max_gb<D>() * WARPS_PER_HEAD * 32, 1)
    flash_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int G,
                              int GB, int n_qblocks, int n_heads_b, Strides qs, Strides ks,
                              Strides vs, float scale) {
  using S = Smem<D>;
  constexpr int DT = D / 8;     // n8 tiles of the output
  constexpr int DK = D / 16;    // k16 steps of Q.K^T
  constexpr int NT = BK / 8;    // n8 tiles of S
  extern __shared__ __align__(128) char smem[];
  char* qbuf = smem;
  char* kvbuf = smem + GB * BQ * S::ROW;  // stage s: K at 2s TILE, V at 2s+1

  // heaviest q blocks first: block index -> (q block from the end, batch,
  // KV head, group of GB of its G query heads)
  const int qb = n_qblocks - 1 - static_cast<int>(blockIdx.x / n_heads_b);
  const int hb = blockIdx.x % n_heads_b;
  const int groups = G / GB;
  const int per_batch = (H / G) * groups;
  const int bidx = hb / per_batch;
  const int kh = (hb % per_batch) / groups;
  const int h0 = kh * G + (hb % groups) * GB;
  const int q0 = qb * BQ;
  const int nthreads = blockDim.x;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = warp / WARPS_PER_HEAD;               // head within the group
  const int p0 = (warp % WARPS_PER_HEAD) * 16;        // warp's first position
  const int g = lane / 4, t = lane % 4;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = CAUSAL ? min(Skv, q_last + 1) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const __nv_bfloat16* kb = k + bidx * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + bidx * vs.b + kh * vs.h;

  // q rows of the GB heads, then K/V tile 0: one copy group
  for (int e = threadIdx.x; e < GB * BQ * S::CHUNKS; e += nthreads) {
    const int row = e / S::CHUNKS, c = e % S::CHUNKS;
    const int qpos = q0 + row % BQ;
    const bool ok = qpos < Sq;
    const __nv_bfloat16* src =
        q + bidx * qs.b + (ok ? qpos : 0) * qs.s + (h0 + row / BQ) * qs.h + 8 * c;
    tiles::cp_async16(qbuf + row * S::ROW + 16 * c, src, ok);
  }
  if (n_tiles > 0) load_kv<D>(kvbuf, kvbuf + S::TILE, kb, vb, ks, vs, 0, Skv, nthreads);
  tiles::cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_row[2] = {NEG, NEG}, l_row[2] = {0.f, 0.f};   // rows g, g + 8 (l per lane)
  unsigned qf[DK][4];
  const float sl2 = scale * LOG2E;
  const int row_lo = q0 + p0;                          // the warp's first position
  const bool warp_live = row_lo < Sq;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    if (tile + 1 < n_tiles) {
      char* nb = kvbuf + 2 * ((tile + 1) & 1) * S::TILE;
      load_kv<D>(nb, nb + S::TILE, kb, vb, ks, vs, k0 + BK, Skv, nthreads);
    }
    tiles::cp_async_commit();
    tiles::cp_async_wait<1>();   // tile `tile` (and q) have landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        tiles::ldmatrix_x4(qf[kk], qbuf + (gi * BQ + p0 + (lane & 15)) * S::ROW +
                                       2 * (16 * kk + (lane >> 4) * 8));
    }
    const bool skip = !warp_live || (CAUSAL && k0 > row_lo + 15);
    if (!skip) {
      const char* kt = kvbuf + 2 * (tile & 1) * S::TILE;
      const char* vt = kt + S::TILE;

      // S = Q K^T: K rows (keys) as the col-major B operand
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          unsigned kf[4];
          tiles::ldmatrix_x4(kf, kt + (16 * jj + (lane & 7) + (lane >> 4) * 8) * S::ROW +
                                     2 * (16 * kk + ((lane >> 3) & 1) * 8));
          tiles::mma_bf16_16816(s[2 * jj], qf[kk], &kf[0]);
          tiles::mma_bf16_16816(s[2 * jj + 1], qf[kk], &kf[2]);
        }

      // scale, mask, online softmax (exp2 domain)
      const bool masked = k0 + BK > Skv || (CAUSAL && k0 + BK - 1 > row_lo);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = s[j][r] * sl2;
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * t + (r & 1);
            const int qpos = row_lo + g + 8 * (r >> 1);
            if (kpos >= Skv || (CAUSAL && kpos > qpos)) x = NEG;
          }
          s[j][r] = x;
          mx[r >> 1] = fmaxf(mx[r >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_row[h], mx[h]);
        corr[h] = exp2f(m_row[h] - m_new);
        m_row[h] = m_new;
        l_row[h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = exp2f(s[j][r] - m_row[r >> 1]);
          s[j][r] = p;
          l_row[r >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[j][r] *= corr[r >> 1];

      // O += P V: P from S's accumulators as the A fragment, in two bf16
      // parts (P = hi + lo, 16 significant bits), V by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int u = 0; u < DT / 2; ++u) {
          unsigned vf[4];
          tiles::ldmatrix_x4_trans(
              vf, vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S::ROW +
                      2 * (16 * u + (lane >> 4) * 8));
          tiles::mma_bf16_16816(o[2 * u], hi, &vf[0]);
          tiles::mma_bf16_16816(o[2 * u], lo, &vf[0]);
          tiles::mma_bf16_16816(o[2 * u + 1], hi, &vf[2]);
          tiles::mma_bf16_16816(o[2 * u + 1], lo, &vf[2]);
        }
      }
    }
    __syncthreads();   // the slot is free for the copy of tile + 2
  }
  tiles::cp_async_wait<0>();

  // the four lanes of a row hold its l in parts
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row_lo + g + 8 * h;
    if (qpos >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l_row[h], 1e-30f);
    __nv_bfloat16* op = out + (static_cast<long long>(bidx) * Sq + qpos) * H * D +
                        static_cast<long long>(h0 + gi) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<unsigned*>(op + 8 * j) =
          pack_bf16(o[j][2 * h] * inv_l, o[j][2 * h + 1] * inv_l);
  }
}

// ---- float32: CUDA cores ----

constexpr int CHUNK = 16;      // keys per online-softmax step
constexpr int MAX_GB = 4;      // query heads a CTA (BQ * MAX_GB threads)

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(BQ * MAX_GB)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int Sq,
                         int Skv, int H, int G, int GB, Strides qs, Strides ks, Strides vs,
                         float scale) {
  constexpr int D4 = D / 4;
  extern __shared__ float4 kv_tiles[];   // K then V: BK rows of D4 float4
  float4* k_tile = kv_tiles;
  float4* v_tile = kv_tiles + BK * D4;

  const int groups = G / GB;
  const int b = blockIdx.z;
  const int kh = blockIdx.y / groups;
  const int h = kh * G + (blockIdx.y % groups) * GB + threadIdx.x / BQ;
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + threadIdx.x % BQ;

  float qv[D];
  float acc[D];
  {
    const float* qp = q + b * qs.b + static_cast<long long>(min(qpos, Sq - 1)) * qs.s +
                      h * qs.h;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qv[d] = qp[d];
      acc[d] = 0.f;
    }
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
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = kb[kp * ks.s + d];
        vx = vb[kp * vs.s + d];
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
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
#pragma unroll
        for (int d4 = 0; d4 < D4; ++d4) {
          const float4 vv = v_tile[(c + jj) * D4 + d4];
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
    float* op = out + (static_cast<long long>(b) * Sq + qpos) * H * D +
                static_cast<long long>(h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv_l;
  }
}

// Query heads a CTA holds: the largest divisor of G up to `most`.
int heads_per_cta(int G, int most) {
  for (int gb = most; gb > 1; --gb)
    if (G % gb == 0) return gb;
  return 1;
}

template <int D, bool CAUSAL>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                int Skv, int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
                cudaStream_t stream) {
  const int G = H / KH;
  const int GB = heads_per_cta(G, mma_max_gb<D>());
  const int n_qblocks = (Sq + BQ - 1) / BQ;
  const int n_heads_b = B * KH * (G / GB);            // (batch, head group) pairs
  const long long blocks = static_cast<long long>(n_qblocks) * n_heads_b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_bf16_mma_kernel<D, CAUSAL>;
  // the limit is per device: set it on the current one at every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::bytes(mma_max_gb<D>()));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(blocks), GB * WARPS_PER_HEAD * 32, Smem<D>::bytes(GB),
           stream>>>(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq,
                     Skv, H, G, GB, n_qblocks, n_heads_b, qs, ks, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq,
               int Skv, int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
               cudaStream_t stream) {
  const int G = H / KH;
  const int GB = heads_per_cta(G, MAX_GB);
  const dim3 grid(static_cast<unsigned>((Sq + BQ - 1) / BQ),
                  static_cast<unsigned>(KH * (G / GB)), static_cast<unsigned>(B));
  auto kernel = flash_fwd_f32_kernel<D, CAUSAL>;
  constexpr int smem = 2 * BK * D * static_cast<int>(sizeof(float));
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, BQ * GB, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Skv, H, G, GB, qs, ks, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int D>
int dispatch(int dtype, int causal, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Skv, int H, int KH, Strides qs, Strides ks, Strides vs,
             float scale, cudaStream_t st) {
  if (dtype == 0)
    return causal ? launch_f32<D, true>(q, k, v, out, B, Sq, Skv, H, KH, qs, ks, vs, scale, st)
                  : launch_f32<D, false>(q, k, v, out, B, Sq, Skv, H, KH, qs, ks, vs, scale,
                                         st);
  // bf16: 16-byte copies of rows need 16-byte-aligned rows
  const Strides all[3] = {qs, ks, vs};
  for (const Strides& s : all)
    if (s.b % 8 || s.s % 8 || s.h % 8) return static_cast<int>(cudaErrorMisalignedAddress);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return causal ? launch_bf16<D, true>(q, k, v, out, B, Sq, Skv, H, KH, qs, ks, vs, scale, st)
                : launch_bf16<D, false>(q, k, v, out, B, Sq, Skv, H, KH, qs, ks, vs, scale,
                                        st);
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
  if (KH <= 0 || H % KH != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return dispatch<32>(dtype, causal, q, k, v, out, B, Sq, Skv, H, KH, qs, ks, vs, scale, st);
    case 64:
      return dispatch<64>(dtype, causal, q, k, v, out, B, Sq, Skv, H, KH, qs, ks, vs, scale, st);
    case 128:
      return dispatch<128>(dtype, causal, q, k, v, out, B, Sq, Skv, H, KH, qs, ks, vs, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
