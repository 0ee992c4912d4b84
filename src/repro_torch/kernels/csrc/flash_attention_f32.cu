// flash_attention_f32: the float32 kernel of flash_attention.cu (its header
// gives the function, the masking and the lse), in a translation unit of its
// own so that nvcc compiles it beside the bf16 kernel.
//
// Bound on the H100: operations. The VLM's cross attention (B 4, 1024
// queries against 1601 float32 patch keys, 32/8 heads of 128, non-causal)
// counts 107.4 GFLOP on 40 MB: 1.60 ms at the CUDA cores' 67 TFLOP/s, 0.65 ms
// for three TF32 products at the tensor cores' 495.
//
// The tensor cores with float32 accuracy: 3xTF32. Every operand x enters as
// two tf32 values, big = tf32(x) and small = tf32(x - big) (cvt.rna; 11
// significant bits each, x to ~2^-22 of |x| together), and each product is
// three mma.sync m16n8k8 tf32 products with float32 sums, dropping only
// small x small (2^-22 relative):
//
//   S   = Qb Kb^T + (Qs Kb^T + Qb Ks^T)     the small terms in a chain apart
//   O   = O corr + (Ps Vb + Pb Vs + Pb Vb)  a tile's P V in fresh sums
//   P   = exp2(S scale log2e - m)           the bf16 kernel's online softmax
//
// The tensor cores' float32 sums are not rounded to nearest (over long
// chains the card's errors were 4-8x those of the model's rounded sums), so
// the kernel keeps their chains short: S's big products in one chain and
// its small ones in another (a tile's D / 8 k-steps each), and each tile's
// P V in fresh accumulators merged into O by one FFMA. With one chain over
// all of Skv (this kernel's first form) the VLM's cross attention erred
// 5.2e-6 (max abs) and 1.2e-5 (relative Frobenius) from the plain version
// and the lse 2.6e-6; with the short chains 9.8e-7 and 1.0e-6, the lse
// 1.4e-6 (an H100 80GB HBM3 at 700 W; PERF.md row 7h).
//
// Why not bf16 parts (hi = bf16(x), lo = bf16(x - hi), three m16n8k16
// products at twice the rate): hi + lo hold 16 significant bits, so an output
// that is one key's value (the first rows of a causal block) or a score from
// one product keeps an error of 2^-17 of |v| and |q . k|.
// tests/test_torch_flash_f32_split.py models the forms on the CPU: at its
// causal shapes bf16 parts err 1.4e-5-2.3e-5 (max abs) and 1.1e-5-1.2e-5 (lse)
// from the plain version, past a quarter of the gates (2e-5, lse 1e-5) and
// at D 128 past the gates themselves; 3xTF32 errs at most 1.3e-6 and 9.5e-7
// in the lse; one tf32 or bf16 part errs 3e-4-1.4e-3 or 2e-3-9e-3.
//
// Layout of the work: the bf16 kernel's. One CTA per (q block of 64 rows,
// group of GB query heads of one KV head, batch), heaviest q blocks first;
// GB x 4 warps, a warp 16 rows of one head. A CTA walks only the key tiles
// of its rows' band (the window and the query offset as there, a windowed
// call in an instantiation of its own); a warp
// whose 16 rows all lie above a key tile, or whose rows' bands all start
// past it, skips it; only tiles that cross the diagonal, the band's start
// or the ragged end of Skv are masked; rows past Sq and keys past Skv are
// zero-filled by the copies and never stored or seen. One query (a decode
// step) runs in a 16-row tile with 15 rows unused.
//
// Shared memory, all float32 rows padded so that every read is free of bank
// conflicts: q (GB x 64 rows of D + 4 floats: ldmatrix reads 16-byte units,
// an odd number a row); one staging tile of K and V rows, the next tile's
// cp.async (16-byte copies, source size 0 past Skv) in flight while this one
// is multiplied; and the current tile split once, by all threads, into big
// and small K rows (D + 4 floats) and big and small V^T rows (BKT + 8
// floats: the PV product reads V transposed as float2 pairs). Each warp then
// reads its K fragments with ldmatrix (on 32-bit elements an 8 x 8 b16
// matrix is 8 rows of 4 floats, a lane's word (g, t): the tf32 B layout of
// K^T) and its q fragments the same way, splitting q in registers at each
// k-step: the split q does not fit beside the tiles at D 128 (neither in
// registers, 128 a thread, nor in shared memory). P goes from S's
// accumulator to PV's A fragment without a shuffle by numbering the keys of
// each k-step so that a lane's columns 2t and 2t + 1 are the fragment's
// columns t and t + 4; the V^T fragment then reads keys 2t and 2t + 1, one
// float2. Tiles of 32 keys, and 3 heads a CTA (2 at D 128): the short chains'
// accumulators (S's two, the tile's P V) then fit the 170 registers a
// thread of a 384-thread CTA (255 at D 128), with no local memory.
//
// Numbers. As in the bf16 kernel: the running max starts at the finite
// -1e30 and masked scores are -inf, so a masked key weighs exactly 0, also
// before a windowed row's band. Sums run in a fixed order with no atomics:
// two launches agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace {

using flash::BQ;
using flash::NEG;
using flash::Strides;

constexpr int WARPS_PER_HEAD = BQ / 16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int BKT = 32;        // keys a tile

// query heads a CTA (registers: the header)
template <int D, int DV>
constexpr int max_gb() { return D + DV > 192 ? 2 : 3; }

// Shared memory in floats: q, the staging tile (K rows then V rows), big K,
// small K, big V^T, small V^T.
template <int D, int DV>
struct Smem {
  static constexpr int QP = D + 4;       // q and K rows
  static constexpr int VP = DV + 4;      // staged V rows
  static constexpr int TP = BKT + 8;     // V^T rows
  static constexpr int STAGE = BKT * (QP + VP);
  static constexpr int KPART = BKT * QP;
  static constexpr int VPART = DV * TP;
  static constexpr int floats(int GB) { return GB * BQ * QP + STAGE + 2 * (KPART + VPART); }
};

// K then V rows of keys [k0, k0 + BKT) into the staging tile
template <int D, int DV>
__device__ __forceinline__ void load_kv(float* stage, const float* kb, const float* vb,
                                        Strides ks, Strides vs, int k0, int Skv, int nthreads) {
  using S = Smem<D, DV>;
  constexpr int KC = D / 4, VC = DV / 4;
  constexpr int KN = BKT * KC;
  for (int e = threadIdx.x; e < KN + BKT * VC; e += nthreads) {
    const bool is_v = e >= KN;
    const int chunks = is_v ? VC : KC;
    const int rem = is_v ? e - KN : e;
    const int row = rem / chunks, c = rem % chunks;
    const int kp = k0 + row;
    const bool ok = kp < Skv;
    const float* src =
        is_v ? vb + (ok ? kp : 0) * vs.s + 4 * c : kb + (ok ? kp : 0) * ks.s + 4 * c;
    float* dst = is_v ? stage + S::KPART + row * S::VP : stage + row * S::QP;
    tiles::cp_async16(dst + 4 * c, src, ok);
  }
}

// The staged tile into big and small K rows and big and small V^T rows.
template <int D, int DV>
__device__ __forceinline__ void split_kv(const float* stage, float* split, int nthreads) {
  using S = Smem<D, DV>;
  constexpr int KC = D / 4, VC = DV / 4;
  unsigned* kbig = reinterpret_cast<unsigned*>(split);
  unsigned* ksmall = kbig + S::KPART;
  unsigned* vbig = ksmall + S::KPART;
  unsigned* vsmall = vbig + S::VPART;
  for (int e = threadIdx.x; e < BKT * KC; e += nthreads) {
    const int off = (e / KC) * S::QP + 4 * (e % KC);
    const float4 x = *reinterpret_cast<const float4*>(stage + off);
    uint4 b, s;
    tiles::split_tf32(x.x, b.x, s.x);
    tiles::split_tf32(x.y, b.y, s.y);
    tiles::split_tf32(x.z, b.z, s.z);
    tiles::split_tf32(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(kbig + off) = b;
    *reinterpret_cast<uint4*>(ksmall + off) = s;
  }
  // a warp's lanes take consecutive keys: the staged rows are read 16 bytes
  // apart in banks, the V^T rows written one word apart
  for (int e = threadIdx.x; e < BKT * VC; e += nthreads) {
    const int key = e % BKT, c = e / BKT;
    const float4 x = *reinterpret_cast<const float4*>(stage + S::KPART + key * S::VP + 4 * c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned b, s;
      tiles::split_tf32(xs[i], b, s);
      vbig[(4 * c + i) * S::TP + key] = b;
      vsmall[(4 * c + i) * S::TP + key] = s;
    }
  }
}

template <int D, int DV, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(max_gb<D, DV>() * WARPS_PER_HEAD * 32, 1)
    flash_fwd_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out,
                             float* __restrict__ lse, int Sq, int Skv, int H, int G, int GB,
                             int n_qblocks, int n_heads_b, int q_off, int win, Strides qs,
                             Strides ks, Strides vs, float scale) {
  using S = Smem<D, DV>;
  constexpr int DT = DV / 8;    // n8 tiles of the output
  constexpr int DK = D / 8;     // k8 steps of Q.K^T
  constexpr int NT = BKT / 8;   // n8 tiles of S, k8 steps of P.V
  extern __shared__ __align__(128) float smem_f32[];
  float* qbuf = smem_f32;
  float* stage = qbuf + GB * BQ * S::QP;
  const float* kbig = stage + S::STAGE;
  const float* ksmall = kbig + S::KPART;
  const float* vbig = ksmall + S::KPART;
  const float* vsmall = vbig + S::VPART;

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

  // the key tiles of the block's band: from the first row's band start to
  // the last row's position
  // a windowed call (causal, win > 0) has a kernel of its own: the causal
  // kernel without a window keeps its code
  constexpr bool windowed = CAUSAL && WINDOWED;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = CAUSAL ? min(Skv, q_last + q_off + 1) : Skv;
  const int kv_lo = windowed ? max(0, q0 + q_off - win + 1) : 0;
  const int t_lo = kv_lo / BKT;
  const int t_hi = (kv_end + BKT - 1) / BKT;
  const float* kb = k + bidx * ks.b + kh * ks.h;
  const float* vb = v + bidx * vs.b + kh * vs.h;

  // q rows of the GB heads, then K/V tile 0: one copy group
  for (int e = threadIdx.x; e < GB * BQ * (D / 4); e += nthreads) {
    const int row = e / (D / 4), c = e % (D / 4);
    const int qpos = q0 + row % BQ;
    const bool ok = qpos < Sq;
    const float* src =
        q + bidx * qs.b + (ok ? qpos : 0) * qs.s + (h0 + row / BQ) * qs.h + 4 * c;
    tiles::cp_async16(qbuf + row * S::QP + 4 * c, src, ok);
  }
  if (t_lo < t_hi) load_kv<D, DV>(stage, kb, vb, ks, vs, t_lo * BKT, Skv, nthreads);
  tiles::cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_row[2] = {NEG, NEG}, l_row[2] = {0.f, 0.f};   // rows g, g + 8 (l per lane)
  const float sl2 = scale * LOG2E;
  const int row_lo = q0 + p0;                          // the warp's first row
  const int pos_lo = row_lo + q_off;                   // ... and its position
  const bool warp_live = row_lo < Sq;
  const float* qw = qbuf + (gi * BQ + p0) * S::QP;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * BKT;
    tiles::cp_async_wait<0>();   // tile `tile` (and q) have landed
    __syncthreads();             // ... for every thread; the split tiles are free
    split_kv<D, DV>(stage, stage + S::STAGE, nthreads);
    __syncthreads();             // the split tiles are ready, the staging tile free
    if (tile + 1 < t_hi)
      load_kv<D, DV>(stage, kb, vb, ks, vs, k0 + BKT, Skv, nthreads);
    tiles::cp_async_commit();
    // every row of the warp above the tile, or its band starting past the
    // tile's last key
    const bool skip = !warp_live || (CAUSAL && k0 > pos_lo + 15) ||
                      (windowed && k0 + BKT - 1 <= pos_lo - win);
    if (skip) continue;

    // S = Q K^T: q fragments by ldmatrix, split in registers; K rows (keys)
    // as the col-major B operand, two n8 tiles an ldmatrix_x4
    float s[NT][4], s_lo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = s_lo[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      unsigned qa[4], qbg[4], qsm[4];
      tiles::ldmatrix_x4(qa, qw + (lane & 15) * S::QP + 8 * kk + (lane >> 4) * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) tiles::split_tf32(__uint_as_float(qa[r]), qbg[r], qsm[r]);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        const int off = (16 * jj + (lane & 7) + (lane >> 4) * 8) * S::QP + 8 * kk +
                        ((lane >> 3) & 1) * 4;
        unsigned kf[4], ksf[4];
        tiles::ldmatrix_x4(kf, kbig + off);
        tiles::ldmatrix_x4(ksf, ksmall + off);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tiles::mma_tf32_1688(s_lo[2 * jj + h], qsm, &kf[2 * h]);
          tiles::mma_tf32_1688(s_lo[2 * jj + h], qbg, &ksf[2 * h]);
          tiles::mma_tf32_1688(s[2 * jj + h], qbg, &kf[2 * h]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] += s_lo[j][r];

    // scale, mask, online softmax (exp2 domain)
    const bool masked = k0 + BKT > Skv || (CAUSAL && k0 + BKT - 1 > pos_lo) ||
                        (windowed && k0 <= pos_lo + 15 - win);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[j][r] * sl2;
        if (masked) {
          const int kpos = k0 + 8 * j + 2 * t + (r & 1);
          const int qpos = pos_lo + g + 8 * (r >> 1);
          if (kpos >= Skv || (CAUSAL && (kpos > qpos || (windowed && qpos - kpos >= win))))
            x = -INFINITY;
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

    // O = O corr + P V. The tile's P V sums in fresh accumulators, merged
    // once by an FFMA: the tensor cores' float32 sums are not rounded to
    // nearest, so a chain of accumulating mma.sync over every key tile
    // would carry their error across all of Skv. k-step j = keys 8j..8j+7
    // (S's n8 tile j): the lane's keys 2t and 2t + 1 are the A fragment's
    // columns t and t + 4 and the B fragment's rows t and t + 4, one float2
    // of a V^T row
    float pv[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[n][r] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned pb[4], ps[4];
      tiles::split_tf32(s[j][0], pb[0], ps[0]);
      tiles::split_tf32(s[j][2], pb[1], ps[1]);
      tiles::split_tf32(s[j][1], pb[2], ps[2]);
      tiles::split_tf32(s[j][3], pb[3], ps[3]);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int off = (8 * n + g) * S::TP + 8 * j + 2 * t;
        const uint2 vbf = *reinterpret_cast<const uint2*>(vbig + off);
        const uint2 vsf = *reinterpret_cast<const uint2*>(vsmall + off);
        const unsigned vb2[2] = {vbf.x, vbf.y}, vs2[2] = {vsf.x, vsf.y};
        tiles::mma_tf32_1688(pv[n], ps, vb2);
        tiles::mma_tf32_1688(pv[n], pb, vs2);
        tiles::mma_tf32_1688(pv[n], pb, vb2);
      }
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[n][r] = fmaf(o[n][r], corr[r >> 1], pv[n][r]);
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
    float* op = out + (static_cast<long long>(bidx) * Sq + qpos) * H * DV +
                static_cast<long long>(h0 + gi) * DV + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(op + 8 * j) =
          make_float2(o[j][2 * h] * inv_l, o[j][2 * h + 1] * inv_l);
    // the row's log-sum-exp in the natural domain, once a row
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(bidx) * Sq + qpos) * H + h0 + gi] =
          m_row[h] * LN2 + logf(fmaxf(l_row[h], 1e-30f));
  }
}

template <int D, int DV, bool CAUSAL, bool WINDOWED>
int launch_pair(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Sq, int Skv, int H, int KH, int q_off, int win, Strides qs, Strides ks,
                Strides vs, float scale, cudaStream_t stream) {
  const int G = H / KH;
  const int GB = flash::heads_per_cta(G, max_gb<D, DV>());
  const int n_qblocks = (Sq + BQ - 1) / BQ;
  const int n_heads_b = B * KH * (G / GB);            // (batch, head group) pairs
  const long long blocks = static_cast<long long>(n_qblocks) * n_heads_b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_f32_mma_kernel<D, DV, CAUSAL, WINDOWED>;
  using S = Smem<D, DV>;
  constexpr int F = static_cast<int>(sizeof(float));
  // the limit is per device: set it on the current one at every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::floats(max_gb<D, DV>()) * F);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(blocks), GB * WARPS_PER_HEAD * 32, S::floats(GB) * F,
           stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv, H,
                     G, GB, n_qblocks, n_heads_b, q_off, win, qs, ks, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash::launch_f32(int D, int Dv, bool causal, int q_offset, int window, const void* q,
                      const void* k, const void* v, void* out, float* lse, int B, int Sq,
                      int Skv, int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
                      cudaStream_t stream) {
#define REPRO_FLASH_F32(DQ, DVV)                                                          \
  if (D == DQ && Dv == DVV)                                                             \
    return !causal ? launch_pair<DQ, DVV, false, false>(q, k, v, out, lse, B, Sq, Skv, H,  \
                                                        KH, 0, 0, qs, ks, vs, scale, stream) \
           : window > 0 ? launch_pair<DQ, DVV, true, true>(q, k, v, out, lse, B, Sq, Skv, H,  \
                                                          KH, q_offset, window, qs, ks, vs,  \
                                                          scale, stream)                     \
                        : launch_pair<DQ, DVV, true, false>(q, k, v, out, lse, B, Sq, Skv, H, \
                                                           KH, q_offset, 0, qs, ks, vs,      \
                                                           scale, stream);
  REPRO_FLASH_PAIRS(REPRO_FLASH_F32)
#undef REPRO_FLASH_F32
  return static_cast<int>(cudaErrorInvalidValue);
}
