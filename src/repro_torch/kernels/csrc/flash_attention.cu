// flash_attention: causal or non-causal GQA softmax attention, forward.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:
// flash_attention_fwd (_kernel). Inputs q (B, Sq, H, D), k (B, Skv, KH, D)
// and v (B, Skv, KH, Dv), float32 or bf16, read through their (b, s, h)
// element strides with a unit-stride last dim; output (B, Sq, H, Dv),
// contiguous, in q's dtype:
//
//   s    = (q . k) * scale                      scale = 1 / sqrt(D)
//   mask = kpos < Skv and, causal, qpos >= kpos   qpos = row + q_offset
//          and (window > 0) qpos - kpos < window  masked scores are -inf
//   out  = sum_k softmax(s)_k v_k                online softmax, f32 m, l, acc
//        = acc / max(l, 1e-30)
//
// The window and the query offset are the reference's (its sdpa's window
// and q_offset, which the Pallas kernel does not take), runtime ints; both
// apply only to a causal call (the C entry zeroes them otherwise), and the
// wrapper refuses a call in which some row sees no key. A causal call with
// a window runs an instantiation of its own (WINDOWED): with the window's
// masks and tests in the causal kernel itself, the causal calls without one
// ran 4-12% slower on an H100 (PERF.md, the windowed kernels).
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
// operand, once for both parts. A CTA walks only the key tiles of its rows'
// band: from the tile of the first row's band start (position q0 + q_offset
// - window + 1, windowed) to that of the last row's position (causal), so
// a window of w keys costs about (w + 64) / 64 tiles a q block however long
// the sequence. Only tiles that cross the diagonal, the band's start or the
// ragged end of Skv are masked; a warp whose 16 rows all lie above a tile,
// or whose rows' bands all start past it, skips it (all its scores would be masked:
// exp gives exact zeros and the running max does not move, so skipping
// changes no bit). The grid walks the q blocks from the last, so the long
// causal rows start before the short ones fill the gaps; with a window
// every block past the first window / 64 holds the same band, and only the
// first ones are lighter, so the order stays heaviest first (as long as the
// last rows' positions stay within Skv, q_offset <= Skv - Sq: the offset's
// use). Rows past Sq and keys past Skv are zero-filled by the
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
// The value width may differ from the query width: MLA (MiniCPM3) attends
// with q and k of 96 (64 + 32 rope) and v of 64, 48 and 32 at its smoke
// widths. Both kernels are templates on the pair (D, Dv): the Q and K rows
// are D wide and take D / 16 k-steps of Q.K^T (6 at 96), the V rows and the
// output Dv wide (Dv / 8 n8 tiles). The built pairs are (32, 32), (64, 64),
// (128, 128), (96, 64) and (48, 32); any other pair is refused. At (96, 64)
// a thread holds 24 Q registers, 32 of S and 32 of O, so a CTA holds up to 3
// heads as at D 64; MiniCPM3's 40 query heads have one KV head each (G 1), so
// its CTAs hold one head: 128 threads and 58,368 bytes of shared memory
// (64 Q rows and two stages of 64 K rows of 208 bytes and 64 V rows of 144).
// Its prefill (B 4, S 1024) is bound by bytes, not operations: 26.9 GFLOP
// on 105 MB, 0.031 ms at 3.35 TB/s; with G 1 no K/V tile serves two heads,
// so each CTA streams its head's keys once per q block, mostly from L2.
//
// float32 (flash_attention_f32.cu, its own translation unit, which nvcc
// compiles beside this one): the tensor cores too, in this kernel's layout
// of the work, every operand in two tf32 parts and each product three
// mma.sync m16n8k8 tf32 products (3xTF32). One bf16 or TF32 part would miss
// the float32 tolerance, 2e-5, and so would two bf16 parts; its header says
// why and what the card measured.
//
// bf16 calls with at most flash::DECODE_ROWS (16) query rows a KV head
// (Sq * G: a decode step's cross attention) take the split-KV decode route
// instead (flash_attention_decode.cu, its own translation unit): at one
// query this kernel keeps one warp a CTA busy and leaves most SMs idle. The
// wrapper decides the route and the split count from the shapes and passes
// the route's float32 workspace; the entry below checks that the two agree.
//
// Training (flash_attention_bwd.cu) needs each row's log-sum-exp: when the
// caller passes an lse pointer, both kernels also write, once a row after
// its last reduction, m + log(max(l, 1e-30)) in the natural domain (the
// reference's lse; both kernels keep the max in the exp2 domain, times
// ln 2). The output is the same with or without it.
//
// Numbers. The running max starts at the finite -1e30 and masked scores are
// -inf, so a masked key's weight is exp2(-inf) = 0 exactly, also in a tile
// whose keys a row cannot see before it has seen any (a windowed row's
// tiles before its band: its max stays -1e30 and its sums 0). A row that has
// seen a key gets the same bits as with the TPU kernel's finite -1e30 for
// masked scores. Sums run in a fixed order with no atomics: the result is
// deterministic, so two runs of one prompt agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace {

using flash::BK;
using flash::BQ;
using flash::NEG;
using flash::Strides;
using tiles::pack_bf16;
using tiles::split_bf16;

// ---- bf16: tensor cores ----

// query heads a CTA: 3 up to (96, 64), 2 at D = 128 (registers, above)
template <int D, int DV>
constexpr int mma_max_gb() { return D + DV > 192 ? 2 : 3; }
constexpr int WARPS_PER_HEAD = BQ / 16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Padded rows (an odd number of 16-byte units: ldmatrix reads them without
// bank conflicts) of q and K (D wide) and of V (DV wide).
template <int D, int DV>
struct Smem {
  static constexpr int ROW = 2 * D + 16;      // q and K row, bytes
  static constexpr int VROW = 2 * DV + 16;    // V row, bytes
  static constexpr int CHUNKS = 2 * D / 16;   // 16-byte chunks a q or K row
  static constexpr int VCHUNKS = 2 * DV / 16; // ... a V row
  static constexpr int KTILE = BK * ROW;
  static constexpr int STAGE = KTILE + BK * VROW;   // K then V
  // q rows of GB heads, then K and V of two stages
  static constexpr int bytes(int GB) { return GB * BQ * ROW + 2 * STAGE; }
};

// K then V of keys [k0, k0 + BK) into one stage (K at 0, V at KTILE)
template <int D, int DV>
__device__ __forceinline__ void load_kv(char* stage, const __nv_bfloat16* kb,
                                        const __nv_bfloat16* vb, Strides ks, Strides vs,
                                        int k0, int Skv, int nthreads) {
  using S = Smem<D, DV>;
  constexpr int KN = BK * S::CHUNKS;
  for (int e = threadIdx.x; e < KN + BK * S::VCHUNKS; e += nthreads) {
    const bool is_v = e >= KN;
    const int chunks = is_v ? S::VCHUNKS : S::CHUNKS;
    const int rem = is_v ? e - KN : e;
    const int row = rem / chunks, c = rem % chunks;
    const int kp = k0 + row;
    const bool ok = kp < Skv;
    const __nv_bfloat16* src =
        is_v ? vb + (ok ? kp : 0) * vs.s + 8 * c : kb + (ok ? kp : 0) * ks.s + 8 * c;
    char* dst = is_v ? stage + S::KTILE + row * S::VROW : stage + row * S::ROW;
    tiles::cp_async16(dst + 16 * c, src, ok);
  }
}

template <int D, int DV, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(mma_max_gb<D, DV>() * WARPS_PER_HEAD * 32, 1)
    flash_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                              int Sq, int Skv, int H, int G,
                              int GB, int n_qblocks, int n_heads_b, int q_off, int win,
                              Strides qs, Strides ks, Strides vs, float scale) {
  using S = Smem<D, DV>;
  constexpr int DT = DV / 8;    // n8 tiles of the output
  constexpr int DK = D / 16;    // k16 steps of Q.K^T
  constexpr int NT = BK / 8;    // n8 tiles of S
  extern __shared__ __align__(128) char smem[];
  char* qbuf = smem;
  char* kvbuf = smem + GB * BQ * S::ROW;  // stage s at s STAGE: K, then V

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
  const int t_lo = kv_lo / BK;
  const int t_hi = (kv_end + BK - 1) / BK;
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
  if (t_lo < t_hi) load_kv<D, DV>(kvbuf, kb, vb, ks, vs, t_lo * BK, Skv, nthreads);
  tiles::cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_row[2] = {NEG, NEG}, l_row[2] = {0.f, 0.f};   // rows g, g + 8 (l per lane)
  unsigned qf[DK][4];
  const float sl2 = scale * LOG2E;
  const int row_lo = q0 + p0;                          // the warp's first row
  const int pos_lo = row_lo + q_off;                   // ... and its position
  const bool warp_live = row_lo < Sq;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * BK;
    const int slot = (tile - t_lo) & 1;
    if (tile + 1 < t_hi)
      load_kv<D, DV>(kvbuf + (slot ^ 1) * S::STAGE, kb, vb, ks, vs, k0 + BK, Skv, nthreads);
    tiles::cp_async_commit();
    tiles::cp_async_wait<1>();   // tile `tile` (and q) have landed
    __syncthreads();
    if (tile == t_lo) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        tiles::ldmatrix_x4(qf[kk], qbuf + (gi * BQ + p0 + (lane & 15)) * S::ROW +
                                       2 * (16 * kk + (lane >> 4) * 8));
    }
    // every row of the warp above the tile, or its band starting past the
    // tile's last key
    const bool skip = !warp_live || (CAUSAL && k0 > pos_lo + 15) ||
                      (windowed && k0 + BK - 1 <= pos_lo - win);
    if (!skip) {
      const char* kt = kvbuf + slot * S::STAGE;
      const char* vt = kt + S::KTILE;

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
      const bool masked = k0 + BK > Skv || (CAUSAL && k0 + BK - 1 > pos_lo) ||
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
              vf, vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S::VROW +
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
    __nv_bfloat16* op = out + (static_cast<long long>(bidx) * Sq + qpos) * H * DV +
                        static_cast<long long>(h0 + gi) * DV + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<unsigned*>(op + 8 * j) =
          pack_bf16(o[j][2 * h] * inv_l, o[j][2 * h + 1] * inv_l);
    // the row's log-sum-exp in the natural domain, once a row (every lane
    // of the quad holds the reduced l and the same max)
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(bidx) * Sq + qpos) * H + h0 + gi] =
          m_row[h] * LN2 + logf(fmaxf(l_row[h], 1e-30f));
  }
}

template <int D, int DV, bool CAUSAL, bool WINDOWED>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Sq, int Skv, int H, int KH, int q_off, int win, Strides qs, Strides ks,
                Strides vs, float scale, cudaStream_t stream) {
  const int G = H / KH;
  const int GB = flash::heads_per_cta(G, mma_max_gb<D, DV>());
  const int n_qblocks = (Sq + BQ - 1) / BQ;
  const int n_heads_b = B * KH * (G / GB);            // (batch, head group) pairs
  const long long blocks = static_cast<long long>(n_qblocks) * n_heads_b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_bf16_mma_kernel<D, DV, CAUSAL, WINDOWED>;
  using S = Smem<D, DV>;
  // the limit is per device: set it on the current one at every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes(mma_max_gb<D, DV>()));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(blocks), GB * WARPS_PER_HEAD * 32, S::bytes(GB),
           stream>>>(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
                     Sq, Skv, H, G, GB, n_qblocks, n_heads_b, q_off, win, qs, ks, vs,
                     scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int dispatch(int dtype, int causal, int q_off, int win, const void* q, const void* k,
             const void* v, void* out, float* lse, float* ws, int B, int Sq, int Skv, int H,
             int KH, int splits, Strides qs, Strides ks, Strides vs, float scale,
             cudaStream_t st) {
  if (!flash::rows_aligned16(q, k, v, qs, ks, vs, dtype == 0 ? 4 : 2))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == 0)
    return flash::launch_f32(D, DV, causal, q_off, win, q, k, v, out, lse, B, Sq, Skv, H, KH,
                             qs, ks, vs, scale, st);
  if (splits > 0)
    return flash::launch_decode(D, DV, causal, q_off, win, q, k, v, out, lse, ws, B, Sq, Skv,
                                H, KH, splits, qs, ks, vs, scale, st);
  if (!causal)
    return launch_bf16<D, DV, false, false>(q, k, v, out, lse, B, Sq, Skv, H, KH, 0, 0, qs, ks,
                                            vs, scale, st);
  return win > 0 ? launch_bf16<D, DV, true, true>(q, k, v, out, lse, B, Sq, Skv, H, KH, q_off,
                                                  win, qs, ks, vs, scale, st)
                 : launch_bf16<D, DV, true, false>(q, k, v, out, lse, B, Sq, Skv, H, KH, q_off,
                                                   0, qs, ks, vs, scale, st);
}

}  // namespace

// dtype: 0 float32, 1 bf16. D is the width of q and k, Dv of v and the output;
// (D, Dv) must be a built pair. Strides are in elements; the starts of q, k
// and v and their (b, s, h) strides must be multiples of 16 bytes. ``lse``,
// when not null, receives each row's float32 log-sum-exp (B, Sq, H), the
// residual of the backward (flash_attention_bwd.cu); the output is the same
// either way. ``q_offset`` >= 0 and ``window`` >= 0 (0: none) apply to a
// causal call only (flash::band); every row must see a key. A bf16 call with Sq * (H / KH) <= flash::DECODE_ROWS takes the
// decode route and must come with ``splits`` > 0 and the float32 workspace
// ``ws`` of B KH splits Sq (H / KH) (Dv + 2) floats; every other call with
// 0 and null.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, void* lse, void* ws, int dtype, int B, int Sq,
                                     int Skv, int H, int KH, int D, int Dv, int causal,
                                     int q_offset, int window, int splits, long long qsb, long long qss, long long qsh,
                                     long long ksb, long long kss, long long ksh,
                                     long long vsb, long long vss, long long vsh, float scale,
                                     void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (KH <= 0 || H % KH != 0 || (dtype != 0 && dtype != 1) || q_offset < 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!causal) q_offset = window = 0;
  const bool decode =
      dtype == 1 && static_cast<long long>(Sq) * (H / KH) <= flash::DECODE_ROWS;
  if (decode != (splits > 0) || (splits > 0) != (ws != nullptr) || splits < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_PAIR(DQ, DVV)                                                           \
  if (D == DQ && Dv == DVV)                                                               \
    return dispatch<DQ, DVV>(dtype, causal, q_offset, window, q, k, v, out,               \
                             static_cast<float*>(lse), static_cast<float*>(ws), B, Sq, Skv, \
                             H, KH, splits, qs, ks, vs, scale, st);
  REPRO_FLASH_PAIRS(REPRO_FLASH_PAIR)
#undef REPRO_FLASH_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
