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
// Masks as the forward's: causal is qpos >= kpos with qpos = row + q_offset
// and, with window > 0, qpos - kpos < window (the reference's sliding window
// and query offset, runtime ints that apply to a causal call only); keys
// past Skv and rows past Sq are zero-filled and never stored.
//
// Three launches a call, one C entry: (1) Drow, one warp a row; (2) dK and
// dV, one CTA per (key tile of 64, KV head, batch), which walks the query
// tiles that see its keys (causal: from its own tile on) for each of its G
// query heads and keeps dK and dV in registers; (3) dQ, one CTA per (query
// tile of 64, query head (float32: a group of them), batch), which walks the
// key tiles its rows see (causal: up to the diagonal) and keeps dQ in
// registers. A causal call with a window or a query offset runs windowed
// instantiations of both passes (WINDOWED), as the forward does: with the
// band's masks and tests in the causal kernels, the causal forward ran 4-12%
// slower on an H100 (PERF.md, the windowed kernels). They walk only the
// band: the dK/dV CTA the query tiles whose rows see its keys, [max(0, k0 -
// q_offset) / 64, (k0 + 62 + window - q_offset) / 64] with a window (up to
// the last without), the dQ CTA the key tiles from its first row's band
// start to its last row's position; only tiles that cross the diagonal or a
// band start are masked, and a key that no row sees gets dK = dV = 0. Each
// recomputes P and dS from the saved lse, as the reference's bwd does, so no
// (Sq, Skv) matrix reaches device memory. Every output element is written
// once after a sum in a fixed order: no atomics, so a training step is
// bit-for-bit repeatable. (One pass that wrote per-key-tile dQ partials for
// a reduction would move ~160 MB at the training shape below, about the
// time of a whole backward; the dQ pass's second S and dP cost ~10 GFLOP of
// tensor-core work instead.)
//
// Bound on the H100: operations. The backward needs 2 (3 D + 2 Dv) flops a
// (query, key) pair the mask lets through; at SmolLM's training shape (B 8,
// S 1024, 9/3 heads of 64, causal) that is 24.2 GFLOP on 51 MB (101 MB in
// float32): 0.0245 ms on the bf16 tensor cores; in float32 0.3609 ms on the
// CUDA cores or 0.1467 ms as three TF32 products a multiply-add (3xTF32) on
// the tensor cores, the bound being the smaller.
//
// bf16: the tensor cores, mma.sync m16n8k16 (bf16 in, f32 sums), with the
// forward's building blocks (mma_tiles.cuh). A CTA is 4 warps; both grids
// are one-dimensional with the tile index slowest, so under a causal mask
// the heaviest tiles of every (head, batch) start first: the dK/dV pass's
// work per CTA falls with its key tile, and with every CTA resident at once
// at the training shape, the order decides how evenly the SMs are loaded.
// Pass (2): K and V of the CTA's 64 keys stay in shared memory as bf16 (rows
// padded by 16 bytes, so ldmatrix reads them without bank conflicts); each
// warp owns 16 keys and, up to D + Dv = 192, holds their K and V rows as A
// fragments in registers (at D 128 it reads them again from shared memory
// for each chunk: dK and dV alone then take 128 registers a thread), so no
// width needs a query tile below 64. Q and dO tiles
// of 64 query rows, with their lse and Drow, arrive through a two-stage
// cp.async ring (zero-fill past Sq), the next tile in flight while this one
// is multiplied. A warp walks each tile in chunks of 16 queries, so S^T and
// dP^T stay 16 x 16 (8 floats a thread each):
//   S^T  = K Q^T      Q read by ldmatrix as the B operand (as the forward
//   dP^T = V dO^T     reads K), dO likewise;
//   P^T  = exp2(S^T scale log2e - lse log2e), masked only on chunks that
//          cross the diagonal or a ragged edge, skipped where all masked;
//   dS^T = P^T (dP^T - Drow) scale;
//   dV  += P^T dO, dK += dS^T Q, P^T and dS^T repacked from their
//          accumulators into A fragments, dO and Q read by ldmatrix.trans as
//          the B operand (as the forward reads V).
// Pass (3): each warp owns 16 query rows, holds their Q and dO as A
// fragments, and walks the key tiles (K and V through the same kind of ring)
// in chunks of 16 keys: S = Q K^T, dP = dO V^T, dS, dQ += dS K with K read
// by ldmatrix.trans; a warp whose rows all lie above a chunk skips it.
//
// Precision: P^T and dS^T (pass 2) and dS (pass 3) enter their products in
// two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), as the forward repacks
// P: ~16 significant bits, so each gradient's only coarse rounding is its
// final bf16 store, as in the reference's float32 bwd. Each of dV, dK and dQ
// takes two products for it; the design executes 12 D + 8 Dv flops a pair
// (1280 at D = Dv = 64, twice the bound's count). Q, K, V and dO are bf16
// already and enter exactly. The split ships: one bf16 part puts a 2^-9
// relative error on every P and dS, of the order of the final rounding
// itself (tests/test_torch_flash_bwd_split.py models both on the CPU and
// records each one's error).
//
// float32 (flash_attention_bwd_f32.cu, its own translation unit): the tensor
// cores too, mma.sync m16n8k8 tf32 in 3xTF32 (every operand as a tf32 big and
// small part, three products a multiply-add), in the same three launches and
// the same two grids, with every tensor-core sum kept to a short chain and
// merged into float32 by one FADD: the float32 gradients hold 1e-5 of the
// plain version. Its header gives the design, the budget of shared memory
// and registers, and the precision; tests/test_torch_flash_bwd_f32_split.py
// models its roundings on the CPU. One bf16 or tf32 part would miss 1e-5.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace {

using flash::Strides;

constexpr int BT = 64;          // query rows and keys a tile (bf16)
constexpr int ROWDOT_WARPS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

constexpr int MMA_THREADS = 128;   // 4 warps, 16 keys (pass 2) or query rows (3) each
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout of the bf16 kernels: Q and K rows D wide, dO and V
// rows Dv wide, each padded by 16 bytes (an odd number of 16-byte units).
template <int D, int DV>
struct BwdSmem {
  static constexpr int ROW = 2 * D + 16;
  static constexpr int VROW = 2 * DV + 16;
  static constexpr int TILE = BT * ROW;       // a Q or K tile
  static constexpr int VTILE = BT * VROW;     // a dO or V tile
  // pass 2: K and V resident, then two stages of Q, dO, lse and Drow
  static constexpr int STAGE = TILE + VTILE + 2 * BT * 4;
  static constexpr int DKDV = TILE + VTILE + 2 * STAGE;
  // pass 3: Q and dO, then two stages of K and V
  static constexpr int DQ = 3 * (TILE + VTILE);
};

// rows [r0, r0 + BT) of one (batch, head) slice, W wide, into padded rows;
// rows past S are zero-filled (source size 0)
template <int W>
__device__ __forceinline__ void copy_rows(char* dst, const __nv_bfloat16* base,
                                          long long s_stride, int r0, int S) {
  constexpr int CH = 2 * W / 16, RB = 2 * W + 16;
  for (int e = threadIdx.x; e < BT * CH; e += MMA_THREADS) {
    const int r = e / CH, c = e % CH;
    const int pos = r0 + r;
    const bool ok = pos < S;
    tiles::cp_async16(dst + r * RB + 16 * c, base + (ok ? pos : 0) * s_stride + 8 * c, ok);
  }
}

// lse then Drow of rows [q0, q0 + BT) of head h ((B, Sq, H) float32, at
// `at` = (b Sq) H + h) into 2 BT floats; rows past Sq are zero
__device__ __forceinline__ void copy_stats(float* dst, const float* __restrict__ lse,
                                           const float* __restrict__ drow, long long at,
                                           int H, int q0, int Sq) {
  for (int e = threadIdx.x; e < 2 * BT; e += MMA_THREADS) {
    const int r = e % BT, pos = q0 + r;
    const bool ok = pos < Sq;
    const long long src = at + static_cast<long long>(ok ? pos : 0) * H;
    tiles::cp_async4(dst + e, (e < BT ? lse : drow) + src, ok);
  }
}

// The A fragment (16 x 16, row-major) of 16 rows at `rows` (row stride RB
// bytes), columns [16 kk, 16 kk + 16)
template <int RB>
__device__ __forceinline__ void load_a(unsigned a[4], const char* rows, int kk, int lane) {
  tiles::ldmatrix_x4(a, rows + (lane & 15) * RB + 2 * (16 * kk + (lane >> 4) * 8));
}

// B fragments of two n8 tiles: n = rows [n0, n0 + 16) of a row-major tile
// whose columns are k, at k-step kk (as the forward reads K)
template <int RB>
__device__ __forceinline__ void load_b(unsigned b[4], const char* tile, int n0, int kk,
                                       int lane) {
  tiles::ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * RB +
                            2 * (16 * kk + ((lane >> 3) & 1) * 8));
}

// B fragments of two n8 tiles (columns [16 u, 16 u + 16)) at the k-step of
// rows [k0, k0 + 16) of a row-major tile whose rows are k (as the forward
// reads V)
template <int RB>
__device__ __forceinline__ void load_b_trans(unsigned b[4], const char* tile, int k0, int u,
                                             int lane) {
  tiles::ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RB +
                                  2 * (16 * u + (lane >> 4) * 8));
}

// acc[n] += (hi + lo) B over the NT n8 tiles, B by ldmatrix.trans from the
// 16 rows at k0 of `tile`
template <int NT, int RB>
__device__ __forceinline__ void mma_split(float (*acc)[4], const unsigned hi[4],
                                          const unsigned lo[4], const char* tile, int k0,
                                          int lane) {
#pragma unroll
  for (int u = 0; u < NT / 2; ++u) {
    unsigned b[4];
    load_b_trans<RB>(b, tile, k0, u, lane);
    tiles::mma_bf16_16816(acc[2 * u], hi, &b[0]);
    tiles::mma_bf16_16816(acc[2 * u], lo, &b[0]);
    tiles::mma_bf16_16816(acc[2 * u + 1], hi, &b[2]);
    tiles::mma_bf16_16816(acc[2 * u + 1], lo, &b[2]);
  }
}

// a 16 x 16 accumulator pair (two n8 tiles) as hi and lo A fragments
__device__ __forceinline__ void split_a(const float x[2][4], unsigned hi[4], unsigned lo[4]) {
  tiles::split_bf16(x[0][0], x[0][1], hi[0], lo[0]);
  tiles::split_bf16(x[0][2], x[0][3], hi[1], lo[1]);
  tiles::split_bf16(x[1][0], x[1][1], hi[2], lo[2]);
  tiles::split_bf16(x[1][2], x[1][3], hi[3], lo[3]);
}

// rows of a (16-row) accumulator as packed bf16 pairs: row (g + 8 half) of
// n8 tile j goes to dst + row_at(g + 8 half) + 8 j + 2 t
template <int NT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (*acc)[4], int half,
                                           int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    *reinterpret_cast<unsigned*>(dst + 8 * j + 2 * t) =
        tiles::pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
}

// Pass 2: dK and dV of one (key tile, KV head, batch).
template <int D, int DV, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ drow,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int B, int Sq, int Skv, int H, int KH, int q_off, int win,
                              Strides qs, Strides ks, Strides vs, float scale) {
  using S = BwdSmem<D, DV>;
  constexpr bool KV_REG = D + DV <= 192;   // K and V A fragments in registers
  constexpr int DK = D / 16, VK = DV / 16;  // k16 steps of S^T and dP^T
  extern __shared__ __align__(128) char smem[];
  char* Kt = smem;
  char* Vt = smem + S::TILE;
  char* ring = Vt + S::VTILE;

  // key tiles slowest: the low ones, which see the most query tiles under a
  // causal mask, start first for every (KV head, batch)
  const int kt = static_cast<int>(blockIdx.x) / (KH * B);
  const int kh = static_cast<int>(blockIdx.x) % KH, b = static_cast<int>(blockIdx.x) / KH % B;
  const int k0 = kt * BT;
  const int G = H / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 16 * warp;              // the warp's first key
  const bool warp_live = kw0 < Skv;

  // a windowed call (causal, a window or an offset) has a kernel of its
  // own: the causal kernel keeps its code (qo = w = 0 fold away there)
  constexpr bool windowed = CAUSAL && WINDOWED;
  const int qo = windowed ? q_off : 0;         // row i stands at position i + qo
  const int w = windowed ? win : 0;            // 0: no window
  const int n_qt = (Sq + BT - 1) / BT;
  // the query tiles whose rows see some of these keys: rows from k0 - qo on
  // (causal: from the key tile's own), and with a window up to k0 + BT - 2 +
  // w - qo; the causal kernel keeps its own expression, so its code is the
  // same as without the window
  const int qt_first = windowed ? max(k0 - qo, 0) / BT : CAUSAL ? kt : 0;
  const int last_row = k0 + BT - 2 + w - qo;
  const int qt_end =
      windowed && w > 0 ? (last_row < 0 ? 0 : min(n_qt, last_row / BT + 1)) : n_qt;
  const int per_head = max(qt_end - qt_first, 0);
  const int n_items = G * per_head;            // (head, query tile) pairs, heads outer
  const long long do_s = static_cast<long long>(H) * DV;   // dO's row stride
  const __nv_bfloat16* dob = dout + static_cast<long long>(b) * Sq * do_s;

  auto load_item = [&](int i, char* st) {
    const int h = kh * G + i / per_head;
    const int q0 = (qt_first + i % per_head) * BT;
    copy_rows<D>(st, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
    copy_rows<DV>(st + S::TILE, dob + h * DV, do_s, q0, Sq);
    copy_stats(reinterpret_cast<float*>(st + S::TILE + S::VTILE), lse, drow,
               static_cast<long long>(b) * Sq * H + h, H, q0, Sq);
  };
  copy_rows<D>(Kt, k + b * ks.b + kh * ks.h, ks.s, k0, Skv);
  copy_rows<DV>(Vt, v + b * vs.b + kh * vs.h, vs.s, k0, Skv);
  if (n_items > 0) load_item(0, ring);
  tiles::cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[j][r] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dv_acc[j][r] = 0.f;
  unsigned kf[KV_REG ? DK : 1][4], vf[KV_REG ? VK : 1][4];
  const char* krows = Kt + 16 * warp * S::ROW;
  const char* vrows = Vt + 16 * warp * S::VROW;
  const float sl2 = scale * LOG2E;

  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) load_item(i + 1, ring + ((i + 1) & 1) * S::STAGE);
    tiles::cp_async_commit();
    tiles::cp_async_wait<1>();   // item i (and K, V) have landed
    __syncthreads();
    if constexpr (KV_REG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) load_a<S::ROW>(kf[kk], krows, kk, lane);
#pragma unroll
        for (int kk = 0; kk < VK; ++kk) load_a<S::VROW>(vf[kk], vrows, kk, lane);
      }
    }
    const int q0 = (qt_first + i % per_head) * BT;
    const char* Qs = ring + (i & 1) * S::STAGE;
    const char* dOs = Qs + S::TILE;
    const float* lse_s = reinterpret_cast<const float*>(dOs + S::VTILE);
    const float* drow_s = lse_s + BT;
    if (warp_live && (!CAUSAL || kw0 < q0 + BT + qo)) {
#pragma unroll 1
      for (int c = 0; c < BT / 16; ++c) {
        const int qc = q0 + 16 * c;
        if (qc >= Sq) break;
        // every pair of the chunk masked: its keys after its queries, or
        // before every query's window
        if (CAUSAL && kw0 > qc + 15 + qo) continue;
        if (windowed && w > 0 && qc + qo - kw0 - 15 >= w) continue;
        // S^T = K Q^T and dP^T = V dO^T over the chunk's 16 queries
        float s[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[j][r] = dp[j][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          unsigned a[4], bq[4];
          if constexpr (KV_REG) {
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = kf[kk][r];
          } else {
            load_a<S::ROW>(a, krows, kk, lane);
          }
          load_b<S::ROW>(bq, Qs, 16 * c, kk, lane);
          tiles::mma_bf16_16816(s[0], a, &bq[0]);
          tiles::mma_bf16_16816(s[1], a, &bq[2]);
        }
#pragma unroll
        for (int kk = 0; kk < VK; ++kk) {
          unsigned a[4], bo[4];
          if constexpr (KV_REG) {
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = vf[kk][r];
          } else {
            load_a<S::VROW>(a, vrows, kk, lane);
          }
          load_b<S::VROW>(bo, dOs, 16 * c, kk, lane);
          tiles::mma_bf16_16816(dp[0], a, &bo[0]);
          tiles::mma_bf16_16816(dp[1], a, &bo[2]);
        }
        // P^T and dS^T: row (key) kw0 + g + 8 (r >> 1), column (query)
        // qc + 8 j + 2 t + (r & 1)
        const bool masked = qc + 16 > Sq || kw0 + 16 > Skv || (CAUSAL && kw0 + 15 > qc + qo) ||
                            (windowed && w > 0 && qc + 15 + qo - kw0 >= w);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * c + 8 * j + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 dr = *reinterpret_cast<const float2*>(drow_s + col);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float lrow = (r & 1) ? l2.y : l2.x;
            const float drr = (r & 1) ? dr.y : dr.x;
            float p = exp2f(fmaf(s[j][r], sl2, -lrow * LOG2E));
            if (masked) {
              const int row = q0 + col + (r & 1);
              const int kpos = kw0 + g + 8 * (r >> 1);
              if (row >= Sq || kpos >= Skv || (CAUSAL && kpos > row + qo) ||
                  (windowed && w > 0 && row + qo - kpos >= w))
                p = 0.f;
            }
            s[j][r] = p;
            dp[j][r] = p * (dp[j][r] - drr) * scale;
          }
        }
        // dV += P^T dO and dK += dS^T Q, each operand in two bf16 parts
        unsigned hi[4], lo[4];
        split_a(s, hi, lo);
        mma_split<DV / 8, S::VROW>(dv_acc, hi, lo, dOs, 16 * c, lane);
        split_a(dp, hi, lo);
        mma_split<D / 8, S::ROW>(dk_acc, hi, lo, Qs, 16 * c, lane);
      }
    }
    __syncthreads();   // the stage is free for the copy of item i + 2
  }
  tiles::cp_async_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = kw0 + g + 8 * half;
    if (kpos >= Skv) continue;
    const long long row = (static_cast<long long>(b) * Skv + kpos) * KH + kh;
    store_rows<D / 8>(dk + row * D, dk_acc, half, t);
    store_rows<DV / 8>(dv + row * DV, dv_acc, half, t);
  }
}

// Pass 3: dQ of one (query tile, query head, batch).
template <int D, int DV, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ drow,
                            __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int H,
                            int KH, int n_qt, int q_off, int win, Strides qs, Strides ks,
                            Strides vs, float scale) {
  using S = BwdSmem<D, DV>;
  constexpr int DK = D / 16, VK = DV / 16;
  extern __shared__ __align__(128) char smem[];
  char* Qs = smem;
  char* dOs = smem + S::TILE;
  char* ring = dOs + S::VTILE;                 // stage s at s (TILE + VTILE): K, then V
  constexpr int STAGE = S::TILE + S::VTILE;

  // query tiles slowest, heaviest (last) first for every (head, batch)
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int h = static_cast<int>(blockIdx.x) % H, b = static_cast<int>(blockIdx.x) / H % B;
  const int kh = h / (H / KH);
  const int q0 = qt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;               // the warp's first row
  const bool warp_live = r0 < Sq;
  const long long do_s = static_cast<long long>(H) * DV;

  // the key tiles of the rows' band: from the first row's band start
  // (windowed) to the last row's position (causal)
  constexpr bool windowed = CAUSAL && WINDOWED;
  const int qo = windowed ? q_off : 0;         // row i stands at position i + qo
  const int w = windowed ? win : 0;            // 0: no window
  const int q_last = min(q0 + BT, Sq) - 1;
  const int kv_end = CAUSAL ? min(Skv, q_last + qo + 1) : Skv;
  const int t_lo = windowed && w > 0 ? max(0, q0 + qo - w + 1) / BT : 0;
  const int n_kt = (kv_end + BT - 1) / BT;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  copy_rows<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  copy_rows<DV>(dOs, dout + static_cast<long long>(b) * Sq * do_s + h * DV, do_s, q0, Sq);
  if (t_lo < n_kt) {
    copy_rows<D>(ring, kb, ks.s, t_lo * BT, Skv);
    copy_rows<DV>(ring + S::TILE, vb, vs.s, t_lo * BT, Skv);
  }
  tiles::cp_async_commit();

  // lse (exp2 domain) and Drow of rows r0 + g (lo) and r0 + g + 8 (hi)
  const long long at = (static_cast<long long>(b) * Sq + r0 + g) * H + h;
  const bool lo_ok = r0 + g < Sq, hi_ok = r0 + g + 8 < Sq;
  const float l2_lo = lo_ok ? lse[at] * LOG2E : 0.f;
  const float l2_hi = hi_ok ? lse[at + 8LL * H] * LOG2E : 0.f;
  const float dr_lo = lo_ok ? drow[at] : 0.f;
  const float dr_hi = hi_ok ? drow[at + 8LL * H] : 0.f;
  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq_acc[j][r] = 0.f;
  unsigned qf[DK][4], of[VK][4];
  const float sl2 = scale * LOG2E;

  for (int tile = t_lo; tile < n_kt; ++tile) {
    const int k0 = tile * BT;
    if (tile + 1 < n_kt) {
      char* st = ring + ((tile - t_lo + 1) & 1) * STAGE;
      copy_rows<D>(st, kb, ks.s, k0 + BT, Skv);
      copy_rows<DV>(st + S::TILE, vb, vs.s, k0 + BT, Skv);
    }
    tiles::cp_async_commit();
    tiles::cp_async_wait<1>();   // tile `tile` (and Q, dO) have landed
    __syncthreads();
    if (tile == t_lo) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) load_a<S::ROW>(qf[kk], Qs + 16 * warp * S::ROW, kk, lane);
#pragma unroll
      for (int kk = 0; kk < VK; ++kk)
        load_a<S::VROW>(of[kk], dOs + 16 * warp * S::VROW, kk, lane);
    }
    const char* Ks = ring + ((tile - t_lo) & 1) * STAGE;
    const char* Vs = Ks + S::TILE;
    if (warp_live) {
#pragma unroll 1
      for (int c = 0; c < BT / 16; ++c) {
        const int kc = k0 + 16 * c;
        if (kc >= Skv || (CAUSAL && kc > r0 + 15 + qo)) break;   // so are the later chunks
        if (windowed && w > 0 && r0 + qo - kc - 15 >= w) continue;   // before every window
        // S = Q K^T and dP = dO V^T over the chunk's 16 keys
        float s[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[j][r] = dp[j][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          unsigned bk[4];
          load_b<S::ROW>(bk, Ks, 16 * c, kk, lane);
          tiles::mma_bf16_16816(s[0], qf[kk], &bk[0]);
          tiles::mma_bf16_16816(s[1], qf[kk], &bk[2]);
        }
#pragma unroll
        for (int kk = 0; kk < VK; ++kk) {
          unsigned bv[4];
          load_b<S::VROW>(bv, Vs, 16 * c, kk, lane);
          tiles::mma_bf16_16816(dp[0], of[kk], &bv[0]);
          tiles::mma_bf16_16816(dp[1], of[kk], &bv[2]);
        }
        // dS: row r0 + g + 8 (r >> 1), key kc + 8 j + 2 t + (r & 1)
        const bool masked = kc + 16 > Skv || r0 + 16 > Sq || (CAUSAL && kc + 15 > r0 + qo) ||
                            (windowed && w > 0 && r0 + 15 + qo - kc >= w);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float p = exp2f(fmaf(s[j][r], sl2, -((r >> 1) ? l2_hi : l2_lo)));
            if (masked) {
              const int row = r0 + g + 8 * (r >> 1);
              const int kpos = kc + 8 * j + 2 * t + (r & 1);
              if (row >= Sq || kpos >= Skv || (CAUSAL && kpos > row + qo) ||
                  (windowed && w > 0 && row + qo - kpos >= w))
                p = 0.f;
            }
            dp[j][r] = p * (dp[j][r] - ((r >> 1) ? dr_hi : dr_lo)) * scale;
          }
        // dQ += dS K, dS in two bf16 parts, K by ldmatrix.trans
        unsigned hi[4], lo[4];
        split_a(dp, hi, lo);
        mma_split<D / 8, S::ROW>(dq_acc, hi, lo, Ks, 16 * c, lane);
      }
    }
    __syncthreads();   // the stage is free for the copy of tile + 2
  }
  tiles::cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = r0 + g + 8 * half;
    if (qpos >= Sq) continue;
    store_rows<D / 8>(dq + ((static_cast<long long>(b) * Sq + qpos) * H + h) * D, dq_acc,
                      half, t);
  }
}

// the dK/dV and dQ passes of the bf16 design
template <int D, int DV, bool CAUSAL, bool WINDOWED>
int launch_bwd_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* dout, const float* lse, const float* drow,
                   __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int Sq,
                   int Skv, int H, int KH, int q_off, int win, Strides qs, Strides ks,
                   Strides vs, float scale, cudaStream_t stream) {
  using S = BwdSmem<D, DV>;
  if (Skv > 0) {
    auto kernel = flash_bwd_dkdv_mma_kernel<D, DV, CAUSAL, WINDOWED>;
    // the limit is per device: set it on the current one at every launch
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::DKDV);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long blocks = static_cast<long long>((Skv + BT - 1) / BT) * KH * B;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(blocks), MMA_THREADS, S::DKDV, stream>>>(
        q, k, v, dout, lse, drow, dk, dv, B, Sq, Skv, H, KH, q_off, win, qs, ks, vs, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Sq > 0) {
    auto kernel = flash_bwd_dq_mma_kernel<D, DV, CAUSAL, WINDOWED>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::DQ);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int n_qt = (Sq + BT - 1) / BT;
    const long long blocks = static_cast<long long>(n_qt) * H * B;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(blocks), MMA_THREADS, S::DQ, stream>>>(
        q, k, v, dout, lse, drow, dq, B, Sq, Skv, H, KH, n_qt, q_off, win, qs, ks, vs, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// (1) Drow over the B * Sq * H rows
template <typename T>
int launch_rowdot(const void* out, const void* dout, float* drow, long long rows, int DV,
                  cudaStream_t stream) {
  if (rows == 0) return 0;
  const long long blocks = (rows + ROWDOT_WARPS - 1) / ROWDOT_WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_rowdot_kernel<T><<<static_cast<unsigned>(blocks), ROWDOT_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), drow, rows, DV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bf16. D is the width of q and k, Dv of v, the output
// and dO; (D, Dv) must be a built pair. q, k and v are read through their
// (b, s, h) element strides; out, dout, lse and the outputs are contiguous;
// drow is float32 scratch of B * Sq * H. q, k, v and dout must start on 16
// bytes and q's, k's and v's strides be multiples of 16 bytes. ``q_offset``
// >= 0 and ``window`` >= 0 (0: none) as the forward took them: they apply to
// a causal call only (flash::band), and a causal call with either runs the
// windowed instantiations.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* drow, void* dq, void* dk, void* dv, int dtype,
                                         int B, int Sq, int Skv, int H, int KH, int D, int Dv,
                                         int causal, int q_offset, int window,
                                         long long qsb, long long qss,
                                         long long qsh, long long ksb, long long kss,
                                         long long ksh, long long vsb, long long vss,
                                         long long vsh, float scale, void* stream) {
  if (B == 0) return 0;
  if (KH <= 0 || H % KH != 0 || (dtype != 0 && dtype != 1) || B > 65535 || H > 65535 ||
      !flash::built_pair(D, Dv) || q_offset < 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!causal) q_offset = window = 0;
  const bool windowed = causal && (q_offset > 0 || window > 0);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  // dout is copied in 16-byte chunks of rows too (its rows are Dv wide)
  if (!(flash::rows_aligned16(q, k, v, qs, ks, vs, dtype == 1 ? 2 : 4) &&
        flash::aligned16(dout)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dr = static_cast<float*>(drow);
  const float* lp = static_cast<const float*>(lse);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const int e = dtype == 0 ? launch_rowdot<float>(out, dout, dr, rows, Dv, st)
                           : launch_rowdot<__nv_bfloat16>(out, dout, dr, rows, Dv, st);
  if (e != 0) return e;
  if (dtype == 0)
    return flash::launch_bwd_f32(D, Dv, causal != 0, q_offset, window, q, k, v, dout, lp, dr,
                                 dq, dk, dv, B, Sq, Skv, H, KH, qs, ks, vs, scale, st);
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* dop = static_cast<const bf*>(dout);
  bf* dqp = static_cast<bf*>(dq);
  bf* dkp = static_cast<bf*>(dk);
  bf* dvp = static_cast<bf*>(dv);
#define REPRO_FLASH_BWD_PAIR(DQ, DVV)                                                      \
  if (D == DQ && Dv == DVV) {                                                            \
    if (windowed)                                                                        \
      return launch_bwd_mma<DQ, DVV, true, true>(qp, kp, vp, dop, lp, dr, dqp, dkp, dvp,  \
                                                 B, Sq, Skv, H, KH, q_offset, window, qs, \
                                                 ks, vs, scale, st);                      \
    return causal ? launch_bwd_mma<DQ, DVV, true, false>(qp, kp, vp, dop, lp, dr, dqp,   \
                                                         dkp, dvp, B, Sq, Skv, H, KH, 0, \
                                                         0, qs, ks, vs, scale, st)       \
                  : launch_bwd_mma<DQ, DVV, false, false>(qp, kp, vp, dop, lp, dr, dqp,  \
                                                          dkp, dvp, B, Sq, Skv, H, KH,   \
                                                          0, 0, qs, ks, vs, scale, st);  \
  }
  REPRO_FLASH_PAIRS(REPRO_FLASH_BWD_PAIR)
#undef REPRO_FLASH_BWD_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
