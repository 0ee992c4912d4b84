// flash_attention_bwd_f32: the float32 passes of flash_attention_bwd.cu (its
// header gives the function, the masks, the three launches and the bound), in
// a translation unit of their own so that nvcc compiles them beside the bf16
// passes. The C entry there launches Drow for both dtypes, then these two.
//
// The tensor cores with float32 accuracy: 3xTF32, as the float32 forward
// (flash_attention_f32.cu). Every operand x enters as big = tf32(x) and
// small = tf32(x - big) (cvt.rna), and each product is three mma.sync
// m16n8k8 tf32 products with float32 sums, small x big + big x small + big x
// big, dropping only small x small (2^-22 relative):
//
//   pass 2, a warp's 16 keys against a chunk of 16 queries:
//     S^T  = K Q^T, dP^T = V dO^T
//     P^T  = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - Drow) scale
//     dV  += P^T dO, dK += dS^T Q
//   pass 3, a warp's 16 query rows against a tile of keys:
//     S = Q K^T, dP = dO V^T, P, dS as above; dQ += dS K
//
// Precision. The tensor cores' float32 sums are not rounded to nearest
// (on an H100 80GB HBM3 at 700 W the float32 forward, with one chain over
// all keys, erred 4-8x its model), and dK and dV each sum over every query
// row of G heads: 3072 rows at SmolLM's training shape, 4096 at the VLM's
// cross attention. So no chain is long.
// Every tensor-core sum starts from zero, takes two k-steps of three
// products (16 terms deep: S and dP over D or Dv, dV and dK over a chunk
// of 16 queries) or four (dQ over a tile of 32 keys; two at D 128), and
// is merged into its running float32 sum by one FADD, which rounds to
// nearest. tests/test_torch_flash_bwd_f32_split.py models these roundings
// on the CPU, each tensor-core step rounded toward zero: at its six cases
// the gradients lie within 1.91e-6 (max abs over max |g|) of the plain
// version and of the reference's custom VJP, under a quarter of the 1e-5
// gate; S's and dP's big and small products each in one chain over all of
// D (the forward's form) gave 2.47e-6, one chain a gradient 6.51e-6, and
// two bf16 parts 1.71e-5, past the gate itself.
//
// No transposed copies. An mma.sync operand whose rows must be read across
// (Q and dO as the B operand of dK and dV, K as that of dQ) is read from the
// row-major split tile with two 32-bit loads a fragment, not transposed in
// shared memory: with each k-step's keys (queries) numbered so that the
// accumulator's columns 2t and 2t + 1 are the A fragment's t and t + 4 (the
// forward's key-numbering trick, which feeds P and dS from their
// accumulators without a shuffle), the B fragment's rows t and t + 4 are
// rows 2t and 2t + 1 of the tile, and a row stride of W + 4 floats puts the
// 32 lanes' words in 32 banks (2 (W + 4) = 8 mod 32 for W a multiple of 16).
// ldmatrix reads the same rows for the other products (on 32-bit elements
// an 8 x 8 b16 matrix is 8 rows of 4 floats; W + 4 floats is an odd number
// of 16-byte units). The bytes read are those of a transposed copy; the
// shared memory is half.
//
// Pass 2 (dK, dV): one CTA per (key tile of 64, KV head, batch), key tiles
// slowest, so under a causal mask the heaviest tiles of every (head, batch)
// start first. Four warps own 16 keys each. K and V of the tile are read
// from device memory once and split into big and small rows in shared
// memory; the (head, query tile) items arrive by cp.async (rows past Sq
// zero-filled) into one staging tile, which all threads split into big and
// small Q and dO rows (with the lse and Drow) before the next item's copy
// starts. Up to D + Dv = 192 the query tile is 32 rows and the CTA 8 warps:
// warp w takes keys 16 (w % 4) and the tile's chunk w / 4, and the two
// chunks' dK and dV are added in a fixed order at the end (group 0's, then
// group 1's, through shared memory). At D 128 the tile is 16 rows and the
// CTA 4 warps. Causal: query tiles from the key tile's diagonal on; a warp
// skips a chunk that lies wholly above its keys; only chunks that cross the
// diagonal or an edge are masked.
//
// Pass 3 (dQ): the float32 forward's layout: one CTA per (q block of 64
// rows, group of GB query heads of one KV head, batch), heaviest q blocks
// first, GB x 4 warps of 16 rows; q and dO rows in shared memory, split in
// registers at each k-step; K and V tiles staged by cp.async and split once
// a tile by all threads into big and small rows; tiles of 32 keys (16 at
// D 128).
//
// Budget, per CTA (floats; 4 bytes each), with P = W + 4 a row:
//   pass 2: K and V big and small, 2 x 64 (Pk + Pv); staging, q tile x (Pk +
//     Pv) + 2 q tile; split Q and dO, 2 q tile (Pk + Pv) + 2 q tile; at D
//     128 also dV's running sums, 64 x Dv. (64, 64): 122,368 bytes;
//     (96, 64): 151,040; (128, 128): 218,880.
//   pass 3: q and dO, GB x 64 (Pk + Pv); staging, k tile (Pk + Pv); split,
//     2 k tile (Pk + Pv). (64, 64), GB 3: 156,672 bytes; (96, 64), GB 3:
//     193,536; (128, 128), GB 2, 16 keys: 185,856.
//   Registers: pass 2 holds dK and dV, (D + Dv) / 2 floats a thread (64 at
//   D 64, of a 256-thread CTA's 255), S^T and dP^T with a fresh chain's
//   sums (8 floats each), P^T's or dS^T's two parts (16); at D 128 dK
//   alone (64), dV's sums being in shared memory: beside the 128 of both,
//   the working set passed the 255 of a 128-thread CTA and spilled. Pass 3
//   holds dQ, D / 2, and a tile's S, dP and fresh sums (16 floats each at
//   32 keys) and dS's parts (32); 384 threads (GB 3) leave 168 a thread,
//   256 (GB 2 at D 128) 255. Each two k-steps of S
//   and dP are one loop iteration (not unrolled): unrolled, the compiler
//   hoisted every k-step's fragments and spilled. No pair may use local
//   memory: chip_smoke.py's build line reads each kernel's registers,
//   stack and local bytes.
//
// The window and the query offset (flash_attention_bwd.cu's header): a
// causal call with either runs windowed instantiations of both passes
// (WINDOWED), the causal ones keeping their code. Pass 2 walks only the
// query tiles whose rows see its keys, [max(0, k0 - q_offset) / QT, (k0 +
// 62 + window - q_offset) / QT] with a window; pass 3 the key tiles from its
// first row's band start to its last row's position; a warp skips a chunk
// (a tile) wholly after its rows or before their windows, and only those
// that cross the diagonal or a band start are masked. The chains stay as
// short as the causal passes'.
//
// Numbers. Sums run in a fixed order with no atomics: two launches agree bit
// for bit. Masked probabilities are exact zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace {

using flash::Strides;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int KEYS2 = 64;       // keys a dK/dV CTA
constexpr int ROWS3 = 64;       // query rows a head of a dQ CTA (4 warps)

// D 128: the narrow tiles (shared memory and registers: the header)
template <int D, int DV>
constexpr bool wide() { return D + DV > 192; }

template <int D, int DV>
struct Pass2 {
  static constexpr int KP = D + 4, VP = DV + 4, ROW = KP + VP;
  static constexpr int QT = wide<D, DV>() ? 16 : 32;    // query rows a tile
  static constexpr int GROUPS = QT / 16;                 // warp groups, a chunk each
  static constexpr int THREADS = 128 * GROUPS;
  static constexpr int KV = 2 * KEYS2 * ROW;             // K big, small; V big, small
  static constexpr int STAGE = QT * ROW + 2 * QT;        // Q rows, dO rows, lse, Drow
  static constexpr int SPLIT = 2 * QT * ROW + 2 * QT;    // Q, dO big, small; lse log2e, Drow
  // at D 128 dV's running sums live in shared memory (registers: the header)
  static constexpr bool DV_SHARED = wide<D, DV>();
  static constexpr int FLOATS = KV + STAGE + SPLIT + (DV_SHARED ? KEYS2 * DV : 0);
};

template <int D, int DV>
struct Pass3 {
  static constexpr int KP = D + 4, VP = DV + 4, ROW = KP + VP;
  static constexpr int KT = wide<D, DV>() ? 16 : 32;    // keys a tile
  static constexpr int MAX_GB = wide<D, DV>() ? 2 : 3;  // query heads a CTA
  static constexpr int STAGE = KT * ROW;                 // K rows, V rows
  static constexpr int SPLIT = 2 * KT * ROW;             // K big, small; V big, small
  static constexpr int floats(int GB) { return GB * ROWS3 * ROW + STAGE + SPLIT; }
};

__device__ __forceinline__ void split4(const float4 x, uint4& big, uint4& small) {
  tiles::split_tf32(x.x, big.x, small.x);
  tiles::split_tf32(x.y, big.y, small.y);
  tiles::split_tf32(x.z, big.z, small.z);
  tiles::split_tf32(x.w, big.w, small.w);
}

// `rows` rows W wide (row stride P floats) from `src` into big and small rows
template <int W, int P>
__device__ __forceinline__ void split_rows(const float* src, float* big, float* small, int rows,
                                           int nthreads) {
  constexpr int C = W / 4;
  for (int e = threadIdx.x; e < rows * C; e += nthreads) {
    const int off = (e / C) * P + 4 * (e % C);
    uint4 b, s;
    split4(*reinterpret_cast<const float4*>(src + off), b, s);
    *reinterpret_cast<uint4*>(big + off) = b;
    *reinterpret_cast<uint4*>(small + off) = s;
  }
}

// rows [r0, r0 + rows) of one (batch, head) slice, W wide, into rows of P
// floats by 16-byte copies; rows past S zero-filled
template <int W, int P>
__device__ __forceinline__ void copy_rows(float* dst, const float* base, long long s_stride,
                                          int r0, int rows, int S, int nthreads) {
  constexpr int C = W / 4;
  for (int e = threadIdx.x; e < rows * C; e += nthreads) {
    const int r = e / C, c = e % C;
    const int pos = r0 + r;
    const bool ok = pos < S;
    tiles::cp_async16(dst + r * P + 4 * c, base + (ok ? pos : 0) * s_stride + 4 * c, ok);
  }
}

// The A fragment of 16 rows (row stride P floats) at k-step kk, by ldmatrix
template <int P>
__device__ __forceinline__ void load_a(unsigned a[4], const float* rows, int kk, int lane) {
  tiles::ldmatrix_x4(a, rows + (lane & 15) * P + 8 * kk + (lane >> 4) * 4);
}

// B fragments of two n8 tiles, n = rows [n0, n0 + 16) of a tile whose
// columns are k (row stride P floats), at k-step kk, by ldmatrix
template <int P>
__device__ __forceinline__ void load_b(unsigned b[4], const float* tile, int n0, int kk,
                                       int lane) {
  tiles::ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * P + 8 * kk +
                            ((lane >> 3) & 1) * 4);
}

// The B fragment of n8 tile n (columns 8n + g) at a k-step over tile rows
// r0 + 2t and r0 + 2t + 1 (the key-numbering trick's rows t and t + 4)
template <int P>
__device__ __forceinline__ void load_b_rows(unsigned b[2], const float* tile, int r0, int n,
                                            int g, int t) {
  const float* at = tile + (r0 + 2 * t) * P + 8 * n + g;
  b[0] = __float_as_uint(at[0]);
  b[1] = __float_as_uint(at[P]);
}

// An accumulator pair of 16 x 8 as the big and small A fragments of one
// k-step: its columns 2t and 2t + 1 are the fragment's t and t + 4
__device__ __forceinline__ void split_acc(const float x[4], unsigned big[4], unsigned small[4]) {
  tiles::split_tf32(x[0], big[0], small[0]);
  tiles::split_tf32(x[2], big[1], small[1]);
  tiles::split_tf32(x[1], big[2], small[2]);
  tiles::split_tf32(x[3], big[3], small[3]);
}

// acc (16 x 8) += big/small A x big/small B: the three products in order
__device__ __forceinline__ void mma3(float acc[4], const unsigned ab[4], const unsigned as[4],
                                     const unsigned bb[2], const unsigned bs[2]) {
  tiles::mma_tf32_1688(acc, as, bb);
  tiles::mma_tf32_1688(acc, ab, bs);
  tiles::mma_tf32_1688(acc, ab, bb);
}

// A B over the NT n8 tiles of a tile whose B rows sit at r0 + 8 j +
// {2t, 2t + 1} (row stride P) for the KS k-steps j: each n8 tile's sum
// taken from zero and handed to merge(n, sum), which adds it to the
// running sum by one FADD an element
template <int NT, int KS, int P, typename Merge>
__device__ __forceinline__ void mma_merge(const unsigned (*ab)[4], const unsigned (*as)[4],
                                          const float* big, const float* small, int r0,
                                          int g, int t, Merge merge) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      unsigned bb[2], bs[2];
      load_b_rows<P>(bb, big, r0 + 8 * j, n, g, t);
      load_b_rows<P>(bs, small, r0 + 8 * j, n, g, t);
      mma3(f, ab[j], as[j], bb, bs);
    }
    merge(n, f);
  }
}

// merge(n, sum) into n8 tile n of an accumulator in registers
struct InRegs {
  float (*acc)[4];
  __device__ __forceinline__ void operator()(int n, const float f[4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] += f[r];
  }
};

// ... of one in shared memory, element r of lane l of tile n at
// acc[(4 n + r) 32 + l]: the same sums, bank-conflict free
struct InShared {
  float* acc;
  int lane;
  __device__ __forceinline__ void operator()(int n, const float f[4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[(4 * n + r) * 32 + lane] += f[r];
  }
};

// s (16 rows x NT n8 tiles) = A B^T over KK k-steps: A the 16 rows at
// `a_big` and `a_small` (split in shared memory) or, with A_RAW, at `a_big`
// unsplit (split in registers); B the 8 NT rows of `b_big` and `b_small`.
// Every two k-steps' products are summed from zero and merged into s by one
// FADD an element.
template <bool A_RAW, int KK, int PA, int PB, int NT>
__device__ __forceinline__ void scores(float (*s)[4], const float* a_big, const float* a_small,
                                       const float* b_big, const float* b_small, int lane) {
  static_assert(KK % 2 == 0, "k-steps come in pairs");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < KK; k0 += 2) {
    float f[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) f[j][r] = 0.f;
#pragma unroll
    for (int kk = k0; kk < k0 + 2; ++kk) {
      unsigned ab[4], as[4];
      if constexpr (A_RAW) {
        unsigned raw[4];
        load_a<PA>(raw, a_big, kk, lane);
#pragma unroll
        for (int r = 0; r < 4; ++r) tiles::split_tf32(__uint_as_float(raw[r]), ab[r], as[r]);
      } else {
        load_a<PA>(ab, a_big, kk, lane);
        load_a<PA>(as, a_small, kk, lane);
      }
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        unsigned bb[4], bs[4];
        load_b<PB>(bb, b_big, 16 * jj, kk, lane);
        load_b<PB>(bs, b_small, 16 * jj, kk, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) mma3(f[2 * jj + h], ab, as, &bb[2 * h], &bs[2 * h]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] += f[j][r];
  }
}

// Pass 2: dK and dV of one (key tile, KV head, batch).
template <int D, int DV, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(Pass2<D, DV>::THREADS, 1)
    flash_bwd_dkdv_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ drow,
                                  float* __restrict__ dk, float* __restrict__ dv, int B, int Sq,
                                  int Skv, int H, int KH, int q_off, int win, Strides qs,
                                  Strides ks, Strides vs, float scale) {
  using S = Pass2<D, DV>;
  constexpr int KP = S::KP, VP = S::VP, QT = S::QT;
  constexpr int NTHREADS = S::THREADS;
  extern __shared__ __align__(128) float smem_f32[];
  float* kbig = smem_f32;
  float* ksmall = kbig + KEYS2 * KP;
  float* vbig = ksmall + KEYS2 * KP;
  float* vsmall = vbig + KEYS2 * VP;
  float* stage = smem_f32 + S::KV;              // Q rows, dO rows, lse, Drow
  float* qbig = stage + S::STAGE;
  float* qsmall = qbig + QT * KP;
  float* obig = qsmall + QT * KP;
  float* osmall = obig + QT * VP;
  float* l2_s = osmall + QT * VP;               // lse log2e of the tile's rows
  float* dr_s = l2_s + QT;                      // and their Drow

  const int kt = static_cast<int>(blockIdx.x) / (KH * B);
  const int kh = static_cast<int>(blockIdx.x) % KH, b = static_cast<int>(blockIdx.x) / KH % B;
  const int k0 = kt * KEYS2;
  const int G = H / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp / 4, wk = warp % 4;     // the chunk of each tile, the keys
  const int kw0 = k0 + 16 * wk;                // the warp's first key
  const bool warp_live = kw0 < Skv;

  constexpr bool windowed = CAUSAL && WINDOWED;
  const int qo = windowed ? q_off : 0;         // row i stands at position i + qo
  const int w = windowed ? win : 0;            // 0: no window
  const int n_qt = (Sq + QT - 1) / QT;
  // the query tiles whose rows see some of these keys: rows from k0 - qo on
  // (causal: from the key tile's diagonal), and with a window up to k0 +
  // KEYS2 - 2 + w - qo; the causal kernel keeps its own expression
  const int qt_first = windowed ? max(k0 - qo, 0) / QT : CAUSAL ? k0 / QT : 0;
  const int last_row = k0 + KEYS2 - 2 + w - qo;
  const int qt_end =
      windowed && w > 0 ? (last_row < 0 ? 0 : min(n_qt, last_row / QT + 1)) : n_qt;
  const int per_head = max(qt_end - qt_first, 0);
  const int n_items = G * per_head;            // (head, query tile) pairs, heads outer
  const long long do_s = static_cast<long long>(H) * DV;   // dO's row stride
  const float* dob = dout + static_cast<long long>(b) * Sq * do_s;

  auto load_item = [&](int i) {
    const int h = kh * G + i / per_head;
    const int q0 = (qt_first + i % per_head) * QT;
    copy_rows<D, KP>(stage, q + b * qs.b + h * qs.h, qs.s, q0, QT, Sq, NTHREADS);
    copy_rows<DV, VP>(stage + QT * KP, dob + h * DV, do_s, q0, QT, Sq, NTHREADS);
    const long long at = static_cast<long long>(b) * Sq * H + h;
    for (int e = threadIdx.x; e < 2 * QT; e += NTHREADS) {
      const int pos = q0 + e % QT;
      const bool ok = pos < Sq;
      tiles::cp_async4(stage + QT * S::ROW + e,
                       (e < QT ? lse : drow) + at + static_cast<long long>(ok ? pos : 0) * H, ok);
    }
  };

  // K and V of the tile, read once and split (keys past Skv zero)
  {
    const float* kb = k + b * ks.b + kh * ks.h;
    const float* vb = v + b * vs.b + kh * vs.h;
    constexpr int KC = D / 4, VC = DV / 4;
    for (int e = threadIdx.x; e < KEYS2 * (KC + VC); e += NTHREADS) {
      const bool is_v = e >= KEYS2 * KC;
      const int rem = is_v ? e - KEYS2 * KC : e;
      const int chunks = is_v ? VC : KC;
      const int r = rem / chunks, c = rem % chunks;
      const int pos = k0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pos < Skv)
        x = *reinterpret_cast<const float4*>((is_v ? vb + pos * vs.s : kb + pos * ks.s) + 4 * c);
      uint4 bg, sm;
      split4(x, bg, sm);
      const int off = r * (is_v ? VP : KP) + 4 * c;
      *reinterpret_cast<uint4*>((is_v ? vbig : kbig) + off) = bg;
      *reinterpret_cast<uint4*>((is_v ? vsmall : ksmall) + off) = sm;
    }
  }
  if (n_items > 0) load_item(0);
  tiles::cp_async_commit();

  constexpr bool DV_SHARED = S::DV_SHARED;
  float dk_acc[D / 8][4], dv_acc[DV_SHARED ? 1 : DV / 8][4];
  // the warp's dV sums in shared memory, each lane's own elements
  float* dv_s = dr_s + QT + wk * 16 * DV;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[j][r] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (DV_SHARED)
        dv_s[(4 * j + r) * 32 + lane] = 0.f;
      else
        dv_acc[j][r] = 0.f;
    }
  const float sl2 = scale * LOG2E;
  const int cr = 16 * grp;                     // the chunk's first row in a tile

  for (int i = 0; i < n_items; ++i) {
    tiles::cp_async_wait<0>();   // item i has landed
    __syncthreads();             // ... for every thread; the split tiles are consumed
    split_rows<D, KP>(stage, qbig, qsmall, QT, NTHREADS);
    split_rows<DV, VP>(stage + QT * KP, obig, osmall, QT, NTHREADS);
    for (int e = threadIdx.x; e < QT; e += NTHREADS) {
      l2_s[e] = stage[QT * S::ROW + e] * LOG2E;
      dr_s[e] = stage[QT * S::ROW + QT + e];
    }
    __syncthreads();             // the split tiles are ready, the staging tile free
    if (i + 1 < n_items) load_item(i + 1);
    tiles::cp_async_commit();

    const int qc = (qt_first + i % per_head) * QT + cr;   // the chunk's first query
    // every pair masked: the keys after the chunk's queries, or before
    // every query's window
    if (!warp_live || qc >= Sq || (CAUSAL && kw0 > qc + 15 + qo) ||
        (windowed && w > 0 && qc + qo - kw0 - 15 >= w))
      continue;
    // S^T = K Q^T and dP^T = V dO^T over the chunk's 16 queries
    float s[2][4], dp[2][4];
    scores<false, D / 8, KP, KP, 2>(s, kbig + 16 * wk * KP, ksmall + 16 * wk * KP, qbig + cr * KP,
                             qsmall + cr * KP, lane);
    scores<false, DV / 8, VP, VP, 2>(dp, vbig + 16 * wk * VP, vsmall + 16 * wk * VP, obig + cr * VP,
                              osmall + cr * VP, lane);
    // P^T and dS^T: row (key) kw0 + g + 8 (r >> 1), column (query)
    // qc + 8 j + 2 t + (r & 1)
    const bool masked = qc + 16 > Sq || kw0 + 16 > Skv || (CAUSAL && kw0 + 15 > qc + qo) ||
                        (windowed && w > 0 && qc + 15 + qo - kw0 >= w);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = cr + 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(l2_s + col);
      const float2 dr = *reinterpret_cast<const float2*>(dr_s + col);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = exp2f(fmaf(s[j][r], sl2, -((r & 1) ? l2.y : l2.x)));
        if (masked) {
          const int row = qc + 8 * j + 2 * t + (r & 1);
          const int kpos = kw0 + g + 8 * (r >> 1);
          if (row >= Sq || kpos >= Skv || (CAUSAL && kpos > row + qo) ||
              (windowed && w > 0 && row + qo - kpos >= w))
            p = 0.f;
        }
        s[j][r] = p;
        dp[j][r] = p * (dp[j][r] - ((r & 1) ? dr.y : dr.x)) * scale;
      }
    }
    // dV += P^T dO and dK += dS^T Q
    unsigned ab[2][4], as[2][4];
    split_acc(s[0], ab[0], as[0]);
    split_acc(s[1], ab[1], as[1]);
    if constexpr (DV_SHARED)
      mma_merge<DV / 8, 2, VP>(ab, as, obig, osmall, cr, g, t, InShared{dv_s, lane});
    else
      mma_merge<DV / 8, 2, VP>(ab, as, obig, osmall, cr, g, t, InRegs{dv_acc});
    split_acc(dp[0], ab[0], as[0]);
    split_acc(dp[1], ab[1], as[1]);
    mma_merge<D / 8, 2, KP>(ab, as, qbig, qsmall, cr, g, t, InRegs{dk_acc});
  }
  tiles::cp_async_wait<0>();

  if constexpr (S::GROUPS > 1) {
    // the second group's sums through shared memory, added to the first's
    __syncthreads();             // every warp is done with the tiles
    constexpr int NACC = D / 8 + DV / 8;
    float* part = smem_f32 + wk * NACC * 128;   // [tile][element][lane]
    if (grp == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[(j * 4 + r) * 32 + lane] = dk_acc[j][r];
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[((D / 8 + j) * 4 + r) * 32 + lane] = dv_acc[j][r];
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) dk_acc[j][r] += part[(j * 4 + r) * 32 + lane];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) dv_acc[j][r] += part[((D / 8 + j) * 4 + r) * 32 + lane];
  }

  if (!warp_live) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = kw0 + g + 8 * half;
    if (kpos >= Skv) continue;
    const long long row = (static_cast<long long>(b) * Skv + kpos) * KH + kh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dk + row * D + 8 * j + 2 * t) =
          make_float2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      float2 x;
      if constexpr (DV_SHARED)
        x = make_float2(dv_s[(4 * j + 2 * half) * 32 + lane],
                        dv_s[(4 * j + 2 * half + 1) * 32 + lane]);
      else
        x = make_float2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + row * DV + 8 * j + 2 * t) = x;
    }
  }
}

// Pass 3: dQ of one (q block, group of GB query heads, batch).
template <int D, int DV, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(Pass3<D, DV>::MAX_GB * 128, 1)
    flash_bwd_dq_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ drow,
                                float* __restrict__ dq, int Sq, int Skv, int H, int G, int GB,
                                int n_qblocks, int n_heads_b, int q_off, int win, Strides qs,
                                Strides ks, Strides vs, float scale) {
  using S = Pass3<D, DV>;
  constexpr int KP = S::KP, VP = S::VP, KT = S::KT;
  constexpr int NC = KT / 8;    // n8 tiles of S, k8 steps of dS K
  extern __shared__ __align__(128) float smem_f32[];
  float* qbuf = smem_f32;                       // GB x 64 q rows
  float* obuf = qbuf + GB * ROWS3 * KP;         // GB x 64 dO rows
  float* stage = obuf + GB * ROWS3 * VP;        // K rows, V rows
  float* kbig = stage + S::STAGE;
  float* ksmall = kbig + KT * KP;
  float* vbig = ksmall + KT * KP;
  float* vsmall = vbig + KT * VP;
  const int nthreads = blockDim.x;

  // heaviest q blocks first: block index -> (q block from the end, batch,
  // KV head, group of GB of its G query heads)
  const int qb = n_qblocks - 1 - static_cast<int>(blockIdx.x / n_heads_b);
  const int hb = blockIdx.x % n_heads_b;
  const int groups = G / GB;
  const int per_batch = (H / G) * groups;
  const int bidx = hb / per_batch;
  const int kh = (hb % per_batch) / groups;
  const int h0 = kh * G + (hb % groups) * GB;
  const int q0 = qb * ROWS3;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = warp / 4;                      // head within the group
  const int p0 = (warp % 4) * 16;               // warp's first row of the block
  const int g = lane / 4, t = lane % 4;

  // the key tiles of the rows' band: from the first row's band start
  // (windowed) to the last row's position (causal)
  constexpr bool windowed = CAUSAL && WINDOWED;
  const int qo = windowed ? q_off : 0;          // row i stands at position i + qo
  const int w = windowed ? win : 0;             // 0: no window
  const int q_last = min(q0 + ROWS3, Sq) - 1;
  const int kv_end = CAUSAL ? min(Skv, q_last + qo + 1) : Skv;
  const int t_lo = windowed && w > 0 ? max(0, q0 + qo - w + 1) / KT : 0;
  const int n_tiles = (kv_end + KT - 1) / KT;
  const float* kb = k + bidx * ks.b + kh * ks.h;
  const float* vb = v + bidx * vs.b + kh * vs.h;
  const long long do_s = static_cast<long long>(H) * DV;
  auto load_kv = [&](int k0) {
    copy_rows<D, KP>(stage, kb, ks.s, k0, KT, Skv, nthreads);
    copy_rows<DV, VP>(stage + KT * KP, vb, vs.s, k0, KT, Skv, nthreads);
  };

  // q and dO rows of the GB heads, then K/V tile 0: one copy group
  for (int gg = 0; gg < GB; ++gg) {
    copy_rows<D, KP>(qbuf + gg * ROWS3 * KP, q + bidx * qs.b + (h0 + gg) * qs.h, qs.s, q0, ROWS3,
                     Sq, nthreads);
    copy_rows<DV, VP>(obuf + gg * ROWS3 * VP,
                      dout + static_cast<long long>(bidx) * Sq * do_s + (h0 + gg) * DV, do_s, q0,
                      ROWS3, Sq, nthreads);
  }
  if (t_lo < n_tiles) load_kv(t_lo * KT);
  tiles::cp_async_commit();

  const int row_lo = q0 + p0;                   // the warp's first row
  const bool warp_live = row_lo < Sq;
  const int h = h0 + gi;
  // lse (exp2 domain) and Drow of rows row_lo + g and row_lo + g + 8
  float l2[2], dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = row_lo + g + 8 * half;
    const long long at = (static_cast<long long>(bidx) * Sq + pos) * H + h;
    l2[half] = pos < Sq ? lse[at] * LOG2E : 0.f;
    dr[half] = pos < Sq ? drow[at] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq_acc[j][r] = 0.f;
  const float sl2 = scale * LOG2E;
  const float* qw = qbuf + (gi * ROWS3 + p0) * KP;
  const float* ow = obuf + (gi * ROWS3 + p0) * VP;

  for (int tile = t_lo; tile < n_tiles; ++tile) {
    const int k0 = tile * KT;
    tiles::cp_async_wait<0>();   // tile `tile` (and q, dO) have landed
    __syncthreads();             // ... for every thread; the split tiles are free
    split_rows<D, KP>(stage, kbig, ksmall, KT, nthreads);
    split_rows<DV, VP>(stage + KT * KP, vbig, vsmall, KT, nthreads);
    __syncthreads();             // the split tiles are ready, the staging tile free
    if (tile + 1 < n_tiles) load_kv(k0 + KT);
    tiles::cp_async_commit();
    // every pair masked: the tile after the warp's rows, or before their
    // windows
    if (!warp_live || (CAUSAL && k0 > row_lo + 15 + qo) ||
        (windowed && w > 0 && row_lo + qo - (k0 + KT - 1) >= w))
      continue;

    // S = Q K^T and dP = dO V^T, q and dO split in registers
    float s[NC][4], dp[NC][4];
    scores<true, D / 8, KP, KP, NC>(s, qw, nullptr, kbig, ksmall, lane);
    scores<true, DV / 8, VP, VP, NC>(dp, ow, nullptr, vbig, vsmall, lane);
    // P and dS: row row_lo + g + 8 (r >> 1), key k0 + 8 j + 2 t + (r & 1)
    const bool masked = k0 + KT > Skv || (CAUSAL && k0 + KT - 1 > row_lo + qo) ||
                        (windowed && w > 0 && row_lo + 15 + qo - k0 >= w);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = exp2f(fmaf(s[j][r], sl2, -l2[r >> 1]));
        if (masked) {
          const int kpos = k0 + 8 * j + 2 * t + (r & 1);
          const int row = row_lo + g + 8 * (r >> 1);
          if (kpos >= Skv || (CAUSAL && kpos > row + qo) ||
              (windowed && w > 0 && row + qo - kpos >= w))
            p = 0.f;
        }
        dp[j][r] = p * (dp[j][r] - dr[r >> 1]) * scale;
      }
    // dQ += dS K, the tile's sum from zero
    unsigned ab[NC][4], as[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) split_acc(dp[j], ab[j], as[j]);
    mma_merge<D / 8, NC, KP>(ab, as, kbig, ksmall, 0, g, t, InRegs{dq_acc});
  }
  tiles::cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = row_lo + g + 8 * half;
    if (qpos >= Sq) continue;
    float* dst = dq + ((static_cast<long long>(bidx) * Sq + qpos) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(dq_acc[j][2 * half], dq_acc[j][2 * half + 1]);
  }
}

template <int D, int DV, bool CAUSAL, bool WINDOWED>
int launch_pair(const float* q, const float* k, const float* v, const float* dout,
                const float* lse, const float* drow, float* dq, float* dk, float* dv, int B,
                int Sq, int Skv, int H, int KH, int q_off, int win, Strides qs, Strides ks,
                Strides vs, float scale, cudaStream_t stream) {
  constexpr int F = static_cast<int>(sizeof(float));
  if (Skv > 0) {
    using S = Pass2<D, DV>;
    auto kernel = flash_bwd_dkdv_f32_mma_kernel<D, DV, CAUSAL, WINDOWED>;
    // the limit is per device: set it on the current one at every launch
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::FLOATS * F);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long blocks = static_cast<long long>((Skv + KEYS2 - 1) / KEYS2) * KH * B;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(blocks), S::THREADS, S::FLOATS * F, stream>>>(
        q, k, v, dout, lse, drow, dk, dv, B, Sq, Skv, H, KH, q_off, win, qs, ks, vs, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Sq > 0) {
    using S = Pass3<D, DV>;
    auto kernel = flash_bwd_dq_f32_mma_kernel<D, DV, CAUSAL, WINDOWED>;
    const int G = H / KH;
    const int GB = flash::heads_per_cta(G, S::MAX_GB);
    const int n_qblocks = (Sq + ROWS3 - 1) / ROWS3;
    const int n_heads_b = B * KH * (G / GB);         // (batch, head group) pairs
    const long long blocks = static_cast<long long>(n_qblocks) * n_heads_b;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::floats(S::MAX_GB) * F);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<static_cast<unsigned>(blocks), GB * 128, S::floats(GB) * F, stream>>>(
        q, k, v, dout, lse, drow, dq, Sq, Skv, H, G, GB, n_qblocks, n_heads_b, q_off, win, qs,
        ks, vs, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash::launch_bwd_f32(int D, int Dv, bool causal, int q_offset, int window,
                          const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* drow, void* dq, void* dk, void* dv,
                          int B, int Sq, int Skv, int H, int KH, Strides qs, Strides ks,
                          Strides vs, float scale, cudaStream_t stream) {
  const bool windowed = causal && (q_offset > 0 || window > 0);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  float* dqp = static_cast<float*>(dq);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
#define REPRO_FLASH_BWD_F32(DQ, DVV)                                                      \
  if (D == DQ && Dv == DVV) {                                                           \
    if (windowed)                                                                       \
      return launch_pair<DQ, DVV, true, true>(qp, kp, vp, dop, lse, drow, dqp, dkp, dvp, \
                                              B, Sq, Skv, H, KH, q_offset, window, qs,  \
                                              ks, vs, scale, stream);                   \
    return causal ? launch_pair<DQ, DVV, true, false>(qp, kp, vp, dop, lse, drow, dqp,  \
                                                      dkp, dvp, B, Sq, Skv, H, KH, 0, 0, \
                                                      qs, ks, vs, scale, stream)        \
                  : launch_pair<DQ, DVV, false, false>(qp, kp, vp, dop, lse, drow, dqp, \
                                                       dkp, dvp, B, Sq, Skv, H, KH, 0,  \
                                                       0, qs, ks, vs, scale, stream);   \
  }
  REPRO_FLASH_PAIRS(REPRO_FLASH_BWD_F32)
#undef REPRO_FLASH_BWD_F32
  return static_cast<int>(cudaErrorInvalidValue);
}
