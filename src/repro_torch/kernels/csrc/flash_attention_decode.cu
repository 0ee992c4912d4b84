// flash_attention decode route: bf16 attention for calls with few query rows
// a KV head (Sq * G <= flash::DECODE_ROWS), split over the keys
// (FlashDecoding's form), with the same inputs, masks and output as the
// prefill kernel in flash_attention.cu, whose C entry launches both passes
// below when the wrapper passes a split count and a workspace.
//
// Replaces, at these shapes, the TPU kernel
// repro/kernels/flash_attention/flash_attention.py: flash_attention_fwd
// (_kernel): a decode step's cross attention calls it with one query
// (repro/models/attention.py, sdpa from the cached cross K/V).
//
// Bound on the H100: bytes. One query against Skv keys reads each key's K
// and V row once and does 2 (D + Dv) operations a (row, key) pair: the VLM's
// decode (B 4, Skv 1601, 32/8 heads of 128) moves 26.2 MB, 7.8 us at
// 3.35 TB/s, for 0.1 GFLOP, 1.6 us of the CUDA cores' float32 FMA peak. The
// prefill kernel gives such a call one CTA per (64-query block, head group,
// batch): at Sq 1 one live warp a CTA walks all the keys in turn, and the
// VLM's 64 CTAs and Whisper's 48 leave most of the 132 SMs idle, so the
// call is bound by latency at ~10x its bytes bound.
//
// Split pass (flash_fwd_decode_split_kernel): one CTA of four warps per
// (split, KV head, batch). The split count comes from the wrapper
// (decode_splits, from the shapes alone, so a call gives the same bits on
// any card). The splits cover the call's band (flash::band): the keys [lo,
// hi) that some query row sees, all of Skv unless causal; causal, up to the
// last row's position and, with a window, from the first row's band start,
// so a windowed call's keys outside every row's band are never read. Split
// s holds keys [lo + s c, min(lo + (s + 1) c, hi)), c = ceil((hi - lo) /
// splits). Each CTA reads its keys' K and V rows once for all R = Sq * G
// query rows of its KV head (row r is query position r / G of head kh G +
// r % G): tiles of 64 keys arrive by cp.async (16-byte copies) into a ring
// of three stages, two tiles in flight while one is used, one barrier a
// tile. The R <= 16 rows are the M of mma.sync m16n8k16 (bf16 in, float32
// sums; rows past R are zeros and never stored), as the prefill kernel
// stacks its heads: each warp takes 16 keys of every tile and keeps its own
// online softmax over them in the exp2 domain (scores scaled by log2(e) /
// sqrt(D)), S = Q K^T with the keys as the col-major B operand, P from S's
// accumulators as P V's A fragment in two bf16 parts (hi = bf16(P), lo =
// bf16(P - hi): 16 significant bits), V by ldmatrix.trans. The CUDA cores'
// float32 form of the same pass (four threads a key's score, a thread 8
// output columns) measured 1.6-1.7x slower on an H100 (PERF.md, §6):
// its tiles' dot products, not the bytes, set its time, although the FMA
// count is a fifth of the bytes bound. When the keys are done the four
// warps' (m, l, o) meet in shared memory and merge in warp order into the
// split's float32 (m, l, acc[Dv]) of each row in the workspace: m the row's
// max score, l the sum of exp2(s - m), acc the unnormalised P V. Each lane's
// two rows see the keys from their band's start (their position, query
// position + q_offset, less window - 1, when windowed) to their position
// (causal), within the split: the masks of the prefill kernel (copies past
// the split's end are zero-filled); a row
// that sees no key of a split has m = -1e30, l = 0 and acc = 0, and a
// masked key's weight is set to 0 outright, so a split whose first keys a
// row cannot see never takes exp2(-1e30 - (-1e30)) = 1 for them. A warp
// whose 16 keys all lie past the split's end skips them (they would add
// exact zeros).
//
// Combine pass (flash_fwd_decode_combine_kernel): one CTA per (row, KV
// head, batch), Dv / 4 threads of 4 columns each. M = max_s m_s, L = sum_s
// exp2(m_s - M) l_s, O = sum_s exp2(m_s - M) acc_s, the splits merged in
// split order (no atomics: two launches agree bit for bit); the bf16 output
// is O / max(L, 1e-30) and, when lse is not null, the row's float32
// log-sum-exp M ln 2 + log(max(L, 1e-30)), as the prefill kernel writes it.
// Beside float32 sums, P's 16 significant bits and the output's one bf16
// rounding are the route's only roundings.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace {

using flash::DECODE_ROWS;
using flash::NEG;
using flash::Strides;

constexpr int WK = 16;         // keys a warp takes from a tile: two n8 tiles of S
constexpr int NW = 4;          // warps a split CTA
constexpr int NT = 32 * NW;
constexpr int T = NW * WK;     // keys a tile
constexpr int STAGES = 3;      // tiles in the cp.async ring: two in flight while one is used
constexpr int MAX_SPLITS = 1024;             // the combine's shared (m, l)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Padded rows (an odd number of 16-byte units: ldmatrix reads them without
// bank conflicts) of q and K (D wide) and of V (DV wide); after the keys the
// stages hold the warps' partial results for the merge, MO floats a row
template <int D, int DV>
struct DecSmem {
  static constexpr int ROW = 2 * D + 16;
  static constexpr int VROW = 2 * DV + 16;
  static constexpr int STAGE = T * (ROW + VROW);   // K rows, then V rows
  static constexpr int Q = DECODE_ROWS * ROW;
  static constexpr int MO = DV + 4;
  static constexpr int bytes = Q + STAGES * STAGE;
  static_assert(4 * NW * DECODE_ROWS * (MO + 2) <= STAGES * STAGE, "the merge fits the stages");
};

// K and V rows of keys [k0, k0 + T) into one stage; keys at or past k_hi are
// zero-filled
template <int D, int DV>
__device__ __forceinline__ void load_tile(char* stage, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, Strides ks, Strides vs,
                                          int k0, int k_hi) {
  using S = DecSmem<D, DV>;
  constexpr int KC = D / 8, VC = DV / 8;
#pragma unroll
  for (int i = 0; i < (T * KC + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e >= T * KC) break;
    const int row = e / KC, c = e % KC;
    const bool ok = k0 + row < k_hi;
    tiles::cp_async16(stage + row * S::ROW + 16 * c, kb + (ok ? k0 + row : 0) * ks.s + 8 * c,
                      ok);
  }
#pragma unroll
  for (int i = 0; i < (T * VC + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e >= T * VC) break;
    const int row = e / VC, c = e % VC;
    const bool ok = k0 + row < k_hi;
    tiles::cp_async16(stage + T * S::ROW + row * S::VROW + 16 * c,
                      vb + (ok ? k0 + row : 0) * vs.s + 8 * c, ok);
  }
}

template <int D, int DV, bool CAUSAL>
__global__ void __launch_bounds__(NT)
    flash_fwd_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v, float* __restrict__ ws,
                                  int B, int Sq, int Skv, int KH, int G, int splits,
                                  int q_off, int win, Strides qs, Strides ks, Strides vs,
                                  float scale) {
  using S = DecSmem<D, DV>;
  constexpr int DK = D / 16;    // k16 steps of Q K^T
  constexpr int DT = DV / 8;    // n8 tiles of the output
  constexpr int QC = D / 8;
  extern __shared__ __align__(128) char smem[];
  char* qbuf = smem;
  char* kv = smem + S::Q;       // stage s at s STAGE: K, then V

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int R = Sq * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const flash::Band bd = flash::band(Sq, Skv, CAUSAL, q_off, win);
  const int chunk = (bd.hi - bd.lo + splits - 1) / splits;
  const int k_lo = bd.lo + split * chunk;
  const int k_hi = min(k_lo + chunk, bd.hi);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + T - 1) / T : 0;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  // the R query rows (row r: position r / G of head kh G + r % G; rows past
  // R zero-filled) in one copy group, then tiles 0 to STAGES - 2 in one
  // group each
  for (int e = tid; e < DECODE_ROWS * QC; e += NT) {
    const int r = e / QC, c = e % QC;
    const bool ok = r < R;
    const __nv_bfloat16* src = q + b * qs.b + (ok ? r / G : 0) * qs.s +
                               (kh * G + (ok ? r % G : 0)) * qs.h + 8 * c;
    tiles::cp_async16(qbuf + r * S::ROW + 16 * c, src, ok);
  }
  tiles::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles)
      load_tile<D, DV>(kv + st * S::STAGE, kb, vb, ks, vs, k_lo + st * T, k_hi);
    tiles::cp_async_commit();
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_row[2] = {NEG, NEG}, l_row[2] = {0.f, 0.f};   // rows g, g + 8 (l per lane)
  // Q's A fragments, once the q group (the oldest) has landed for everyone
  tiles::cp_async_wait<STAGES - 1>();
  __syncthreads();
  unsigned qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    tiles::ldmatrix_x4(qf[kk], qbuf + (lane & 15) * S::ROW + 2 * (16 * kk + (lane >> 4) * 8));
  const float sl2 = scale * LOG2E;
  // the keys of the split that this lane's rows g and g + 8 see: causal,
  // row r (position r / G + q_off) sees keys up to its position and, with
  // a window, from its position - win + 1
  const bool windowed = CAUSAL && win > 0;
  const int pos_lo = g / G + q_off, pos_hi = (g + 8) / G + q_off;
  const int end_lo = CAUSAL ? min(k_hi, pos_lo + 1) : k_hi;
  const int end_hi = CAUSAL ? min(k_hi, pos_hi + 1) : k_hi;
  const int beg_lo = windowed ? max(k_lo, pos_lo - win + 1) : k_lo;
  const int beg_hi = windowed ? max(k_lo, pos_hi - win + 1) : k_lo;

  for (int tile = 0; tile < n_tiles; ++tile) {
    tiles::cp_async_wait<STAGES - 2>();   // this thread's copies of the tile
    __syncthreads();   // everyone's; and every warp is done with the previous tile
    const int pre = tile + STAGES - 1;    // into the previous tile's slot
    if (pre < n_tiles)
      load_tile<D, DV>(kv + (pre % STAGES) * S::STAGE, kb, vb, ks, vs, k_lo + pre * T, k_hi);
    tiles::cp_async_commit();
    // the warp's 16 keys of the tile; a slice wholly past the split's end
    // would add exact zeros, so it is skipped
    const int kw = k_lo + tile * T + WK * warp;
    if (kw < k_hi) {
      const char* kt = kv + (tile % STAGES) * S::STAGE + WK * warp * S::ROW;
      const char* vt = kv + (tile % STAGES) * S::STAGE + T * S::ROW + WK * warp * S::VROW;

      // S = Q K^T: the keys as the col-major B operand
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        unsigned kf[4];
        tiles::ldmatrix_x4(kf, kt + ((lane & 7) + (lane >> 4) * 8) * S::ROW +
                                   2 * (16 * kk + ((lane >> 3) & 1) * 8));
        tiles::mma_bf16_16816(s[0], qf[kk], &kf[0]);
        tiles::mma_bf16_16816(s[1], qf[kk], &kf[2]);
      }

      // scale, mask, online softmax (exp2 domain); a masked key's weight is
      // 0 outright, also while the row has seen no key (m = -1e30)
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kpos = kw + 8 * j + 2 * t + (r & 1);
          const bool seen = kpos < (r < 2 ? end_lo : end_hi) &&
                            kpos >= (r < 2 ? beg_lo : beg_hi);
          const float x = seen ? s[j][r] * sl2 : NEG;
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
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = s[j][r] <= NEG ? 0.f : exp2f(s[j][r] - m_row[r >> 1]);
          s[j][r] = p;
          l_row[r >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[j][r] *= corr[r >> 1];

      // O += P V: P from S's accumulators as the A fragment, in two bf16
      // parts (P = hi + lo, 16 significant bits), V by ldmatrix.trans
      unsigned hi[4], lo[4];
      tiles::split_bf16(s[0][0], s[0][1], hi[0], lo[0]);
      tiles::split_bf16(s[0][2], s[0][3], hi[1], lo[1]);
      tiles::split_bf16(s[1][0], s[1][1], hi[2], lo[2]);
      tiles::split_bf16(s[1][2], s[1][3], hi[3], lo[3]);
#pragma unroll
      for (int u = 0; u < DT / 2; ++u) {
        unsigned vf[4];
        tiles::ldmatrix_x4_trans(vf, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * S::VROW +
                                         2 * (16 * u + (lane >> 4) * 8));
        tiles::mma_bf16_16816(o[2 * u], hi, &vf[0]);
        tiles::mma_bf16_16816(o[2 * u], lo, &vf[0]);
        tiles::mma_bf16_16816(o[2 * u + 1], hi, &vf[2]);
        tiles::mma_bf16_16816(o[2 * u + 1], lo, &vf[2]);
      }
    }
  }
  tiles::cp_async_wait<0>();
  __syncthreads();     // the stages are free for the merge

  // each warp's rows: (m, l) and the unnormalised output, into shared memory
  float* mo = reinterpret_cast<float*>(kv);      // [NW][DECODE_ROWS][MO]
  float* mml = mo + NW * DECODE_ROWS * S::MO;    // [NW][DECODE_ROWS][2]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = warp * DECODE_ROWS + g + 8 * h;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(mo + row * S::MO + 8 * j + 2 * t) =
          make_float2(o[j][2 * h], o[j][2 * h + 1]);
    if (t == 0) *reinterpret_cast<float2*>(mml + 2 * row) = make_float2(m_row[h], l);
  }
  __syncthreads();

  // the split's (m, l, acc) of each row: the warps merged in order
  const long long rows = static_cast<long long>(B) * KH * splits * R;
  const long long row0 = ((static_cast<long long>(b) * KH + kh) * splits + split) * R;
  float* ws_o = ws + row0 * DV;
  float* ws_ml = ws + rows * DV + row0 * 2;
  for (int e = tid; e < R * (DV / 4); e += NT) {
    const int r = e / (DV / 4), c = 4 * (e % (DV / 4));
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mml[2 * (w * DECODE_ROWS + r)]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int row = w * DECODE_ROWS + r;
      const float wt = exp2f(mml[2 * row] - M);
      const float4 a = *reinterpret_cast<const float4*>(mo + row * S::MO + c);
      L = fmaf(wt, mml[2 * row + 1], L);
      acc.x = fmaf(wt, a.x, acc.x);
      acc.y = fmaf(wt, a.y, acc.y);
      acc.z = fmaf(wt, a.z, acc.z);
      acc.w = fmaf(wt, a.w, acc.w);
    }
    *reinterpret_cast<float4*>(ws_o + r * DV + c) = acc;
    if (c == 0) *reinterpret_cast<float2*>(ws_ml + 2 * r) = make_float2(M, L);
  }
}

template <int DV>
__global__ void __launch_bounds__(DV / 4)
    flash_fwd_decode_combine_kernel(const float* __restrict__ ws,
                                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                    int B, int Sq, int H, int KH, int G, int splits) {
  __shared__ float2 ml_s[MAX_SPLITS];
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int R = Sq * G;
  const int c = 4 * threadIdx.x;
  const long long rows = static_cast<long long>(B) * KH * splits * R;
  const long long first = (static_cast<long long>(b) * KH + kh) * splits * R + r;   // split 0
  const float2* ml = reinterpret_cast<const float2*>(ws + rows * DV);
  for (int s = threadIdx.x; s < splits; s += blockDim.x) ml_s[s] = ml[first + s * R];
  __syncthreads();
  float M = NEG;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml_s[s].x);
  float L = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {   // in split order
    const float4 a = *reinterpret_cast<const float4*>(ws + (first + s * R) * DV + c);
    const float w = exp2f(ml_s[s].x - M);
    L = fmaf(w, ml_s[s].y, L);
    o.x = fmaf(w, a.x, o.x);
    o.y = fmaf(w, a.y, o.y);
    o.z = fmaf(w, a.z, o.z);
    o.w = fmaf(w, a.w, o.w);
  }
  const float inv_l = 1.f / fmaxf(L, 1e-30f);
  const int qpos = r / G, h = kh * G + r % G;
  const long long orow = (static_cast<long long>(b) * Sq + qpos) * H + h;
  *reinterpret_cast<uint2*>(out + orow * DV + c) =
      make_uint2(tiles::pack_bf16(o.x * inv_l, o.y * inv_l),
                 tiles::pack_bf16(o.z * inv_l, o.w * inv_l));
  if (lse != nullptr && threadIdx.x == 0) lse[orow] = M * LN2 + logf(fmaxf(L, 1e-30f));
}

template <int D, int DV, bool CAUSAL>
int launch_pair(const void* q, const void* k, const void* v, void* out, float* lse,
                float* ws, int B, int Sq, int Skv, int H, int KH, int splits, int q_off,
                int win, Strides qs, Strides ks, Strides vs, float scale,
                cudaStream_t stream) {
  const int G = H / KH;
  if (B > 65535 || KH > 65535 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto split = flash_fwd_decode_split_kernel<D, DV, CAUSAL>;
  constexpr int bytes = DecSmem<D, DV>::bytes;
  // the limit is per device: set it on the current one at every launch;
  // ask for the largest shared-memory carveout, so that several CTAs of
  // ~72 KB share an SM
  cudaError_t attr =
      cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(split, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  split<<<dim3(splits, KH, B), NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ws, B, Sq, Skv, KH, G, splits, q_off, win, qs, ks,
      vs, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_decode_combine_kernel<DV><<<dim3(Sq * G, KH, B), DV / 4, 0, stream>>>(
      ws, static_cast<__nv_bfloat16*>(out), lse, B, Sq, H, KH, G, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash::launch_decode(int D, int Dv, bool causal, int q_offset, int window, const void* q,
                         const void* k, const void* v, void* out, float* lse, float* ws,
                         int B, int Sq, int Skv, int H, int KH, int splits, Strides qs,
                         Strides ks, Strides vs, float scale, cudaStream_t stream) {
#define REPRO_FLASH_DECODE(DQ, DVV)                                                        \
  if (D == DQ && Dv == DVV)                                                              \
    return causal ? launch_pair<DQ, DVV, true>(q, k, v, out, lse, ws, B, Sq, Skv, H, KH,  \
                                               splits, q_offset, window, qs, ks, vs, scale, \
                                               stream)                                    \
                  : launch_pair<DQ, DVV, false>(q, k, v, out, lse, ws, B, Sq, Skv, H, KH, \
                                                splits, 0, 0, qs, ks, vs, scale, stream);
  REPRO_FLASH_PAIRS(REPRO_FLASH_DECODE)
#undef REPRO_FLASH_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}
