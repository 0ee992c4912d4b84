// Shared by the translation units of the flash-attention kernels:
// flash_attention.cu (the bf16 tensor-core kernel and the C entry point),
// flash_attention_f32.cu (the float32 tensor-core kernel),
// flash_attention_decode.cu (the bf16 split-KV route for few query rows),
// flash_attention_bwd.cu (the backward's C entry and bf16 passes) and
// flash_attention_bwd_f32.cu (its float32 passes), compiled by separate nvcc
// processes in parallel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The built (q/k width D, v width Dv) pairs: SmolLM's 32 and 64, 128 of the
// GQA LMs, MiniCPM3's MLA (96, 64) and its smoke widths (48, 32).
#define REPRO_FLASH_PAIRS(X) X(32, 32) X(64, 64) X(128, 128) X(96, 64) X(48, 32)

namespace flash {

// Whether (D, Dv) is one of the built pairs.
inline bool built_pair(int D, int Dv) {
#define REPRO_FLASH_BUILT(DQ, DVV) \
  if (D == DQ && Dv == DVV) return true;
  REPRO_FLASH_PAIRS(REPRO_FLASH_BUILT)
#undef REPRO_FLASH_BUILT
  return false;
}

constexpr int BQ = 64;         // query positions a CTA (both forward kernels)
constexpr int BK = 64;         // keys a tile of the bf16 forward
constexpr float NEG = -1e30f;
// A bf16 call with at most this many query rows a KV head (Sq * G) takes the
// split-KV decode route (flash_attention_decode.cu); the wrapper's
// DECODE_ROWS is the same number.
constexpr int DECODE_ROWS = 16;

struct Strides {
  long long b, s, h;
};

// The keys [lo, hi) that some query row of a call sees, the union of the
// rows' bands. Query i stands at position i + q_offset; causal, it sees the
// keys kpos <= i + q_offset and, with window > 0, only those with i +
// q_offset - kpos < window; non-causal, every key (neither the offset nor
// the window applies). The wrapper's band() is the same function.
struct Band {
  int lo, hi;
};

__host__ __device__ inline Band band(int Sq, int Skv, bool causal, int q_offset, int window) {
  if (!causal) return {0, Skv};
  const int lo = window > 0 ? (q_offset - window + 1 > 0 ? q_offset - window + 1 : 0) : 0;
  const int end = Sq + q_offset < Skv ? Sq + q_offset : Skv;
  return {lo, end > lo ? end : lo};
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The tensor-core kernels copy q, k and v in 16-byte chunks of rows: their
// starts and their (b, s, h) element strides must be multiples of 16 bytes
// (`elem` bytes an element).
inline bool rows_aligned16(const void* q, const void* k, const void* v, Strides qs,
                           Strides ks, Strides vs, int elem) {
  const Strides all[3] = {qs, ks, vs};
  const int n = 16 / elem;
  for (const Strides& s : all)
    if (s.b % n || s.s % n || s.h % n) return false;
  return aligned16(q) && aligned16(k) && aligned16(v);
}

// Query heads a CTA holds: the largest divisor of G up to `most`.
inline int heads_per_cta(int G, int most) {
  for (int gb = most; gb > 1; --gb)
    if (G % gb == 0) return gb;
  return 1;
}

// The float32 kernel's launch for the pair (D, Dv) (flash_attention_f32.cu);
// cudaErrorInvalidValue for a pair it was not built for.
// ``lse`` (float32 (B, Sq, H)) is written when not null. ``q_offset`` and
// ``window`` (0: none) as in band(); the caller passes 0 for both when not
// causal.
int launch_f32(int D, int Dv, bool causal, int q_offset, int window, const void* q,
               const void* k, const void* v, void* out, float* lse, int B, int Sq, int Skv,
               int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
               cudaStream_t stream);

// The decode route for the pair (D, Dv) (flash_attention_decode.cu): the
// split pass over `splits` splits of the call's band() into the float32
// workspace `ws` (B KH splits Sq G rows of Dv + 2 floats), then the combine
// pass into `out` (and `lse` when not null); cudaErrorInvalidValue for a
// pair it was not built for.
int launch_decode(int D, int Dv, bool causal, int q_offset, int window, const void* q,
                  const void* k, const void* v, void* out, float* lse, float* ws, int B,
                  int Sq, int Skv, int H, int KH, int splits, Strides qs, Strides ks,
                  Strides vs, float scale, cudaStream_t stream);

// The backward's float32 dK/dV and dQ passes for the pair (D, Dv)
// (flash_attention_bwd_f32.cu), after Drow; cudaErrorInvalidValue for a pair
// they were not built for. ``q_offset`` and ``window`` as in band(), 0 for
// both when not causal; a causal call with either runs the windowed
// instantiations.
int launch_bwd_f32(int D, int Dv, bool causal, int q_offset, int window, const void* q,
                   const void* k, const void* v, const void* dout, const float* lse,
                   const float* drow, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                   int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
                   cudaStream_t stream);

}  // namespace flash
