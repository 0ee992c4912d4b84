// Building blocks of the tensor-core kernels (limb_mma.cuh, which
// limb_matmul.cu and limb_fold.cu share, flash_attention.cu,
// flash_attention_f32.cu and flash_attention_bwd.cu), as inline PTX for
// sm_90a:
//
//   cp_async16      one 16-byte global -> shared copy (cp.async.cg), with the
//                   source size 0 when `valid` is false: the hardware then
//                   writes 16 zero bytes and reads nothing, which is how the
//                   kernels zero-fill rows and k past a ragged edge;
//   cp_async4       the same for one 4-byte word (cp.async.ca);
//   ldmatrix_x4     four (or two) 8x8 b16 matrices from shared memory into
//   (_x2, _trans)   the register fragments of mma.sync, optionally
//                   transposed;
//   mma_s8_16832    D += A (16x32 s8, row) * B (32x8 s8, col), s32 sums that
//                   wrap on overflow (no .satfinite);
//   mma_bf16_16816  D += A (16x16 bf16, row) * B (16x8 bf16, col), f32 sums;
//   mma_tf32_1688   D += A (16x8 tf32, row) * B (8x8 tf32, col), f32 sums;
//   pack_bf16       two floats as one packed bf16 pair (an A fragment word);
//   split_bf16      two floats as hi + lo, two packed bf16 pairs, lo the
//                   rounding error of hi (16 significant bits together);
//   split_tf32      a float as big + small, two tf32 values (cvt.rna: 10
//                   mantissa bits, to nearest, ties away from zero), small
//                   the rounding of x - big: together x to ~2^-22 of |x|.
//
// Fragment layouts are PTX ISA's "Matrix Fragments for mma.m16n8k32",
// "... for mma.m16n8k16" and "... for mma.m16n8k8": a lane (group g =
// lane / 4, t = lane % 4) holds rows g and g + 8 of A and of D, and column
// g of B; in m16n8k8 (tf32) a lane's A columns and B rows are t and t + 4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// Two matrices: lanes 0-15 give the row addresses (the others are ignored).
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void mma_s8_16832(int d[4], const unsigned a[4],
                                             const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16_16816(float d[4], const unsigned a[4],
                                               const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_1688(float d[4], const unsigned a[4],
                                              const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

}  // namespace tiles
