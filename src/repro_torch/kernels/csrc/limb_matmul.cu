// limb_matmul: exact field matmul (X @ W) mod p over int8 limb planes, with
// an optional fused unblind + dequantize epilogue.
//
// Replaces the TPU kernels
//   repro/kernels/limb_matmul/limb_matmul.py:limb_matmul_planes (_kernel)
//   repro/kernels/limb_matmul/limb_matmul.py:limb_matmul_planes_fused
//   (_kernel_fused).
// x: (3, M, Kp) int8 planes; wT: (3, N, Kp) int8 planes (the weight planes
// transposed so that k is contiguous for both operands); Kp is a multiple
// of 32 with zero digits past the true K.
//   plain:  out (M, N) int32 = field product in [0, p)
//   fused:  d = mod(acc - u + p, p), the sum wrapping in int32 (any u);
//           s = d > HALF ? d - p : d;
//           out (M, N) float32 = (float)s * scale, one f32 multiply.
//
// Bound on the H100. At the VGG-16 tier-1 shapes the nine limb products
// are 340 G int8 operations on 781 MB (plain) or 935 MB (fused, with u
// read and the f32 result written): 0.172 ms at the int8 tensor cores'
// 1,979 TOP/s against 0.233 and 0.279 ms at 3.35 TB/s, so the work is
// bytes-bound by a small margin, and only on the tensor cores: the CUDA
// cores' dp4a take ~4 ms.
//
// Design: both entries run the tensor-core main loop of limb_mma.cuh
// (mma.sync m16n8k32 s8, a 3-stage cp.async ring) with one block tile: 64x64
// outputs a block, 8 warps of 32x16 (2 x 2 mma tiles), 80 int32
// accumulators a thread; they differ only in their epilogues. The fused
// epilogue reads u in the D-fragment order (for each fragment register, a
// warp reads 8 rows of 32 contiguous bytes: whole sectors) and stays in
// 32-bit arithmetic: the wrapped sum acc - u + p takes one shift-and-add
// remainder (field::reduce32), for any int32 u. 92 KB of shared memory
// and at most 128 registers a thread leave room for two blocks an SM; at
// that cap ptxas spills ~100 bytes, and the uncapped kernel (219
// registers, one block an SM) measured slower. What bounds it now is L2-to-SM traffic: every block
// streams its own W tiles as well as its x tiles.
#include "limb_mma.cuh"

namespace {

using MatmulTiles = limb_mma::Tiles<64, 64, 2, 4>;

__global__ void __launch_bounds__(MatmulTiles::THREADS, 2)
limb_matmul_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wT,
                       int* __restrict__ out, long long M, int N, int Kp, int n_tiles) {
  extern __shared__ __align__(128) int8_t smem[];
  limb_mma::field_product<MatmulTiles>(x, wT, out, M, N, Kp, n_tiles, smem);
}

__global__ void __launch_bounds__(MatmulTiles::THREADS, 2)
limb_matmul_fused_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wT,
                             const int* __restrict__ u, const float* __restrict__ scale,
                             float* __restrict__ out, long long M, int N, int Kp,
                             int n_tiles) {
  extern __shared__ __align__(128) int8_t smem[];
  const limb_mma::Place pl = limb_mma::place<MatmulTiles>(n_tiles);
  int acc[5][MatmulTiles::MT][MatmulTiles::NT][4];
  limb_mma::mainloop<MatmulTiles>(x, wT, pl, M, N, Kp, smem, acc);
  const float sc = *scale;
  limb_mma::for_each_output<MatmulTiles>(acc, pl, M, N, [&](size_t o, int v) {
    // the reference's mod(acc - u + p, p): the sum wraps in int32 (taken
    // in unsigned arithmetic, where wrapping is defined), then one floor
    // remainder, so any int32 u reduces as the reference reduces it
    const int d = field::reduce32(static_cast<int>(
        static_cast<unsigned>(v) - static_cast<unsigned>(__ldg(u + o)) +
        static_cast<unsigned>(field::P)));
    const int s = d > field::HALF ? d - field::P : d;
    out[o] = __fmul_rn(static_cast<float>(s), sc);
  });
}

}  // namespace

extern "C" int repro_limb_matmul(const void* x, const void* wT, void* out, long long M,
                                 int N, int Kp, void* stream) {
  return limb_mma::launch<MatmulTiles>(limb_matmul_mma_kernel, x, wT, M, N, Kp,
                                       static_cast<cudaStream_t>(stream),
                                       static_cast<int*>(out));
}

extern "C" int repro_limb_matmul_fused(const void* x, const void* wT, const void* u,
                                       const void* scale, void* out, long long M, int N,
                                       int Kp, void* stream) {
  return limb_mma::launch<MatmulTiles>(
      limb_matmul_fused_mma_kernel, x, wT, M, N, Kp, static_cast<cudaStream_t>(stream),
      static_cast<const int*>(u), static_cast<const float*>(scale), static_cast<float*>(out));
}
