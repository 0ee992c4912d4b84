// limb_fold: Freivalds fold (Y @ S) mod p for a skinny fold matrix S.
//
// Replaces the TPU kernel repro/kernels/limb_matmul/fold.py:limb_fold_planes
// (_kernel). y: (3, M, Kp) int8 limb planes of the [y | x] operand;
// sT: (3, kf, Kp) int8 limb planes of the fold columns, transposed so that
// k is contiguous; kf <= 4 (the integrity layer folds with k in {1, 2});
// out: (M, kf) int32 in [0, p). Kp is a multiple of 32, zero past K.
//
// Bound on the H100: bytes. Every digit of Y is read once and meets at most
// four fold columns: about 18 * kf int8 ops a 3 bytes read, far below the
// card's ops-per-byte line (743 MB over the VGG-16 tier-1 folds of a batch
// of 4: 0.223 ms at 3.35 TB/s).
//
// Design: the fold is a field product with at most four output columns, so
// it runs the tensor-core main loop of limb_mma.cuh over one n8 tile of
// columns, the fold columns zero-padded from kf to 8 (the padding costs
// tensor-core work, which is idle here, and no bytes). Y comes once, in
// 16-byte cp.async chunks, into a 3-stage ring, with the fold columns'
// digits of the stage staged beside it, so any Kp takes the same path.
// The tensor cores do the k reduction and the groups are reduced mod p
// every 32,768 k, so a row costs nothing at its end beyond its
// recombination (field::recombine32, in registers) and one store of each
// column < kf. The CUDA-core form it replaces gave a warp to a row, read
// 4-byte words and ended every row with an int64 shuffle tree and lane 0's
// int64 modulo: as long as the row itself at the VGG widths (Kp 96-1280).
//
// Two tilings, by the number of rows. Many rows (the VGG checks): 64 rows
// a block, 8 warps, the k of each 128-digit stage split between two groups
// of four (16 rows and 64 digits a warp), 24 KB of Y a stage, two blocks
// an SM. Few rows (fewer 64-row tiles than two an SM: the SmolLM checks, 4
// rows a token step and 4096 in the prompt pass): 16 rows a block and a
// stage of 512 digits split among 8 warps, so a 4-row fold of 2112 digits
// is 5 stages of one block. In both the warps' group sums meet in shared
// memory at the end. Of the tilings timed on the H100 over the VGG-16
// folds (64 to 128 rows a block, 1 to 8 warps along k, 2 to 6 stages),
// these were the fastest for their rows.
#include "limb_mma.cuh"

namespace {

constexpr int MAX_COLS = 4;
using FoldTiles = limb_mma::Tiles<64, 8, 4, 1, 3, 2>;
using FewRowsTiles = limb_mma::Tiles<16, 8, 1, 1, 3, 8>;

template <class T>
__global__ void __launch_bounds__(T::THREADS)
limb_fold_mma_kernel(const int8_t* __restrict__ y, const int8_t* __restrict__ sT,
                     int* __restrict__ out, long long M, int kf, int Kp, int n_tiles) {
  extern __shared__ __align__(128) int8_t smem[];
  limb_mma::field_product<T>(y, sT, out, M, kf, Kp, n_tiles, smem);
}

}  // namespace

extern "C" int repro_limb_fold(const void* y, const void* sT, void* out, long long M,
                               int Kp, int kf, void* stream) {
  if (M == 0) return 0;
  if (kf < 1 || kf > MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((M + FoldTiles::TBM - 1) / FoldTiles::TBM < 2 * sms)
    return limb_mma::launch<FewRowsTiles>(limb_fold_mma_kernel<FewRowsTiles>, y, sT, M, kf,
                                          Kp, s, static_cast<int*>(out));
  return limb_mma::launch<FoldTiles>(limb_fold_mma_kernel<FoldTiles>, y, sT, M, kf, Kp, s,
                                     static_cast<int*>(out));
}
