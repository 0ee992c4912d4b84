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
// card's ops-per-byte line. Design: one warp a row of Y, the 32 lanes on
// neighbouring 4-byte words (coalesced 128-byte reads), the fold columns read
// through the read-only cache (3 * kf * Kp bytes, shared by every row). Each
// lane keeps five int32 power-group sums a fold column (a lane sees at most
// Kp / 32 words, so the sums stay below 2^31 for Kp <= 2^20, which the
// wrapper checks), the warp adds them in int64 with shuffles, and lane 0
// recombines and writes.
#include "field.cuh"

namespace {

constexpr int MAX_COLS = 4;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
limb_fold_kernel(const int8_t* __restrict__ y, const int8_t* __restrict__ sT,
                 int* __restrict__ out, long long M, int Kp, int kf) {
  const long long row = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;                         // warp-uniform
  const size_t plane = static_cast<size_t>(M) * Kp;
  const int words = Kp / 4;
  const int* y0 = reinterpret_cast<const int*>(y + row * Kp);
  const int* y1 = reinterpret_cast<const int*>(y + plane + row * Kp);
  const int* y2 = reinterpret_cast<const int*>(y + 2 * plane + row * Kp);

  int g[MAX_COLS][5];
#pragma unroll
  for (int f = 0; f < MAX_COLS; ++f)
#pragma unroll
    for (int s = 0; s < 5; ++s) g[f][s] = 0;

  for (int w = lane; w < words; w += 32) {
    const int a[3] = {__ldg(y0 + w), __ldg(y1 + w), __ldg(y2 + w)};
#pragma unroll
    for (int f = 0; f < MAX_COLS; ++f) {
      if (f < kf) {
        int b[3];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          b[p] = __ldg(reinterpret_cast<const int*>(
                           sT + (static_cast<size_t>(p) * kf + f) * Kp) + w);
        field::dp4a_groups(a, b, g[f]);
      }
    }
  }

#pragma unroll
  for (int f = 0; f < MAX_COLS; ++f) {
    if (f >= kf) break;
    long long tot[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      long long v = g[f][s];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
      tot[s] = v;
    }
    if (lane == 0) out[row * kf + f] = field::recombine(tot);
  }
}

}  // namespace

extern "C" int repro_limb_fold(const void* y, const void* sT, void* out, long long M,
                               int Kp, int kf, void* stream) {
  if (M == 0) return 0;
  if (kf < 1 || kf > MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (M * 32 + THREADS - 1) / THREADS;
  limb_fold_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(y), static_cast<const int8_t*>(sT),
      static_cast<int*>(out), M, Kp, kf);
  return static_cast<int>(cudaGetLastError());
}
