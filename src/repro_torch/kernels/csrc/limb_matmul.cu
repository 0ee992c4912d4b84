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
//   fused:  d = (acc - u + p) mod p; s = d > HALF ? d - p : d;
//           out (M, N) float32 = (float)s * scale, one f32 multiply.
//
// Bound on the H100: at the tier-1 VGG shapes the card's int8 tensor rate
// (1,979 TOP/s) would make the nine products cheaper than moving the
// planes, so the work is bytes-bound in principle. This first kernel runs
// the products on the CUDA cores with __dp4a (four int8 products a
// instruction), far below the tensor-core rate, so it is bound by dp4a
// issue. Design: a 64x64 output tile a block (256 threads, 4x4 outputs a
// thread), K tiles of 32 digits of all three x- and w-planes staged
// through shared memory as packed 32-bit words (rows padded to 9 words, so
// the 16 column threads of a warp hit 16 banks). Each packed word pair
// feeds nine dp4a into five power-group accumulators (s = i + j); a group
// sum grows by at most 3 * 4 * 2^14 a word, so the int32 groups are reduced
// mod p every 32,768 k and stay below 2^31. mma.sync / wgmma on s8 come in
// a later change.
#include "field.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int KW = BK / 4;                 // packed words per tile row
constexpr int LD = KW + 1;                 // padded shared-memory row
constexpr int THREADS = 256;
constexpr int REDUCE_TILES = 32768 / BK;   // tiles between mod-p reductions

template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
limb_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wT,
                   const int* __restrict__ u, const float* __restrict__ scale,
                   int* __restrict__ out_i, float* __restrict__ out_f,
                   long long M, int N, int Kp) {
  __shared__ int xs[3][BM][LD];
  __shared__ int ws[3][BN][LD];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const size_t xplane = static_cast<size_t>(M) * Kp;
  const size_t wplane = static_cast<size_t>(N) * Kp;

  int g[5][4][4];
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[s][i][j] = 0;

  const int ktiles = Kp / BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const size_t kofs = static_cast<size_t>(kt) * BK;
    for (int e = threadIdx.x; e < 3 * BM * KW; e += THREADS) {
      const int p = e / (BM * KW);
      const int rem = e - p * BM * KW;
      const int row = rem / KW, kw = rem - row * KW;
      const long long m = m0 + row;
      const int n = n0 + row;
      xs[p][row][kw] = m < M ? __ldg(reinterpret_cast<const int*>(
                                   x + p * xplane + m * Kp + kofs) + kw)
                             : 0;
      ws[p][row][kw] = n < N ? __ldg(reinterpret_cast<const int*>(
                                   wT + p * wplane + static_cast<size_t>(n) * Kp + kofs) + kw)
                             : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[4][3], b[4][3];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          a[i][p] = xs[p][ty + 16 * i][kw];
          b[i][p] = ws[p][tx + 16 * i][kw];
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int gij[5] = {g[0][i][j], g[1][i][j], g[2][i][j], g[3][i][j], g[4][i][j]};
          field::dp4a_groups(a[i], b[j], gij);
#pragma unroll
          for (int s = 0; s < 5; ++s) g[s][i][j] = gij[s];
        }
    }
    __syncthreads();
    if ((kt + 1) % REDUCE_TILES == 0) {
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[s][i][j] %= field::P;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      const long long gij[5] = {g[0][i][j], g[1][i][j], g[2][i][j], g[3][i][j],
                                g[4][i][j]};
      const int acc = field::recombine(gij);
      const size_t o = static_cast<size_t>(m) * N + n;
      if (FUSED) {
        const int d = field::mod_p(static_cast<long long>(acc) - u[o]);
        const int s = d > field::HALF ? d - field::P : d;
        out_f[o] = __fmul_rn(static_cast<float>(s), *scale);
      } else {
        out_i[o] = acc;
      }
    }
  }
}

template <bool FUSED>
int launch(const void* x, const void* wT, const void* u, const void* scale, void* out,
           long long M, int N, int Kp, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  limb_matmul_kernel<FUSED><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wT),
      static_cast<const int*>(u), static_cast<const float*>(scale),
      FUSED ? nullptr : static_cast<int*>(out), FUSED ? static_cast<float*>(out) : nullptr,
      M, N, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_limb_matmul(const void* x, const void* wT, void* out, long long M,
                                 int N, int Kp, void* stream) {
  return launch<false>(x, wT, nullptr, nullptr, out, M, N, Kp, stream);
}

extern "C" int repro_limb_matmul_fused(const void* x, const void* wT, const void* u,
                                       const void* scale, void* out, long long M, int N,
                                       int Kp, void* stream) {
  return launch<true>(x, wT, u, scale, out, M, N, Kp, stream);
}
