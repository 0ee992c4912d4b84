// limb_matmul: exact field matmul (X @ W) mod p over int8 limb planes, with
// an optional fused unblind + dequantize epilogue.
//
// Replaces the TPU kernels
//   repro/kernels/limb_matmul/limb_matmul.py:limb_matmul_planes (_kernel)
//   repro/kernels/limb_matmul/limb_matmul.py:limb_matmul_planes_fused
//   (_kernel_fused).
// x: (3, M, Kp) int8 planes; wT: (3, N, Kp) int8 planes (the weight planes
// transposed so that k is contiguous for both operands: the K-major layout
// of mma's .row.col int8 shape); Kp is a multiple of 32 with zero digits
// past the true K.
//   plain:  out (M, N) int32 = field product in [0, p)
//   fused:  d = (acc - u + p) mod p; s = d > HALF ? d - p : d;
//           out (M, N) float32 = (float)s * scale, one f32 multiply.
//
// Bound on the H100. At the VGG-16 tier-1 shapes the nine limb products
// are 340 G int8 operations on 781 MB: 0.172 ms at the int8 tensor cores'
// 1,979 TOP/s against 0.233 ms at 3.35 TB/s, so the work is bytes-bound by
// a small margin, and only on the tensor cores: the CUDA cores' dp4a would
// take ~5 ms.
//
// Plain entry: tensor cores (mma.sync m16n8k32 s8 x s8 -> s32). A block
// owns a 64x64 output tile (8 warps, 2 along M x 4 along N, a warp tile of
// 32x16: 2 x 2 mma tiles). k advances in stages of 64 digits of all three
// x- and w-planes (30 KB), brought by cp.async into a ring of 3 stages in
// shared memory, so two stages are in flight while one is multiplied. Rows
// are padded to 80 bytes, so the eight 16-byte rows of an ldmatrix fall on
// eight different bank groups. Each k32 step loads the three w fragments
// once and, plane by plane, the x fragments, and issues the nine products
// into the five power-group accumulators s = i + j: 5 x 2 x 2 x 4 = 80
// int32 registers a thread. A group sum grows by at most 3 * 128^2 a k, so
// the groups are reduced mod p every 32,768 k and the wrapping s32 sums
// never wrap. Rows past M, columns past N and k past Kp arrive as zeros
// (cp.async with source size 0) and are not stored. The epilogue
// recombines each output with 32-bit residue arithmetic (field::
// recombine32); canonical residues make the result independent of the
// tiling, so it is bit-equal to the plain version. 92 KB of shared memory
// and at most 128 registers a thread leave room for two blocks an SM; at
// that cap ptxas spills ~100 bytes, and the uncapped kernel (219 registers,
// one block an SM) measured slower. What bounds it now is L2-to-SM
// traffic: every block streams its own W tiles as well as its x tiles.
// The main loop (load_stage, mma_stage, mma_mainloop) hands back the
// accumulators, so another entry needs only its own epilogue.
//
// Fused entry: still the first design, on the CUDA cores: a 64x64 tile a
// block (256 threads, 4x4 outputs a thread), K tiles of 32 digits staged
// through shared memory as packed words, nine __dp4a a word pair into the
// five power groups, reduced mod p every 32,768 k.
#include "field.cuh"
#include "mma_tiles.cuh"

namespace {

// ---- plain entry: the tensor-core main loop ----

constexpr int TBM = 64, TBN = 64, TBK = 64;   // block tile; k digits a stage
constexpr int STAGES = 3;
constexpr int ROW = TBK + 16;                 // padded shared row, bytes
constexpr int X_PLANE = TBM * ROW, W_PLANE = TBN * ROW;
constexpr int STAGE_BYTES = 3 * (X_PLANE + W_PLANE);
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
constexpr int MMA_THREADS = 256;
constexpr int WM = 32, WN = 16;               // warp tile
constexpr int MT = WM / 16, NT = WN / 8;      // mma tiles a warp
constexpr int REDUCE_STAGES = 32768 / TBK;    // stages between mod-p reductions

struct Tile {
  long long m0;  // first row of the block
  int n0;        // first column
};

// Copy stage kt (k digits [kt * TBK, kt * TBK + TBK)) of the three x- and
// w-planes into ring slot `buf`, zero-filling what lies outside the operands.
__device__ __forceinline__ void load_stage(int8_t* buf, const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ wT, Tile tile,
                                           long long M, int N, int Kp, int kt) {
  constexpr int CHUNKS = TBK / 16;
  const int k0 = kt * TBK;
  const size_t xplane = static_cast<size_t>(M) * Kp;
  const size_t wplane = static_cast<size_t>(N) * Kp;
  for (int e = threadIdx.x; e < 3 * TBM * CHUNKS; e += MMA_THREADS) {
    const int p = e / (TBM * CHUNKS);
    const int row = (e / CHUNKS) % TBM, c = e % CHUNKS;
    const long long m = tile.m0 + row;
    const int k = k0 + 16 * c;
    const bool ok = m < M && k < Kp;
    tiles::cp_async16(buf + p * X_PLANE + row * ROW + 16 * c,
                      ok ? x + p * xplane + m * Kp + k : x, ok);
  }
  int8_t* wbuf = buf + 3 * X_PLANE;
  for (int e = threadIdx.x; e < 3 * TBN * CHUNKS; e += MMA_THREADS) {
    const int p = e / (TBN * CHUNKS);
    const int row = (e / CHUNKS) % TBN, c = e % CHUNKS;
    const int n = tile.n0 + row;
    const int k = k0 + 16 * c;
    const bool ok = n < N && k < Kp;
    tiles::cp_async16(wbuf + p * W_PLANE + row * ROW + 16 * c,
                      ok ? wT + p * wplane + static_cast<size_t>(n) * Kp + k : wT, ok);
  }
}

// The nine limb products of one stage into the warp's power groups.
__device__ __forceinline__ void mma_stage(const int8_t* buf, int wm, int wn, int lane,
                                          int acc[5][MT][NT][4]) {
  const int8_t* wbuf = buf + 3 * X_PLANE;
#pragma unroll
  for (int ks = 0; ks < TBK / 32; ++ks) {
    // B fragments of the warp's n8 tiles, two an ldmatrix, for each w-plane
    unsigned b[3][2 * NT];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        tiles::ldmatrix_x4(&b[j][4 * np],
                           wbuf + j * W_PLANE +
                               (wn + 16 * np + (lane & 7) + (lane >> 4) * 8) * ROW + 32 * ks +
                               ((lane >> 3) & 1) * 16);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tiles::ldmatrix_x4(a[mt], buf + i * X_PLANE + (wm + 16 * mt + (lane & 15)) * ROW +
                                      32 * ks + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            tiles::mma_s8_16832(acc[i + j][mt][nt], a[mt], &b[j][2 * nt]);
    }
  }
}

// The main loop: the power-group sums of the block's tile over all of Kp,
// each reduced mod p at least every 32,768 k.
__device__ __forceinline__ void mma_mainloop(const int8_t* __restrict__ x,
                                             const int8_t* __restrict__ wT, Tile tile,
                                             long long M, int N, int Kp, int wm, int wn,
                                             int lane, int8_t* smem, int acc[5][MT][NT][4]) {
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][mt][nt][r] = 0;

  const int ktiles = (Kp + TBK - 1) / TBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(smem + s * STAGE_BYTES, x, wT, tile, M, N, Kp, s);
    tiles::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    tiles::cp_async_wait<STAGES - 2>();   // stage kt has landed
    __syncthreads();                      // ... for every thread; slot kt-1 is free
    const int next = kt + STAGES - 1;
    if (next < ktiles)
      load_stage(smem + (next % STAGES) * STAGE_BYTES, x, wT, tile, M, N, Kp, next);
    tiles::cp_async_commit();
    mma_stage(smem + (kt % STAGES) * STAGE_BYTES, wm, wn, lane, acc);
    if ((kt + 1) % REDUCE_STAGES == 0) {
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[s][mt][nt][r] %= field::P;
    }
  }
  tiles::cp_async_wait<0>();
}

__global__ void __launch_bounds__(MMA_THREADS, 2)
limb_matmul_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wT,
                       int* __restrict__ out, long long M, int N, int Kp, int n_tiles) {
  extern __shared__ __align__(128) int8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / (TBN / WN)) * WM, wn = (warp % (TBN / WN)) * WN;
  // neighbouring blocks share a row band, so its x planes come from L2
  const Tile tile{static_cast<long long>(blockIdx.x / n_tiles) * TBM,
                  static_cast<int>(blockIdx.x % n_tiles) * TBN};
  int acc[5][MT][NT][4];
  mma_mainloop(x, wT, tile, M, N, Kp, wm, wn, lane, smem, acc);

  // D fragment: c0, c1 at (row g, columns 2t, 2t+1); c2, c3 at row g + 8
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long m = tile.m0 + wm + 16 * mt + g + 8 * (r / 2);
        const int n = tile.n0 + wn + 8 * nt + 2 * t + r % 2;
        if (m >= M || n >= N) continue;
        const int gs[5] = {acc[0][mt][nt][r], acc[1][mt][nt][r], acc[2][mt][nt][r],
                           acc[3][mt][nt][r], acc[4][mt][nt][r]};
        out[m * N + n] = field::recombine32(gs);
      }
}

int launch_mma(const void* x, const void* wT, void* out, long long M, int N, int Kp,
               cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  // cp.async moves 16-byte chunks: the planes must start on 16 bytes
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wT) % 16 || Kp % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the limit is per device: set it on the current one at every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      limb_matmul_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_tiles = (N + TBN - 1) / TBN;
  const long long blocks = (M + TBM - 1) / TBM * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  limb_matmul_mma_kernel<<<static_cast<unsigned>(blocks), MMA_THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wT), static_cast<int*>(out), M,
      N, Kp, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---- fused entry: the CUDA-core (dp4a) kernel ----

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int KW = BK / 4;                 // packed words per tile row
constexpr int LD = KW + 1;                 // padded shared-memory row
constexpr int THREADS = 256;
constexpr int REDUCE_TILES = 32768 / BK;   // tiles between mod-p reductions

__global__ void __launch_bounds__(THREADS)
limb_matmul_fused_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wT,
                         const int* __restrict__ u, const float* __restrict__ scale,
                         float* __restrict__ out, long long M, int N, int Kp) {
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
      const int d = field::mod_p(static_cast<long long>(acc) - u[o]);
      const int s = d > field::HALF ? d - field::P : d;
      out[o] = __fmul_rn(static_cast<float>(s), *scale);
    }
  }
}

}  // namespace

extern "C" int repro_limb_matmul(const void* x, const void* wT, void* out, long long M,
                                 int N, int Kp, void* stream) {
  return launch_mma(x, wT, out, M, N, Kp, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_limb_matmul_fused(const void* x, const void* wT, const void* u,
                                       const void* scale, void* out, long long M, int N,
                                       int Kp, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  limb_matmul_fused_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wT),
      static_cast<const int*>(u), static_cast<const float*>(scale), static_cast<float*>(out),
      M, N, Kp);
  return static_cast<int>(cudaGetLastError());
}
