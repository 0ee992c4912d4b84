// The tensor-core field product of limb planes, shared by limb_matmul.cu
// (the plain and the fused entry) and limb_fold.cu (the Freivalds fold):
// a block's tile of (X @ W) mod p over int8 limb planes, for a block tile
// chosen by each entry.
//
// x: (3, M, Kp) int8 planes; wT: (3, N, Kp) int8 planes (k contiguous for
// both operands: the K-major layout of mma's .row.col int8 shape); Kp is a
// multiple of 32 with zero digits past the true K.
//
// k advances in stages of 64 digits of all three x- and w-planes (64 a
// warp, for a split k), brought by cp.async into a ring of stages in shared
// memory (3 unless an entry asks for more), so all stages but one are in
// flight while one is multiplied. Rows are padded by 16 bytes to an odd
// number of 16-byte units, so the eight 16-byte rows of an ldmatrix fall
// on eight different bank groups.
// Each k32 step loads the three w fragments once and, plane by plane, the
// x fragments, and issues the nine products (mma.sync m16n8k32 s8 x s8 ->
// s32) into the five power-group accumulators s = i + j. A group sum grows
// by at most 3 * 128^2 a k, so the groups are reduced mod p every 32,768 k
// and the wrapping s32 sums never wrap. Rows past M, columns past N and k
// past Kp arrive as zeros (cp.async with source size 0) and are not
// stored. An entry's epilogue walks the outputs in D-fragment order, each
// recombined with 32-bit residue arithmetic (field::recombine32);
// canonical residues make every result independent of the tiling, so it is
// bit-equal to the plain version.
#pragma once

#include "field.cuh"
#include "mma_tiles.cuh"

namespace limb_mma {

// A block tile of BM x BN outputs over WARPS_M x WARPS_N warps, with a
// ring of RING stages. WARPS_K > 1 splits every stage's k among that many
// groups of warps, 64 digits each, whose sums meet at the end (combine_k).
template <int BM, int BN, int WARPS_M, int WARPS_N, int RING = 3, int WARPS_K = 1>
struct Tiles {
  static constexpr int TBM = BM, TBN = BN;
  static constexpr int KW = 64;                  // k digits a warp, a stage
  static constexpr int TBK = KW * WARPS_K;       // k digits a stage
  static constexpr int STAGES = RING;
  static constexpr int SPLIT_K = WARPS_K;
  static constexpr int WARPS_MN = WARPS_M * WARPS_N;
  static constexpr int THREADS = 32 * WARPS_MN * WARPS_K;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;              // mma tiles a warp
  static constexpr int ROW = TBK + 16;           // padded shared row, bytes
  static constexpr int X_PLANE = TBM * ROW, W_PLANE = TBN * ROW;
  static constexpr int STAGE_BYTES = 3 * (X_PLANE + W_PLANE);
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static constexpr int REDUCE_STAGES = 32768 / KW;  // stages between mod-p reductions
  static constexpr int ACC = 5 * MT * NT * 4;       // accumulators a thread
  static_assert(WM % 16 == 0 && (NT == 1 || NT % 2 == 0), "warp tile");
  static_assert((WARPS_K - 1) * WARPS_MN * 32 * ACC * 4 <= SMEM_BYTES, "combine_k");
};

// Where this thread's outputs lie: the block's tile and the warp's place
// in it.
struct Place {
  long long m0;  // first row of the block
  int n0;        // first column of the block
  int wm, wn;    // the warp's tile within the block's
  int wk;        // the warp's k slice of a stage (0 unless SPLIT_K > 1)
  int mn;        // the warp's index among those of one k slice
  int lane;
};

template <class T>
__device__ __forceinline__ Place place(int n_tiles) {
  const int warp = threadIdx.x / 32;
  constexpr int WARPS_N = T::TBN / T::WN;
  const int mn = T::SPLIT_K == 1 ? warp : warp % T::WARPS_MN;
  // neighbouring blocks share a row band, so its x planes come from L2
  return {static_cast<long long>(blockIdx.x / n_tiles) * T::TBM,
          static_cast<int>(blockIdx.x % n_tiles) * T::TBN,
          (mn / WARPS_N) * T::WM,
          (mn % WARPS_N) * T::WN,
          T::SPLIT_K == 1 ? 0 : warp / T::WARPS_MN,
          mn,
          static_cast<int>(threadIdx.x % 32)};
}

// Copy stage kt (k digits [kt * TBK, kt * TBK + TBK)) of the three x- and
// w-planes into ring slot `buf`, zero-filling what lies outside the operands.
template <class T>
__device__ __forceinline__ void load_stage(int8_t* buf, const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ wT, const Place& pl,
                                           long long M, int N, int Kp, int kt) {
  constexpr int CHUNKS = T::TBK / 16;
  const int k0 = kt * T::TBK;
  const size_t xplane = static_cast<size_t>(M) * Kp;
  const size_t wplane = static_cast<size_t>(N) * Kp;
  for (int e = threadIdx.x; e < 3 * T::TBM * CHUNKS; e += T::THREADS) {
    const int p = e / (T::TBM * CHUNKS);
    const int row = (e / CHUNKS) % T::TBM, c = e % CHUNKS;
    const long long m = pl.m0 + row;
    const int k = k0 + 16 * c;
    const bool ok = m < M && k < Kp;
    tiles::cp_async16(buf + p * T::X_PLANE + row * T::ROW + 16 * c,
                      ok ? x + p * xplane + m * Kp + k : x, ok);
  }
  int8_t* wbuf = buf + 3 * T::X_PLANE;
  for (int e = threadIdx.x; e < 3 * T::TBN * CHUNKS; e += T::THREADS) {
    const int p = e / (T::TBN * CHUNKS);
    const int row = (e / CHUNKS) % T::TBN, c = e % CHUNKS;
    const int n = pl.n0 + row;
    const int k = k0 + 16 * c;
    const bool ok = n < N && k < Kp;
    tiles::cp_async16(wbuf + p * T::W_PLANE + row * T::ROW + 16 * c,
                      ok ? wT + p * wplane + static_cast<size_t>(n) * Kp + k : wT, ok);
  }
}

// The nine limb products of one stage into the warp's power groups.
template <class T>
__device__ __forceinline__ void mma_stage(const int8_t* buf, const Place& pl,
                                          int acc[5][T::MT][T::NT][4]) {
  const int8_t* wbuf = buf + 3 * T::X_PLANE;
  const int lane = pl.lane;
#pragma unroll
  for (int step = 0; step < T::KW / 32; ++step) {
    const int ks = pl.wk * (T::KW / 32) + step;   // k32 step within the stage
    // B fragments of the warp's n8 tiles for each w-plane: one tile by an
    // x2 load, pairs of tiles by x4 loads
    unsigned b[3][2 * T::NT];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if constexpr (T::NT == 1) {
        tiles::ldmatrix_x2(b[j], wbuf + j * T::W_PLANE + (pl.wn + (lane & 7)) * T::ROW +
                                     32 * ks + ((lane >> 3) & 1) * 16);
      } else {
#pragma unroll
        for (int np = 0; np < T::NT / 2; ++np)
          tiles::ldmatrix_x4(&b[j][4 * np],
                             wbuf + j * T::W_PLANE +
                                 (pl.wn + 16 * np + (lane & 7) + (lane >> 4) * 8) * T::ROW +
                                 32 * ks + ((lane >> 3) & 1) * 16);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      unsigned a[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        tiles::ldmatrix_x4(a[mt], buf + i * T::X_PLANE +
                                      (pl.wm + 16 * mt + (lane & 15)) * T::ROW + 32 * ks +
                                      (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt)
            tiles::mma_s8_16832(acc[i + j][mt][nt], a[mt], &b[j][2 * nt]);
    }
  }
}

// Split k: the warps of k slice 0 take the other slices' sums, each reduced
// mod p (so |sum| < SPLIT_K * p), through the ring's shared memory.
template <class T>
__device__ __forceinline__ void combine_k(int8_t* smem, const Place& pl,
                                          int acc[5][T::MT][T::NT][4]) {
  int* part = reinterpret_cast<int*>(smem);
  __syncthreads();                         // every warp is done with the ring
  if (pl.wk > 0) {
    int* dst = part + ((pl.wk - 1) * T::WARPS_MN + pl.mn) * T::ACC * 32 + pl.lane;
#pragma unroll
    for (int s = 0; s < 5; ++s)
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dst[32 * (((s * T::MT + mt) * T::NT + nt) * 4 + r)] = acc[s][mt][nt][r] % field::P;
  }
  __syncthreads();
  if (pl.wk == 0) {
#pragma unroll
    for (int s = 0; s < 5; ++s)
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = ((s * T::MT + mt) * T::NT + nt) * 4 + r;
            int v = acc[s][mt][nt][r] % field::P;
            for (int w = 1; w < T::SPLIT_K; ++w)
              v += part[((w - 1) * T::WARPS_MN + pl.mn) * T::ACC * 32 + 32 * i + pl.lane];
            acc[s][mt][nt][r] = v;
          }
  }
}

// The main loop: the power-group sums of the block's tile over all of Kp,
// each reduced mod p at least every 32,768 k.
template <class T>
__device__ __forceinline__ void mainloop(const int8_t* __restrict__ x,
                                         const int8_t* __restrict__ wT, const Place& pl,
                                         long long M, int N, int Kp, int8_t* smem,
                                         int acc[5][T::MT][T::NT][4]) {
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][mt][nt][r] = 0;

  const int ktiles = (Kp + T::TBK - 1) / T::TBK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ktiles) load_stage<T>(smem + s * T::STAGE_BYTES, x, wT, pl, M, N, Kp, s);
    tiles::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    tiles::cp_async_wait<T::STAGES - 2>();   // stage kt has landed
    __syncthreads();                         // ... for every thread; slot kt-1 is free
    const int next = kt + T::STAGES - 1;
    if (next < ktiles)
      load_stage<T>(smem + (next % T::STAGES) * T::STAGE_BYTES, x, wT, pl, M, N, Kp, next);
    tiles::cp_async_commit();
    mma_stage<T>(smem + (kt % T::STAGES) * T::STAGE_BYTES, pl, acc);
    if ((kt + 1) % T::REDUCE_STAGES == 0) {
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[s][mt][nt][r] %= field::P;
    }
  }
  tiles::cp_async_wait<0>();
  if constexpr (T::SPLIT_K > 1) combine_k<T>(smem, pl, acc);
}

// store(o, v) for each output of the warp inside (M, N): o = m * N + n, v
// its field value in [0, p). D fragment: c0, c1 at (row g, columns 2t,
// 2t+1); c2, c3 at row g + 8.
template <class T, class Store>
__device__ __forceinline__ void for_each_output(int acc[5][T::MT][T::NT][4],
                                                const Place& pl, long long M, int N,
                                                Store store) {
  if (pl.wk != 0) return;                  // split k: slice 0 holds the sums
  const int g = pl.lane / 4, t = pl.lane % 4;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long m = pl.m0 + pl.wm + 16 * mt + g + 8 * (r / 2);
        const int n = pl.n0 + pl.wn + 8 * nt + 2 * t + r % 2;
        if (m >= M || n >= N) continue;
        const int gs[5] = {acc[0][mt][nt][r], acc[1][mt][nt][r], acc[2][mt][nt][r],
                           acc[3][mt][nt][r], acc[4][mt][nt][r]};
        store(static_cast<size_t>(m) * N + n, field::recombine32(gs));
      }
}

// The plain product: out (M, N) int32 in [0, p).
template <class T>
__device__ __forceinline__ void field_product(const int8_t* __restrict__ x,
                                              const int8_t* __restrict__ wT,
                                              int* __restrict__ out, long long M, int N,
                                              int Kp, int n_tiles, int8_t* smem) {
  const Place pl = place<T>(n_tiles);
  int acc[5][T::MT][T::NT][4];
  mainloop<T>(x, wT, pl, M, N, Kp, smem, acc);
  for_each_output<T>(acc, pl, M, N, [&](size_t o, int v) { out[o] = v; });
}

// Launch `kernel(x, wT, args..., M, N, Kp, n_tiles)` over the block tiles
// of an (M, N) output, after the checks the main loop needs. Returns a
// cudaError_t.
template <class T, class Kernel, class... Args>
int launch(Kernel kernel, const void* x, const void* wT, long long M, int N, int Kp,
           cudaStream_t stream, Args... args) {
  if (M == 0 || N == 0) return 0;
  // cp.async moves 16-byte chunks: the planes must start on 16 bytes
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wT) % 16 || Kp % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the limit is per device: set it on the current one at every launch
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_tiles = (N + T::TBN - 1) / T::TBN;
  const long long blocks = (M + T::TBM - 1) / T::TBM * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), T::THREADS, T::SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wT), args..., M, N, Kp,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace limb_mma
