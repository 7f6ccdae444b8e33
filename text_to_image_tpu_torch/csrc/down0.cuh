// The thin-input 5x5 stride-2 SAME convolution on Hopper's tensor cores
// (sm_90a): a map with Cin <= 4 channels into N output channels.  Included
// by conv5x5_s2.cu (the discriminator's RGB layer, `down0_mma`: N = 64)
// and conv5x5_s2_bwd.cu (the transposed convolution's RGB dx,
// deconv5x5_s2_dx's `thin` path: the cotangent's Co <= 4 channels into
// N = 64 or 128 columns of dx a block).
//
// Bound by bytes on the H100 (x read once, y written once): K = 25*Cin is
// 75 or 100 deep, so the products are few and each output byte costs less
// than a byte of the input's taps.  One block makes N channels of a tile of
// 8x16 output pixels: it stages the 19x35 input patch once, builds the
// im2col tile [128][K padded to 16] in 128-byte-swizzled shared memory and
// runs K/16 wgmma steps a 64-row half (m64nNk16) against the weights
// [K][N], N-major in panels of 64 columns, which stay resident while the
// block walks over tiles; the next tile's patch is read into registers
// while this one is multiplied and stored; y leaves through a staging tile
// as whole N-channel rows.  At N = 128 two warpgroups share a tile, one a
// half (one warpgroup at N = 64).  The problem P says where the weights
// come from (`stage_weights`) and what the epilogue adds (`add`, `act`).

#pragma once

#include <type_traits>

#include "igemm_sm90.cuh"

namespace down0 {

constexpr int OH = 8, OW = 16;                       // output tile
constexpr int PH = 2 * OH + 3, PW = 2 * OW + 3;      // input patch
constexpr int ROWS = OH * OW;                        // 128 GEMM rows
constexpr int KMAX = 112;                            // 25*4 -> 112
constexpr int A_PANEL = ROWS * 128;
constexpr int A_BYTES = 2 * A_PANEL;
constexpr int B_PANEL = KMAX * 128;                  // 64 columns of B
constexpr int PATCH_BYTES = PH * PW * 4 * 2;

template <int N>
struct Shape {
  static constexpr int WG = N == 64 ? 1 : 2;         // warpgroups a block
  static constexpr int THREADS = 128 * WG;
  static constexpr int STAGE = ROWS * (N + 8) * 2;   // bf16 output staging
  // A, and after the products the staging tile, then the weights
  static constexpr int A_OR_STAGE = A_BYTES > STAGE ? A_BYTES : STAGE;
  static constexpr int B_BYTES = (N / 64) * B_PANEL;
  static constexpr int SMEM = A_OR_STAGE + B_BYTES + PATCH_BYTES + 1024;
  // resident blocks an SM, held by the launch bounds (at most 128
  // registers a thread): fewer left the RGB layer's tiles waiting on loads
  static constexpr int BLOCKS_PER_SM = N == 64 ? 4 : 2;
  static_assert(A_OR_STAGE % 1024 == 0, "the weights 1024-byte aligned");
};

// Byte offset in B of K row kr, 8-column chunk c (N-major, panels of 64
// columns B_PANEL apart, each [KMAX][128 bytes] 128-byte swizzled).
__device__ __forceinline__ uint32_t b_chunk(int kr, int c) {
  return static_cast<uint32_t>((c >> 3) * B_PANEL) + igemm90::swz(kr, c & 7);
}

// Columns n0 .. n0 + N - 1 (blockIdx.y) of the output over tiles
// blockIdx.x, +gridDim.x, ...; P: the image x (p.a, [B][H][W][CIN]), y
// (p.y, [B][Ho][Wo][p.N]), the SAME pads, `stage_weights`, the epilogue's
// `add` / `mul` / `act`, and `kOneColumnTile` (p.N == N always).
template <int CIN, int N, class P>
__global__ void __launch_bounds__(Shape<N>::THREADS, Shape<N>::BLOCKS_PER_SM)
    kernel(P p, int tiles_y, int tiles_x, int n_tiles) {
  using S = Shape<N>;
  constexpr int K = 25 * CIN, KP = (K + 15) / 16 * 16, STEPS = KP / 16;
  constexpr int ROW = PW * CIN;   // patch row, elements
  constexpr int THREADS = S::THREADS, HALVES = 2 / S::WG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t a_addr = base, b_addr = base + S::A_OR_STAGE;
  uint16_t* patch =
      reinterpret_cast<uint16_t*>(sm + S::A_OR_STAGE + S::B_BYTES);
  uint16_t* stage = reinterpret_cast<uint16_t*>(sm);

  // warpgroup wg owns the 64-row halves wg .. wg + HALVES - 1; with one
  // warpgroup, wg and the thread's index in it fold to constants
  const int tid = threadIdx.x;
  const int wg = S::WG == 1 ? 0 : tid >> 7;
  const int tid128 = S::WG == 1 ? tid : tid & 127;
  // the column tile's first channel and y's row length: constants where
  // the problem has one column tile (P::kOneColumnTile: the conv's N = Co
  // = 64), else blockIdx.y * N, read where it is used and not held across
  // the tile loop, and p.N: the kernel sits at its bound of 128 registers
  auto col0 = [] {
    return P::kOneColumnTile ? 0 : static_cast<int>(blockIdx.y) * N;
  };
  const uint16_t* x = static_cast<const uint16_t*>(p.a);

  // the weights [K][N], zero rows up to KP: resident for every tile (A's
  // room is free until the first tile's im2col)
  p.template stage_weights<CIN, N, KP, THREADS>(sm + S::A_OR_STAGE, sm,
                                               col0(), tid);

  // This thread's share of a tile's input patch, read into registers in one
  // batch (the loads are all in flight together) and stored to shared
  // memory when the tile's turn comes; zeros stand outside the image.
  constexpr int PATCH = PH * ROW, N_LD = (PATCH + THREADS - 1) / THREADS;
  uint16_t held[N_LD];
  auto read_patch = [&](int tile) {
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    const int iy0 = 2 * ty * OH - p.pad_top, ix0 = 2 * tx * OW - p.pad_left;
#pragma unroll
    for (int i = 0; i < N_LD; ++i) {
      const int q = tid + i * THREADS;
      const int py = q / ROW, rem = q - py * ROW;
      const int iy = iy0 + py, ix = ix0 + rem / CIN;
      held[i] = 0;
      if (q < PATCH && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
        held[i] = __ldg(
            x + ((static_cast<long long>(b) * p.H + iy) * p.W + ix0) * CIN +
            rem);
    }
  };

  const int ly = tid128 / OW, lx = tid128 % OW;
  if (blockIdx.x < n_tiles) read_patch(blockIdx.x);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    const int oy0 = ty * OH, ox0 = tx * OW;
    __syncthreads();   // the last tile's staging and patch are read
#pragma unroll
    for (int i = 0; i < N_LD; ++i)
      if (tid + i * THREADS < PATCH) patch[tid + i * THREADS] = held[i];
    __syncthreads();
    // the next tile's reads travel while this one is multiplied and stored
    if (tile + gridDim.x < n_tiles) read_patch(tile + gridDim.x);
    // im2col: pixel tid128, K = (kh, kw, ci) as the weights lie; with two
    // warpgroups each builds every other 8-deep chunk (the first chunk a
    // constant, so that every offset folds)
    const uint16_t* src = patch + 2 * ly * ROW + 2 * lx * CIN;
    auto im2col = [&](auto first) {
#pragma unroll
      for (int kc = decltype(first)::value; kc < KP / 8; kc += S::WG) {
        uint32_t u[4];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = kc * 8 + e;
          const uint32_t v =
              k < K ? src[(k / (5 * CIN)) * ROW + k % (5 * CIN)] : 0u;
          if (e & 1)
            u[e >> 1] |= v << 16;
          else
            u[e >> 1] = v;
        }
        *reinterpret_cast<uint4*>(sm + (kc >> 3) * A_PANEL +
                                  igemm90::swz(tid128, kc & 7)) =
            make_uint4(u[0], u[1], u[2], u[3]);
      }
    };
    if (wg == 0)
      im2col(std::integral_constant<int, 0>{});
    else
      im2col(std::integral_constant<int, 1>{});
    igemm90::fence_async_proxy();
    __syncthreads();

    // warpgroup wg's 64-row halves: both at N = 64, its own at N = 128
    float acc[HALVES][N / 2];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[h][i] = 0.f;
    igemm90::wgmma_fence();
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int j = 0; j < STEPS; ++j)
        igemm90::Wgmma<N>::mma(
            acc[h],
            igemm90::make_desc(a_addr + (j >> 2) * A_PANEL +
                                   (wg + h) * 64 * 128 + (j & 3) * 32,
                               16, 1024),
            igemm90::make_desc(b_addr + j * 2048, B_PANEL, 1024));
    igemm90::wgmma_commit();
    igemm90::wgmma_wait<0>();
    __syncthreads();   // A is free: it becomes the staging tile

#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      igemm90::stage_out<P, N>(p, acc[h], stage, (wg + h) * 64, 0, col0(),
                               tid128);
    __syncthreads();
    uint16_t* y = static_cast<uint16_t*>(p.y);
    const int ldy = P::kOneColumnTile ? N : p.N;
    for (int q = tid; q < ROWS * (N / 8); q += THREADS) {
      const int px = q / (N / 8), c8 = (q % (N / 8)) * 8;
      const int oy = oy0 + px / OW, ox = ox0 + px % OW;
      if (oy < p.Ho && ox < p.Wo)
        *reinterpret_cast<uint4*>(
            y + ((static_cast<size_t>(b) * p.Ho + oy) * p.Wo + ox) * ldy +
            col0() + c8) =
            *reinterpret_cast<const uint4*>(stage + px * (N + 8) + c8);
    }
  }
}

// Launches kernel<CIN, N, P> over the output's Ho x Wo map of B images and
// p.N / N column tiles: at most BLOCKS_PER_SM blocks an SM, walking the
// tiles.
template <int CIN, int N, class P>
cudaError_t launch(const P& p, int B, cudaStream_t s) {
  using S = Shape<N>;
  auto k = kernel<CIN, N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int tiles_y = (p.Ho + OH - 1) / OH;
  const int tiles_x = (p.Wo + OW - 1) / OW;
  const int n_tiles = B * tiles_y * tiles_x;
  const int n_col = p.N / N;
  const int per_col = sms * S::BLOCKS_PER_SM / n_col > 0
                          ? sms * S::BLOCKS_PER_SM / n_col
                          : 1;
  const int grid = n_tiles < per_col ? n_tiles : per_col;
  k<<<dim3(grid, n_col), S::THREADS, S::SMEM, s>>>(p, tiles_y, tiles_x,
                                                   n_tiles);
  return cudaGetLastError();
}

}  // namespace down0
