// The two weight-gradient kernels (upconv3x3_bwd.cu's upconv3x3_dw and
// conv5x5_s2_bwd.cu's conv5x5_s2_dw): long-K products [Cin x Co] summed
// over every pixel of a map, split into parts of K that write f32 partial
// sums to the caller's workspace, then added in the order 0..parts-1 by a
// second pass -- no atomics, the same bits every launch.
//
// Each op gives a policy, its parameter struct (derived from Chunk), and
// everything else is here: the three main loops, the reduction and the
// chunk loop.  A policy Op has
//   PRODUCTS  its products [Cin x Co] (the up-block 16, the conv 25)
//   GROUPS    runs of products that read the same pixel of g (the up-block
//             16, a parity plane of g each; the conv 1, every tap reads
//             g's pixel as it is); a block's tile lies in one run
//   THIN      its mma path may gather each row's element from its own
//             product (Cin <= 4: the RGB layers)
//   x_at(q, prod)   x's element offset of channel 0 that product `prod`
//                   reads for pixel q; -1 in the padding and past K
//   g_at(q, grp)    g's, for run `grp`; -1 past K
//   shift(prod)     what a wgmma block's product fixes for its loads (a
//                   Shift, taken once a block)
//   load_x / load_g the wgmma path's TMA loads of a 64-pixel slice from q
//   SPAN            the products whose sums one (ci, co) of dw's taps
//                   needs together (the up-block 16, the conv 1): one
//                   thread of the reduction adds SPAN products
//   fold(d, first, out)  dw's taps from the sums d of products first ..
//                   first + SPAN - 1 of one (ci, co): out(tap, value)
//   maps(xmap, gmap, B)  the wgmma path's tensor maps (host)
// Row m of the product matrix is product m / Cc, channel c0 + m % Cc: the
// workspace is [parts][PRODUCTS][Cc][Co].
//
// The workspace holds one chunk of input channels at a time: a launch walks
// Cin in chunks of `chunk` channels (the last one may be shorter), each a
// launch of the products over [c0, c0 + Cc), then the reduction of that
// chunk into dw's rows c0..c0+Cc-1.  The caller sizes `chunk` so that the
// workspace stays under its cap whatever Cin * Co (ops/kernels/conv.py
// wgrad_chunk).  A chunk holds every product of its channels, so the
// up-block's fold of 16 products into 9 taps stays inside one pass.
//
// Paths (the op's own rule picks one; codes in Path's order):
//  * wgmma (bf16, Cin and Co multiples of 64, a TMA box of one K slice):
//    a block computes a [BM x BN] tile of one product over a part of K in
//    slices of 64 pixels; both operands by TMA, one box a 64-channel panel
//    in the 128-byte-swizzled layout (16-byte chunk c of 128-byte row r at
//    chunk c ^ (r & 7)), A = x M-major, B = g N-major, m64nBNk16 with A
//    transposed (the descriptor's transpose bit), one warpgroup per 64
//    rows, a ring of stages as in igemm_sm90.cuh.
//  * mma (bf16, Co a multiple of 8, Cin a multiple of 8 -- or THIN): 64x64
//    tiles on mma.sync (WMMA 16x16x16), slices of 32 pixels staged through
//    shared memory with the next slice's loads in flight in registers.
//  * tile (f32 FMA, 64x64 tiles, slices of 16 pixels): f32 and ragged
//    channels.
//
// Included by one translation unit each: its kernels are that unit's own
// (anonymous namespace; their names carry the op's policy type).

#pragma once

#include "igemm_sm90.cuh"

namespace wgrad {

// n / d for n < 2^31 by a multiplication (the round-up method: for d > 1,
// mul = ceil(2^(31+l) / d) with l = ceil(log2 d), q = umulhi(n, mul) >> (l-1))
struct FastDiv {
  unsigned d, mul;
  int shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shift;
  }
};

inline FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0u, 0};
  if (d > 1) {
    int l = 0;
    while ((1ull << l) < d) ++l;
    const int p = 31 + l;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shift = p - 32;
  }
  return f;
}

// wgmma path: a K slice is 64 pixels; a panel is 64 pixels x 64 channels
// (128-byte rows, 128-byte swizzle)
constexpr int SLICE = 64;
constexpr int PANEL = 64 * 128;

template <int BM, int BN>
struct Tile {
  static constexpr int THREADS = BM * 2;           // a warpgroup per 64 rows
  static constexpr int A_STAGE = BM * 128, B_STAGE = BN * 128;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int STAGES = STAGE <= 24 * 1024 ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + hand alignment
};

// A slice of 64 pixels of an H x W map as one TMA box: a 64-pixel part of
// one row, 64 / W whole rows of one image, or 64 / (H*W) whole images; the
// wgmma paths take the maps where one of these is a box
inline bool boxes(int H, int W) {
  const long long hw = static_cast<long long>(H) * W;
  return W % 64 == 0 || (64 % W == 0 && (hw % 64 == 0 || 64 % hw == 0));
}

// (width, rows, images) of that box
struct Box {
  cuuint32_t w, rows, imgs;
};
inline Box box(int H, int W) {
  return Box{static_cast<cuuint32_t>(W < 64 ? W : 64),
             static_cast<cuuint32_t>(W >= 64 ? 1 : (64 / W < H ? 64 / W : H)),
             static_cast<cuuint32_t>(H * W < 64 ? 64 / (H * W) : 1)};
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Part z of `parts` of `total` slices: [lo, hi)
__device__ __forceinline__ int2 part(int z, int parts, int total) {
  return make_int2(
      static_cast<int>(static_cast<long long>(z) * total / parts),
      static_cast<int>(static_cast<long long>(z + 1) * total / parts));
}

// Pixel k of the Hp x Wp map the products sum over; b < 0 past the last
struct Pix {
  int b, i, j;
};

// What every policy's parameters hold: the operands, the map K runs over
// and the chunk of this launch
struct Chunk {
  const void* x;
  const void* g;
  float* ws;       // [parts][PRODUCTS][Cc][Co]: this chunk's rows
  int Cin, Co, K, parts;   // K = B*Hp*Wp pixels
  int Hp, Wp;
  int c0, Cc;      // the chunk: input channels [c0, c0 + Cc)
  FastDiv hw, w;   // by Hp*Wp and by Wp

  // false when K does not fit an int
  bool set(const void* x_, const void* g_, void* ws_, int B, int Hp_,
           int Wp_, int Cin_, int Co_, int parts_) {
    const long long k = static_cast<long long>(B) * Hp_ * Wp_;
    x = x_;
    g = g_;
    ws = static_cast<float*>(ws_);
    Cin = Cin_;
    Co = Co_;
    K = static_cast<int>(k);
    parts = parts_;
    Hp = Hp_;
    Wp = Wp_;
    hw = fast_div(static_cast<unsigned>(Hp_ * Wp_));
    w = fast_div(static_cast<unsigned>(Wp_));
    return k < (1ll << 31);
  }

  // pixel k < K
  __device__ __forceinline__ Pix pix_in(int k) const {
    const int b = static_cast<int>(hw.div(static_cast<unsigned>(k)));
    const int rem = k - b * Hp * Wp;
    const int i = static_cast<int>(w.div(static_cast<unsigned>(rem)));
    return Pix{b, i, rem - i * Wp};
  }
  __device__ __forceinline__ Pix pix(int k) const {
    return k < K ? pix_in(k) : Pix{-1, 0, 0};
  }
};

enum Path { kTile = 0, kWgmma = 1, kMma = 2 };

}  // namespace wgrad

namespace {

// The [BM x BN] tile of block blockIdx.x: rows [m0, m0 + BM) of run grp,
// whose rows end at m_end, and output channels from co0
struct BlockTile {
  int grp, m0, m_end, co0;
};

template <class Op>
__device__ __forceinline__ BlockTile block_tile(const Op& p, int bm, int bn) {
  const int run = Op::PRODUCTS / Op::GROUPS * p.Cc;
  const int grp = blockIdx.x % Op::GROUPS, t = blockIdx.x / Op::GROUPS;
  const int n_tiles = (p.Co + bn - 1) / bn;
  return BlockTile{grp, grp * run + (t / n_tiles) * bm, (grp + 1) * run,
                   (t % n_tiles) * bn};
}

// row m of part z's product matrix in the workspace
template <class Op>
__device__ __forceinline__ float* ws_row(const Op& p, int z, int m) {
  return p.ws + (static_cast<size_t>(z) * Op::PRODUCTS * p.Cc + m) * p.Co;
}

// ------------------------------------------------------------------ tile --
// A block computes its 64 x 64 tile over part blockIdx.y of K in slices of
// 16 pixels, 4 x 4 outputs a thread on f32 FMA; any channels (masked), bf16
// or f32 inputs.
constexpr int TILE_SLICE = 16;

template <class Op, class S>
__global__ void __launch_bounds__(256) dw_tile_kernel(Op p) {
  __shared__ __align__(16) float xs[TILE_SLICE][64];
  __shared__ __align__(16) float gs[TILE_SLICE][64];
  const int tid = threadIdx.x;
  const BlockTile t = block_tile(p, 64, 64);
  const int2 span =
      wgrad::part(blockIdx.y, p.parts, (p.K + TILE_SLICE - 1) / TILE_SLICE);
  const S* x = static_cast<const S*>(p.x);
  const S* g = static_cast<const S*>(p.g);
  // loads: row (and output channel) tid % 64 of pixels tid / 64 + 4i
  const int ch = tid & 63, r0 = tid >> 6;
  const bool m_ok = t.m0 + ch < t.m_end, co_ok = t.co0 + ch < p.Co;
  const int prod = m_ok ? (t.m0 + ch) / p.Cc : 0;
  const int ci = p.c0 + (t.m0 + ch) - prod * p.Cc;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = span.x; s < span.y; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * i;
      const wgrad::Pix q = p.pix(s * TILE_SLICE + r);
      const long long xo = m_ok ? p.x_at(q, prod) : -1;
      const long long go = co_ok ? p.g_at(q, t.grp) : -1;
      xs[r][ch] = xo >= 0 ? igemm::to_float(x[xo + ci]) : 0.f;
      gs[r][ch] = go >= 0 ? igemm::to_float(g[go + t.co0 + ch]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TILE_SLICE; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = t.m0 + ty * 4 + i;
    if (m >= t.m_end) break;
    float* out = ws_row(p, blockIdx.y, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = t.co0 + tx * 4 + j;
      if (co < p.Co) out[co] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------- mma --
// A block computes its 64 x 64 tile over part blockIdx.y of K in slices of
// 32 pixels; 8 warps of 16 x 32 outputs (two 16x16 fragments).  Thread t
// copies chunk t % 8 (8 rows; 8 output channels) of pixel t / 8 of each
// slice; chunks past the run's rows or Co are zeros.  The 8 rows are one
// product's when Cc % 8 == 0 (one 16-byte load); THIN gathers them one
// element each, every row from its own product (Cin = 3: 75 rows in two
// tiles, not 25).
constexpr int MMA_SLICE = 32;
constexpr int MMA_LD = 64 + 8;   // 144-byte rows

template <class Op, bool THIN>
__global__ void __launch_bounds__(256) dw_mma_kernel(Op p) {
  using namespace nvcuda;
  __shared__ __align__(32) uint16_t xs[MMA_SLICE][MMA_LD];
  __shared__ __align__(32) uint16_t gs[MMA_SLICE][MMA_LD];
  __shared__ __align__(32) float stage[64][64];
  const int tid = threadIdx.x;
  const BlockTile t = block_tile(p, 64, 64);
  const int2 span =
      wgrad::part(blockIdx.y, p.parts, (p.K + MMA_SLICE - 1) / MMA_SLICE);
  const uint16_t* x = static_cast<const uint16_t*>(p.x);
  const uint16_t* g = static_cast<const uint16_t*>(p.g);
  const int r = tid >> 3, c8 = (tid & 7) * 8;
  const bool co_ok = t.co0 + c8 < p.Co;
  // (product, input channel) of each of the thread's 8 rows; ci < 0 past
  // the run's rows
  int prod[8], ci[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = t.m0 + c8 + j;
    prod[j] = m < t.m_end ? m / p.Cc : 0;
    ci[j] = m < t.m_end ? p.c0 + m - prod[j] * p.Cc : -1;
  }

  uint4 xr, gr;
  auto load = [&](int s) {
    const wgrad::Pix q = p.pix(s * MMA_SLICE + r);
    xr = gr = make_uint4(0, 0, 0, 0);
    if constexpr (THIN) {
      unsigned v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long off = ci[j] >= 0 ? p.x_at(q, prod[j]) : -1;
        v[j] = off >= 0 ? x[off + ci[j]] : 0u;
      }
      xr = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                      v[4] | v[5] << 16, v[6] | v[7] << 16);
    } else {
      const long long off = ci[0] >= 0 ? p.x_at(q, prod[0]) : -1;
      if (off >= 0) xr = __ldg(reinterpret_cast<const uint4*>(x + off + ci[0]));
    }
    const long long go = co_ok ? p.g_at(q, t.grp) : -1;
    if (go >= 0)
      gr = __ldg(reinterpret_cast<const uint4*>(g + go + t.co0 + c8));
  };

  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  if (span.x < span.y) load(span.x);
  for (int s = span.x; s < span.y; ++s) {
    *reinterpret_cast<uint4*>(&xs[r][c8]) = xr;
    *reinterpret_cast<uint4*>(&gs[r][c8]) = gr;
    __syncthreads();
    if (s + 1 < span.y) load(s + 1);
#pragma unroll
    for (int kk = 0; kk < MMA_SLICE; kk += 16) {
      // A[m][k] = xs[k][m]: column-major with rows of MMA_LD
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa;
      wmma::load_matrix_sync(
          fa, reinterpret_cast<const __nv_bfloat16*>(&xs[kk][wm * 16]),
          MMA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(
            fb, reinterpret_cast<const __nv_bfloat16*>(&gs[kk][wn * 32 + j * 16]),
            MMA_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&stage[wm * 16][wn * 32 + j * 16], acc[j], 64,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < 64 * 64; e += 256) {
    const int m = t.m0 + (e >> 6), co = t.co0 + (e & 63);
    if (m < t.m_end && co < p.Co)
      ws_row(p, blockIdx.y, m)[co] = stage[e >> 6][e & 63];
  }
}

// ----------------------------------------------------------------- wgmma --
// A block computes its [BM x BN] tile (BM rows of one product, BN output
// channels) over part blockIdx.y of K, in slices of 64 pixels.  Shared
// memory per stage: A = 64 pixels x BM channels as BM/64 panels of [64
// pixels][128 bytes] (M-major), B = 64 pixels x BN channels as BN/64 panels
// (N-major), both swizzled by TMA.
template <class Op, int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
    dw_wgmma_kernel(Op p, const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap) {
  using T = wgrad::Tile<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[T::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const BlockTile t = block_tile(p, BM, BN);
  const int prod = t.m0 / p.Cc, ci0 = p.c0 + t.m0 - prod * p.Cc;
  const typename Op::Shift sh = p.shift(prod);
  const int z = blockIdx.y;
  const int2 span = wgrad::part(z, p.parts, (p.K + wgrad::SLICE - 1) /
                                                wgrad::SLICE);
  const int lo = span.x, n_iter = span.y - span.x;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s)
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 asks for the slice's BM/64 + BN/64 panels
  auto issue = [&](int stage, int slice) {
    const uint32_t st = ring + stage * T::STAGE;
    const uint32_t bar = igemm90::smem_u32(&full[stage]);
    igemm90::mbar_expect_tx(bar, T::STAGE);
    const wgrad::Pix q = p.pix_in(slice * wgrad::SLICE);
#pragma unroll
    for (int pa = 0; pa < BM / 64; ++pa)
      p.load_x(st + pa * wgrad::PANEL, &xmap, sh, ci0 + pa * 64, q, bar);
#pragma unroll
    for (int pb = 0; pb < BN / 64; ++pb)
      p.load_g(st + T::A_STAGE + pb * wgrad::PANEL, &gmap, sh,
               t.co0 + pb * 64, q, bar);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7, tid128 = tid & 127;

  if (tid == 0)
    for (int s = 0; s < T::STAGES - 1 && s < n_iter; ++s) issue(s, lo + s);
  for (int it = 0; it < n_iter; ++it) {
    igemm90::mbar_wait(igemm90::smem_u32(&full[it % T::STAGES]),
                       (it / T::STAGES) & 1);
    __syncthreads();   // every warpgroup is past slice it-1: its stage is free
    const uint32_t st = ring + (it % T::STAGES) * T::STAGE;
    igemm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < wgrad::SLICE / 16; ++k)
      igemm90::Wgmma<BN, 1>::mma(
          acc,
          igemm90::make_desc(st + wg * wgrad::PANEL + k * 2048, wgrad::PANEL,
                             1024),
          igemm90::make_desc(st + T::A_STAGE + k * 2048, wgrad::PANEL, 1024));
    igemm90::wgmma_commit();
    const int nxt = it + T::STAGES - 1;
    if (tid == 0 && nxt < n_iter) issue(nxt % T::STAGES, lo + nxt);
    igemm90::wgmma_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int m = t.m0 + wg * 64 + igemm90::acc_row(tid128, i);
    const int co = t.co0 + igemm90::acc_col(tid128, i);
    *reinterpret_cast<float2*>(ws_row(p, z, m) + co) =
        make_float2(acc[i], acc[i + 1]);
  }
}

template <class Op, int BM, int BN>
cudaError_t launch_dw_wgmma(const Op& p, int B, cudaStream_t s) {
  using T = wgrad::Tile<BM, BN>;
  auto kernel = dw_wgmma_kernel<Op, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap = {}, gmap = {};
  err = p.maps(&xmap, &gmap, B);
  if (err != cudaSuccess) return err;
  const int tiles = Op::GROUPS * (Op::PRODUCTS / Op::GROUPS * p.Cc / BM) *
                    (p.Co / BN);
  kernel<<<dim3(tiles, p.parts), T::THREADS, T::SMEM, s>>>(p, xmap, gmap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- reduce --
// One thread per (ci, co) of the chunk (blockIdx.x; cc_co = Cc * Co
// elements; `dw` points at row c0 of tap 0, taps cico = Cin * Co apart)
// and run of SPAN products (blockIdx.y): each product's parts added in the
// order 0..parts-1, then the op's fold into dw's taps.
template <class Op, class O>
__global__ void __launch_bounds__(256)
    dw_reduce_kernel(const float* ws, O* dw, int parts, long long cc_co,
                     long long cico) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= cc_co) return;
  // 0 at compile time where one run is every product (the up-block): its
  // addresses then take as few registers as a kernel of its own
  const int first = Op::SPAN == Op::PRODUCTS ? 0 : blockIdx.y * Op::SPAN;
  float d[Op::SPAN];
#pragma unroll
  for (int k = 0; k < Op::SPAN; ++k) {
    float s = 0.f;
    for (int z = 0; z < parts; ++z)
      s += ws[(static_cast<long long>(z) * Op::PRODUCTS + first + k) * cc_co +
              i];
    d[k] = s;
  }
  Op::fold(d, first, [&](int tap, float v) {
    O* out = dw + tap * cico + i;
    if constexpr (std::is_same<O, uint16_t>::value)
      *out = __bfloat16_as_ushort(__float2bfloat16(v));
    else
      *out = v;
  });
}

// dw (bf16 when w_bf16, else f32) from the op's x and g (bf16 when bf16,
// else f32) on `path`, on stream s: for each chunk of `chunk` input
// channels the products in p.parts parts of K each into p.ws, then their
// sum and fold into the chunk's rows of dw.  tile_m x tile_n (64 or 128
// each, dividing Cin, chunk and Co) is read on the wgmma path only; the mma
// path needs chunk % 8 == 0 unless one chunk is all of Cin.  Returns the
// CUDA error code (0 when launched).
template <class Op>
int dw_launch(Op p, int path, bool bf16, bool w_bf16, int tile_m, int tile_n,
              int chunk, int B, void* dw, cudaStream_t s) {
  if (p.parts < 1 || chunk < 1 || p.ws == nullptr) return cudaErrorInvalidValue;
  if (path == wgrad::kWgmma &&
      ((tile_m != 64 && tile_m != 128) || (tile_n != 64 && tile_n != 128) ||
       p.Cin % tile_m || chunk % tile_m || p.Co % tile_n))
    return cudaErrorInvalidValue;
  if (path == wgrad::kMma && chunk % 8 && chunk < p.Cin)
    return cudaErrorInvalidValue;
  if (path == wgrad::kMma && p.Cin % 8 && !Op::THIN)
    return cudaErrorInvalidValue;
  const long long cico = static_cast<long long>(p.Cin) * p.Co;
  for (int c0 = 0; c0 < p.Cin; c0 += chunk) {
    p.c0 = c0;
    p.Cc = p.Cin - c0 < chunk ? p.Cin - c0 : chunk;
    cudaError_t err;
    if (path == wgrad::kWgmma) {
      if (tile_m == 64)
        err = tile_n == 64 ? launch_dw_wgmma<Op, 64, 64>(p, B, s)
                           : launch_dw_wgmma<Op, 64, 128>(p, B, s);
      else
        err = tile_n == 64 ? launch_dw_wgmma<Op, 128, 64>(p, B, s)
                           : launch_dw_wgmma<Op, 128, 128>(p, B, s);
    } else {
      const int run = Op::PRODUCTS / Op::GROUPS * p.Cc;
      const dim3 grid(Op::GROUPS * ((run + 63) / 64) * ((p.Co + 63) / 64),
                      p.parts);
      if (path == wgrad::kMma && p.Cin % 8 == 0)
        dw_mma_kernel<Op, false><<<grid, 256, 0, s>>>(p);
      else if (path == wgrad::kMma)
        dw_mma_kernel<Op, Op::THIN><<<grid, 256, 0, s>>>(p);
      else if (bf16)
        dw_tile_kernel<Op, uint16_t><<<grid, 256, 0, s>>>(p);
      else
        dw_tile_kernel<Op, float><<<grid, 256, 0, s>>>(p);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cc_co = static_cast<long long>(p.Cc) * p.Co;
    const dim3 blocks(static_cast<unsigned>((cc_co + 255) / 256),
                      Op::PRODUCTS / Op::SPAN);
    const size_t at = static_cast<size_t>(c0) * p.Co;
    if (w_bf16)
      dw_reduce_kernel<Op, uint16_t><<<blocks, 256, 0, s>>>(
          p.ws, static_cast<uint16_t*>(dw) + at, p.parts, cc_co, cico);
    else
      dw_reduce_kernel<Op, float><<<blocks, 256, 0, s>>>(
          p.ws, static_cast<float*>(dw) + at, p.parts, cc_co, cico);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace
