// The two weight-gradient kernels (upconv3x3_bwd.cu's upconv3x3_dw and
// conv5x5_s2_bwd.cu's conv5x5_s2_dw): long-K products [Cin x Co] summed
// over every pixel of a map, into dw [TAPS][Cin][Co] (or, for the
// transposed convolution's caller, dw flipped and transposed) rounded once
// to w's type.  No atomics: the same bits every launch.
//
// Each op gives a policy, its parameter struct (derived from Chunk), and
// everything else is here: the main loops, the epilogue that writes dw, the
// reduction of the parts that do not fit a cluster, and the chunk loop.  A
// policy Op has
//   PRODUCTS  its products [Cin x Co] (the up-block 16, the conv 25)
//   TAPS      dw's taps (the up-block 9, the conv 25)
//   GROUPS    runs of products that read the same pixel of g (the up-block
//             16, a parity plane of g each; the conv 1); a per-product
//             block's tile lies in one run
//   THIN      its mma path may gather each row's element from its own
//             product (Cin <= 4: the RGB layers)
//   SPAN      the products whose sums one (ci, co) of dw's taps needs
//             together (the up-block 16, the conv 1)
//   SPLIT     CTAs of one cluster that share a part of K on the up-block's
//             on-chip fold (2, one per row parity of g); 1 for the conv
//   x_at(q, prod)   x's element offset of channel 0 that product `prod`
//                   reads for pixel q; -1 in the padding and past K
//   g_at(q, grp)    g's, for run `grp`; -1 past K
//   fold(d, first, out)  dw's taps from the sums d of products first ..
//                   first + SPAN - 1 of one (ci, co): out(tap, value)
//   launch_wgmma(tile_m, tile_n, B, stream, extra)  its wgmma path (the
//                   per-product kernel below with shift / load_x / load_g /
//                   maps, or the up-block's on-chip fold)
// and, for THIN, the staged gather of the RGB layers (can_stage,
// stage_split, stage_rows, staged_row, staged_pixel).
//
// Where the sums go.  A block owns an output tile over a part of K.  The
// parts of one tile run as one thread-block cluster of `cluster` CTAs (at
// most 8, times SPLIT): each CTA stages its f32 tile in its own shared
// memory (the ring is free by then), the CTAs split the tile's rows, and
// each adds the cluster's tiles in rank order through distributed shared
// memory (mapa / ld.shared::cluster) behind a cluster barrier.  Where one
// cluster holds every part (`groups` = parts / cluster = 1) that sum is
// dw: rounded and stored in the caller's layout, with no workspace and no
// second launch.  Only a plan with more parts than a cluster holds writes
// each cluster's f32 sum to the workspace [groups][TAPS][Cc][Co], which a
// second launch adds in the order 0..groups-1.  The up-block's per-product
// blocks (a block holds one of the 16 products, and a tap needs 4 of them:
// its mma and tile paths, and its wgmma path past the 4² maps, where they
// measured faster than the on-chip fold) keep the workspace
// [parts][16][Cc][Co] and fold the products into taps in that second
// launch.
//
// The workspace, where one is used, holds one chunk of input channels at a
// time: a launch walks Cin in chunks of `chunk` channels (the last may be
// shorter), each a launch of the products over [c0, c0 + Cc) and its
// reduction.  The caller sizes `chunk` so that the workspace stays under
// its cap (ops/kernels/conv.py wgrad_chunk); a plan with no workspace takes
// all of Cin in one chunk.
//
// Paths (the op's own rule picks one; codes in Path's order):
//  * wgmma (bf16, TMA boxes of one K slice of 64 pixels, 128-byte-swizzled
//    64-channel panels, m64nBNk16 with A = x transposed): one producer warp
//    keeps the ring's TMA loads in flight, each stage freed by an "empty"
//    mbarrier that the consumer warpgroups arrive on once their wgmma group
//    of that slice is done (wgmma_wait<1>: one group stays in flight).  The
//    per-product kernel is here (a block is a [BM x BN] tile of one
//    product); the up-block's on-chip fold, which computes 8 products of a
//    tile and folds them into taps, is in upconv3x3_bwd.cu on the same
//    pieces.
//  * mma (bf16, Co a multiple of 8, Cin a multiple of 8 -- or THIN): 64x64
//    tiles on mma.sync (WMMA 16x16x16), slices of 32 pixels (64 for the
//    staged RGB layers) staged through shared memory with the next slice's
//    loads in flight in registers.
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
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

template <int BM, int BN>
struct Tile {
  static constexpr int CONSUMERS = BM * 2;         // a warpgroup per 64 rows
  static constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
  static constexpr int A_STAGE = BM * 128, B_STAGE = BN * 128;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int STAGES = STAGE <= 24 * 1024 ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + hand alignment
  static constexpr int LD = BN + 4;                    // staged f32 rows
  static_assert(BM * LD * 4 <= STAGES * STAGE, "the f32 tile fits the ring");
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// every thread of every CTA of the cluster; release / acquire order the
// shared-memory writes before it against the reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the four f32 at this CTA's shared address `addr` (16-byte aligned), read
// from cluster CTA `rank`
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
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

// What every policy's parameters hold: the operands, the map K runs over,
// the plan (parts of K, of them `cluster` in one cluster) and the chunk
// of this launch, and dw with its layout
struct Chunk {
  const void* x;
  const void* g;
  float* ws;       // [groups][TAPS or PRODUCTS][Cc][Co]: this chunk's rows
  void* dw;        // [TAPS][Cin][Co], or flipped: [TAPS][Co][Cin] tap T-1-t
  int Cin, Co, K, parts, cluster;   // K = B*Hp*Wp pixels
  int Hp, Wp;
  int c0, Cc;      // the chunk: input channels [c0, c0 + Cc)
  int w_bf16, flip;
  int on_chip;     // the up-block's wgmma path folds its products on chip
  FastDiv hw, w;   // by Hp*Wp and by Wp

  // false when K does not fit an int
  bool set(const void* x_, const void* g_, void* dw_, void* ws_, int B,
           int Hp_, int Wp_, int Cin_, int Co_, int parts_, int cluster_,
           int w_bf16_, int flip_) {
    const long long k = static_cast<long long>(B) * Hp_ * Wp_;
    x = x_;
    g = g_;
    dw = dw_;
    ws = static_cast<float*>(ws_);
    Cin = Cin_;
    Co = Co_;
    K = static_cast<int>(k);
    parts = parts_;
    cluster = cluster_;
    Hp = Hp_;
    Wp = Wp_;
    w_bf16 = w_bf16_;
    flip = flip_;
    on_chip = 0;
    hw = fast_div(static_cast<unsigned>(Hp_ * Wp_));
    w = fast_div(static_cast<unsigned>(Wp_));
    return k < (1ll << 31);
  }
  __host__ __device__ int groups() const { return parts / cluster; }

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

  // element offset of dw's (tap, ci, co) of `taps` in the caller's layout
  __device__ __forceinline__ size_t out_at(int taps, int tap, int ci,
                                           int co) const {
    return flip ? (static_cast<size_t>(taps - 1 - tap) * Co + co) * Cin + ci
                : (static_cast<size_t>(tap) * Cin + ci) * Co + co;
  }
  __device__ __forceinline__ void store(int taps, int tap, int ci, int co,
                                        float v) const {
    const size_t at = out_at(taps, tap, ci, co);
    if (w_bf16)
      static_cast<uint16_t*>(dw)[at] = __bfloat16_as_ushort(__float2bfloat16(v));
    else
      static_cast<float*>(dw)[at] = v;
  }
  // co .. co + 3 of an unflipped dw with Co % 4 == 0, in one store
  __device__ __forceinline__ void store4(int taps, int tap, int ci, int co,
                                         float4 v) const {
    const size_t at = out_at(taps, tap, ci, co);
    if (w_bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(dw) + at) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                     *reinterpret_cast<const unsigned*>(&hi));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(dw) + at) = v;
    }
  }
};

enum Path { kTile = 0, kWgmma = 1, kMma = 2 };

// What a launch did, as bits (read back by t2i_*_dw_mode): dw written by
// the kernel itself, parts summed across a cluster, a workspace and its
// reduction, the up-block's 16 products folded on chip, its 32-column
// tile, the RGB layers' gather from staged rows, the producer-warp main loop
enum Mode {
  kDirect = 1, kCluster = 2, kWorkspace = 4, kFold = 8, kBn32 = 16,
  kStaged = 32, kProducer = 64
};

}  // namespace wgrad

namespace {

// The [BM x BN] tile `tile` of a per-product block: rows [m0, m0 + BM) of
// run grp, whose rows end at m_end, and output channels from co0
struct BlockTile {
  int grp, m0, m_end, co0;
};

template <class Op>
__device__ __forceinline__ BlockTile block_tile(const Op& p, int tile, int bm,
                                                int bn) {
  const int run = Op::PRODUCTS / Op::GROUPS * p.Cc;
  const int grp = tile % Op::GROUPS, t = tile / Op::GROUPS;
  const int n_tiles = (p.Co + bn - 1) / bn;
  return BlockTile{grp, grp * run + (t / n_tiles) * bm, (grp + 1) * run,
                   (t % n_tiles) * bn};
}

// --------------------------------------------------------------- epilogue --
// The block's f32 tile is staged in its shared memory at `stage`: `rows`
// rows of `bn` columns (a multiple of 4), row pitch `ld` floats (a multiple
// of 4, 16-byte-aligned rows); row r holds row m = row_m(r) of the chunk's
// [planes x Cc] rows (tap or product m / Cc, input channel c0 + m % Cc; m <
// 0: no row) and columns co0.. of Co.  Every thread of every CTA of the
// cluster calls this.  CTA `rank` of `csize` takes rows [rank * rows /
// csize, (rank + 1) * rows / csize) and adds the cluster's tiles there in
// rank order, four columns a thread (every rank's four loaded before the
// adds); then, where the cluster is every part (`direct`), rounds the sum
// into dw, else writes it f32 to workspace plane `group`.  In the flipped
// layout consecutive threads take consecutive rows (dw's input channels
// are then contiguous), else consecutive columns.
template <class Op, int NTHREADS, class RowM>
__device__ __forceinline__ void finish_tile(const Op& p, float* stage,
                                            int ld, int rows, int bn, int co0,
                                            int csize, bool direct,
                                            int planes, int group,
                                            RowM row_m) {
  __syncthreads();
  if (csize > 1) wgrad::cluster_sync();
  const int rank = csize > 1 ? static_cast<int>(blockIdx.x) : 0;
  const int r_lo = rank * rows / csize, r_hi = (rank + 1) * rows / csize;
  const int nr = r_hi - r_lo, c4n = bn / 4, n = nr * c4n;
  const uint32_t base = igemm90::smem_u32(stage);
  // the flipped layout is dw's only: the workspace is in the conv's
  const bool flip = p.flip && direct;
  const bool packed = !flip && p.Co % 4 == 0;
  // a row's four columns to their place: dw (rounded) or the workspace
  auto put = [&](int r, int co, float4 s) {
    const int m = row_m(r);
    const int pl = m / p.Cc, ci = p.c0 + m - pl * p.Cc;
    if (!direct) {
      float* out =
          p.ws + (static_cast<size_t>(group) * planes * p.Cc + m) * p.Co + co;
      if (packed) {
        *reinterpret_cast<float4*>(out) = s;
      } else {
        const float sv[4] = {s.x, s.y, s.z, s.w};
        for (int k = 0; k < 4 && co + k < p.Co; ++k) out[k] = sv[k];
      }
    } else if (packed) {
      p.store4(Op::TAPS, pl, ci, co, s);
    } else {
      const float sv[4] = {s.x, s.y, s.z, s.w};
      for (int k = 0; k < 4 && co + k < p.Co; ++k)
        p.store(Op::TAPS, pl, ci, co + k, sv[k]);
    }
  };
  // the cluster's sum, consecutive threads on consecutive columns (remote
  // reads of whole rows); in the flipped layout kept in this CTA's own
  // rows (which no other CTA reads) for the pass below
  if (csize > 1 || !flip) {
    for (int e = threadIdx.x; e < n; e += NTHREADS) {
      const int r = r_lo + e / c4n, co = co0 + 4 * (e % c4n);
      if (row_m(r) < 0 || co >= p.Co) continue;
      const int off = r * ld + co - co0;
      float4 s;
      if (csize > 1) {
        float4 v[wgrad::MAX_CLUSTER];
#pragma unroll
        for (int q = 0; q < wgrad::MAX_CLUSTER; ++q)
          if (q < csize)
            v[q] = wgrad::ld_cluster4(base + off * 4, static_cast<uint32_t>(q));
        s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < wgrad::MAX_CLUSTER; ++q)
          if (q < csize) {
            s.x += v[q].x;
            s.y += v[q].y;
            s.z += v[q].z;
            s.w += v[q].w;
          }
      } else {
        s = *reinterpret_cast<const float4*>(stage + off);
      }
      if (flip)
        *reinterpret_cast<float4*>(stage + off) = s;
      else
        put(r, co, s);
    }
  }
  // the flipped layout: consecutive threads on consecutive rows, whose
  // input channels are contiguous in dw
  if (flip) {
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += NTHREADS) {
      const int r = r_lo + e % nr, co = co0 + 4 * (e / nr);
      if (row_m(r) < 0 || co >= p.Co) continue;
      put(r, co, *reinterpret_cast<const float4*>(stage + r * ld + co - co0));
    }
  }
  // no CTA leaves while another still reads its shared memory
  if (csize > 1) wgrad::cluster_sync();
}

// ------------------------------------------------------------------ tile --
// A block computes its 64 x 64 tile blockIdx.y over part blockIdx.z *
// cluster + blockIdx.x of K in slices of 16 pixels, 4 x 4 outputs a thread
// on f32 FMA; any channels (masked), bf16 or f32 inputs.
constexpr int TILE_SLICE = 16;

template <class Op>
__device__ __forceinline__ int tile_part(const Op& p) {
  return static_cast<int>(blockIdx.z) * p.cluster +
         static_cast<int>(blockIdx.x);
}

// rows of the per-product kernels' [BM x BN] tiles: the product matrix's,
// which are dw's taps where SPAN is 1 (summed by the cluster and written
// by the epilogue), else products (the workspace, folded by the reduction)
template <class Op, int NTHREADS>
__device__ __forceinline__ void finish_products(const Op& p, float* st, int ld,
                                                int bm, int bn,
                                                const BlockTile& t) {
  constexpr bool TAPS = Op::SPAN == 1;
  finish_tile<Op, NTHREADS>(
      p, st, ld, bm, bn, t.co0, p.cluster, TAPS && p.groups() == 1,
      Op::PRODUCTS, TAPS ? static_cast<int>(blockIdx.z) : tile_part(p),
      [&](int r) { return t.m0 + r < t.m_end ? t.m0 + r : -1; });
}

template <class Op, class S>
__global__ void __launch_bounds__(256) dw_tile_kernel(Op p) {
  __shared__ __align__(16) float xs[TILE_SLICE][64];
  __shared__ __align__(16) float gs[TILE_SLICE][64];
  __shared__ __align__(16) float stage[64][68];
  const int tid = threadIdx.x;
  const BlockTile t = block_tile(p, blockIdx.y, 64, 64);
  const int2 span = wgrad::part(tile_part(p), p.parts,
                                (p.K + TILE_SLICE - 1) / TILE_SLICE);
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
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) stage[ty * 4 + i][tx * 4 + j] = acc[i][j];
  finish_products<Op, 256>(p, &stage[0][0], 68, 64, 64, t);
}

// ------------------------------------------------------------------- mma --
// A block computes its 64 x 64 tile blockIdx.y over its part of K in
// slices of 32 pixels; 8 warps of 16 x 32 outputs (two 16x16 fragments).
// Thread t copies chunk t % 8 (8 rows; 8 output channels) of pixel t / 8 of
// each 32 pixels; chunks past the run's rows or Co are zeros.  The 8 rows
// are one product's when Cc % 8 == 0 (one 16-byte load); THIN gathers them
// one element each, every row from its own product (Cin = 3: 75 rows in
// two tiles, not 25).  STAGED (THIN where 64 pixels are one row of g's map
// or two whole rows of 32): slices of 64 pixels, whose input rows (5 of
// 131 pixels, or 7 of 67) come first into shared memory in one coalesced
// pass of the whole block (the policy's stage_rows, loaded for the next
// slice while this one computes); the rows' elements are read from there.
// Every offset that does not move with the slice is worked out once a
// launch (the policy's staged_row, stage_split): per slice a thread adds
// one offset a pixel and one a row.
constexpr int MMA_SLICE = 32;
constexpr int STAGED_SLICE = 64;
constexpr int MMA_LD = 64 + 8;     // 144-byte rows
constexpr int STAGE_ELEMS = 2624;  // 5 rows of 131 pixels of <= 4 channels
constexpr int STAGE_LOADS = (STAGE_ELEMS + 255) / 256;

template <class Op, bool THIN, bool STAGED>
__global__ void __launch_bounds__(256) dw_mma_kernel(Op p) {
  using namespace nvcuda;
  constexpr int SL = STAGED ? STAGED_SLICE : MMA_SLICE, HALVES = SL / 32;
  __shared__ __align__(32) uint16_t xs[SL][MMA_LD];
  __shared__ __align__(32) uint16_t gs[SL][MMA_LD];
  __shared__ __align__(32) float stage[64][68];
  __shared__ __align__(16) uint16_t rows_s[STAGED ? 2 : 1]
                                          [STAGED ? STAGE_ELEMS : 1];
  const int tid = threadIdx.x;
  const BlockTile t = block_tile(p, blockIdx.y, 64, 64);
  const int2 span = wgrad::part(tile_part(p), p.parts, (p.K + SL - 1) / SL);
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

  // the thread's pixels r + 32h of a slice
  uint4 xr[HALVES], gr[HALVES];
  uint16_t sr[STAGED ? STAGE_LOADS : 1];
  // STAGED: each of the thread's rows' offset in the staged rows (-1: no
  // row), and each of its staged elements' row and offset along the row,
  // all fixed for the launch
  int roff[STAGED ? 8 : 1], ek[STAGED ? STAGE_LOADS : 1],
      erem[STAGED ? STAGE_LOADS : 1];
  if constexpr (STAGED) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      roff[j] = ci[j] >= 0 ? p.staged_row(prod[j], ci[j]) : -1;
#pragma unroll
    for (int l = 0; l < STAGE_LOADS; ++l)
      p.stage_split(tid + l * 256, ek[l], erem[l]);
  }
  auto load = [&](int s) {
    if constexpr (STAGED) {
      const wgrad::Pix q0 = p.pix(s * SL);
#pragma unroll
      for (int l = 0; l < STAGE_LOADS; ++l)
        sr[l] = p.stage_rows(q0, ek[l], erem[l]);
    }
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const wgrad::Pix q = p.pix(s * SL + r + 32 * h);
      xr[h] = gr[h] = make_uint4(0, 0, 0, 0);
      if constexpr (STAGED) {
      } else if constexpr (THIN) {
        unsigned v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const long long off = ci[j] >= 0 ? p.x_at(q, prod[j]) : -1;
          v[j] = off >= 0 ? x[off + ci[j]] : 0u;
        }
        xr[h] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                           v[4] | v[5] << 16, v[6] | v[7] << 16);
      } else {
        const long long off = ci[0] >= 0 ? p.x_at(q, prod[0]) : -1;
        if (off >= 0)
          xr[h] = __ldg(reinterpret_cast<const uint4*>(x + off + ci[0]));
      }
      const long long go = co_ok ? p.g_at(q, t.grp) : -1;
      if (go >= 0)
        gr[h] = __ldg(reinterpret_cast<const uint4*>(g + go + t.co0 + c8));
    }
  };
  // STAGED: the staged rows of slice s to buffer s & 1
  auto put_rows = [&](int s) {
    if constexpr (STAGED) {
#pragma unroll
      for (int l = 0; l < STAGE_LOADS; ++l)
        if (tid + l * 256 < STAGE_ELEMS) rows_s[s & 1][tid + l * 256] = sr[l];
    }
  };

  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  if (span.x < span.y) {
    load(span.x);
    put_rows(span.x);
  }
  if constexpr (STAGED) __syncthreads();
  for (int s = span.x; s < span.y; ++s) {
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      if constexpr (STAGED) {
        // K is whole slices here (can_stage): every pixel is on the map
        const uint16_t* px = rows_s[s & 1] + p.staged_pixel(r + 32 * h);
        unsigned v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = roff[j] >= 0 ? px[roff[j]] : 0u;
        xr[h] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                           v[4] | v[5] << 16, v[6] | v[7] << 16);
      }
      *reinterpret_cast<uint4*>(&xs[r + 32 * h][c8]) = xr[h];
      *reinterpret_cast<uint4*>(&gs[r + 32 * h][c8]) = gr[h];
    }
    __syncthreads();
    if (s + 1 < span.y) load(s + 1);
#pragma unroll
    for (int kk = 0; kk < SL; kk += 16) {
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
    if (s + 1 < span.y) put_rows(s + 1);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&stage[wm * 16][wn * 32 + j * 16], acc[j], 68,
                            wmma::mem_row_major);
  finish_products<Op, 256>(p, &stage[0][0], 68, 64, 64, t);
}

// ----------------------------------------------------------------- wgmma --
// The per-product kernel (the conv's, and the up-block's without the
// fold): a block computes its [BM x BN] tile (BM rows of one product, BN
// output channels) over its part of K, in slices of 64 pixels.  Shared
// memory per stage: A = 64 pixels x BM channels as BM/64 panels of [64
// pixels][128 bytes] (M-major), B = 64 pixels x BN channels as BN/64
// panels (N-major), both swizzled by TMA.  Warpgroup w < BM/64 computes
// rows 64w..; the last warp is the producer.
template <class Op, int BM, int BN>
__global__ void __launch_bounds__(BM * 2 + 32)
    dw_wgmma_kernel(Op p, const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap) {
  using T = wgrad::Tile<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[T::STAGES];
  __shared__ __align__(8) unsigned long long empty[T::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* staged = reinterpret_cast<float*>(smem_raw + (ring - raw));

  const int tid = threadIdx.x;
  const BlockTile t = block_tile(p, blockIdx.y, BM, BN);
  const int prod = t.m0 / p.Cc, ci0 = p.c0 + t.m0 - prod * p.Cc;
  const int2 span = wgrad::part(tile_part(p), p.parts,
                                (p.K + wgrad::SLICE - 1) / wgrad::SLICE);
  const int lo = span.x, n_iter = span.y - span.x;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), BM / 64);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7, tid128 = tid & 127;

  if (tid >= T::CONSUMERS) {
    // the producer: one thread asks for each slice's BM/64 + BN/64 panels
    // once the consumers have freed its stage
    if (tid == T::CONSUMERS) {
      const typename Op::Shift sh = p.shift(prod);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % T::STAGES;
        if (it >= T::STAGES)
          igemm90::mbar_wait(igemm90::smem_u32(&empty[s]),
                             ((it / T::STAGES) + 1) & 1);
        const uint32_t st = ring + s * T::STAGE;
        const uint32_t bar = igemm90::smem_u32(&full[s]);
        igemm90::mbar_expect_tx(bar, T::STAGE);
        const wgrad::Pix q = p.pix_in((lo + it) * wgrad::SLICE);
#pragma unroll
        for (int pa = 0; pa < BM / 64; ++pa)
          p.load_x(st + pa * wgrad::PANEL, &xmap, sh, ci0 + pa * 64, q, bar);
#pragma unroll
        for (int pb = 0; pb < BN / 64; ++pb)
          p.load_g(st + T::A_STAGE + pb * wgrad::PANEL, &gmap, sh,
                   t.co0 + pb * 64, q, bar);
      }
    }
  } else {
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % T::STAGES;
      igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (it / T::STAGES) & 1);
      const uint32_t st = ring + s * T::STAGE;
      igemm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < wgrad::SLICE / 16; ++k)
        igemm90::Wgmma<BN, 1>::mma(
            acc,
            igemm90::make_desc(st + wg * wgrad::PANEL + k * 2048,
                               wgrad::PANEL, 1024),
            igemm90::make_desc(st + T::A_STAGE + k * 2048, wgrad::PANEL,
                               1024));
      igemm90::wgmma_commit();
      // the group of slice it-1 is done: its stage is free
      igemm90::wgmma_wait<1>();
      if (it > 0 && tid128 == 0)
        wgrad::mbar_arrive(
            igemm90::smem_u32(&empty[(it - 1) % T::STAGES]));
    }
    igemm90::wgmma_wait<0>();
  }
  __syncthreads();   // every slice consumed: the ring is free

  if (tid < T::CONSUMERS) {
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int row = wg * 64 + igemm90::acc_row(tid128, i);
      const int col = igemm90::acc_col(tid128, i);
      *reinterpret_cast<float2*>(staged + row * T::LD + col) =
          make_float2(acc[i], acc[i + 1]);
    }
  }
  finish_products<Op, T::THREADS>(p, staged, T::LD, BM, BN, t);
}

// a launch of `kernel` on grid (csize, tiles, groups) in clusters of csize
// CTAs along x (a plain launch where csize is 1)
template <class... Params, class... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid,
                             int threads, size_t smem, int csize,
                             cudaStream_t s, Args... args) {
  if (csize == 1) {
    kernel<<<grid, threads, smem, s>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of csize CTAs of `kernel` (threads, smem bytes of
// dynamic shared memory) the card holds at once; -1 on an error
template <class... Params>
int max_clusters(void (*kernel)(Params...), int threads, int smem,
                 int csize) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 4096, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(
             &n, reinterpret_cast<const void*>(kernel), &cfg) == cudaSuccess
             ? n
             : -1;
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
  return launch_clustered(kernel, dim3(p.cluster, tiles, p.groups()),
                          T::THREADS, T::SMEM, p.cluster, s, p, xmap, gmap);
}

// ---------------------------------------------------------------- reduce --
// One thread per (ci, co) of the chunk (blockIdx.x; cc_co = Cc * Co
// elements) and run of SPAN planes (blockIdx.y): each plane's `parts`
// workspace planes added in the order 0..parts-1, then the fold F into
// dw's taps (F::fold; Plain where the planes are the taps already).
template <int TAPS_>
struct Plain {
  static constexpr int PRODUCTS = TAPS_, SPAN = 1, TAPS = TAPS_;
  template <class F>
  __device__ __forceinline__ static void fold(const float* d, int tap,
                                              F&& out) {
    out(tap, d[0]);
  }
};

template <class F, class Op>
__global__ void __launch_bounds__(256)
    dw_reduce_kernel(Op p, int parts, long long cc_co) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= cc_co) return;
  // 0 at compile time where one run is every plane (the up-block's fold):
  // its addresses then take as few registers as a kernel of its own
  const int first = F::SPAN == F::PRODUCTS ? 0 : blockIdx.y * F::SPAN;
  float d[F::SPAN];
#pragma unroll
  for (int k = 0; k < F::SPAN; ++k) {
    float s = 0.f;
    for (int z = 0; z < parts; ++z)
      s += p.ws[(static_cast<long long>(z) * F::PRODUCTS + first + k) * cc_co +
                i];
    d[k] = s;
  }
  const int ci = p.c0 + static_cast<int>(i / p.Co);
  const int co = static_cast<int>(i % p.Co);
  F::fold(d, first, [&](int tap, float v) { p.store(F::TAPS, tap, ci, co, v); });
}

template <class Op>
cudaError_t launch_staged(const Op& p, dim3 grid, cudaStream_t s) {
  if constexpr (Op::THIN)
    return launch_clustered(dw_mma_kernel<Op, true, true>, grid, 256, 0,
                            p.cluster, s, p);
  else
    return cudaErrorInvalidValue;
}

// dw (bf16 when p.w_bf16, else f32, in p's layout) from the op's x and g
// (bf16 when bf16, else f32) on `path`, on stream s: for each chunk of
// `chunk` input channels the products over p.parts parts of K in clusters
// of p.cluster, written to dw by the epilogue or, where p.parts / p.cluster
// > 1 or the path's blocks hold single products of a folding op, to p.ws
// and then summed (and folded) into the chunk's rows of dw.  tile_m x
// tile_n is read on the wgmma path only; the mma path needs chunk % 8 == 0
// unless one chunk is all of Cin.  Returns the CUDA error code (0 when
// launched) and the launch's Mode bits in *mode.
template <class Op>
int dw_launch(Op p, int path, bool bf16, int tile_m, int tile_n, int chunk,
              int B, cudaStream_t s, int* mode) {
  const bool on_chip = path == wgrad::kWgmma && p.on_chip;
  const bool per_product_fold = Op::SPAN > 1 && !on_chip;
  const int split = on_chip ? Op::SPLIT : 1;
  if (p.parts < 1 || chunk < 1 || p.cluster < 1 || p.parts % p.cluster ||
      p.cluster * split > wgrad::MAX_CLUSTER ||
      (per_product_fold && p.cluster != 1) || (p.flip && Op::TAPS != 25) ||
      (p.on_chip && (Op::SPAN == 1 || path != wgrad::kWgmma)))
    return cudaErrorInvalidValue;
  const bool ws = p.groups() > 1 || per_product_fold;
  if (ws && p.ws == nullptr) return cudaErrorInvalidValue;
  if (!ws && chunk < p.Cin) return cudaErrorInvalidValue;
  if (path == wgrad::kMma && chunk % 8 && chunk < p.Cin)
    return cudaErrorInvalidValue;
  if (path == wgrad::kMma && p.Cin % 8 && !Op::THIN)
    return cudaErrorInvalidValue;
  const bool staged = path == wgrad::kMma && p.Cin % 8 && Op::can_stage(p);
  int bits = (ws ? wgrad::kWorkspace : wgrad::kDirect) |
             (p.cluster * split > 1 ? wgrad::kCluster : 0) |
             (staged ? wgrad::kStaged : 0);
  for (int c0 = 0; c0 < p.Cin; c0 += chunk) {
    p.c0 = c0;
    p.Cc = p.Cin - c0 < chunk ? p.Cin - c0 : chunk;
    cudaError_t err;
    if (path == wgrad::kWgmma) {
      int extra = 0;
      err = p.launch_wgmma(tile_m, tile_n, B, s, &extra);
      bits |= extra | wgrad::kProducer;
    } else {
      const int run = Op::PRODUCTS / Op::GROUPS * p.Cc;
      const dim3 grid(p.cluster,
                      Op::GROUPS * ((run + 63) / 64) * ((p.Co + 63) / 64),
                      p.groups());
      if (path == wgrad::kMma && p.Cin % 8 == 0)
        err = launch_clustered(dw_mma_kernel<Op, false, false>, grid, 256, 0,
                               p.cluster, s, p);
      else if (staged)
        err = launch_staged(p, grid, s);
      else if (path == wgrad::kMma)
        err = launch_clustered(dw_mma_kernel<Op, Op::THIN, false>, grid, 256,
                               0, p.cluster, s, p);
      else if (bf16)
        err = launch_clustered(dw_tile_kernel<Op, uint16_t>, grid, 256, 0,
                               p.cluster, s, p);
      else
        err = launch_clustered(dw_tile_kernel<Op, float>, grid, 256, 0,
                               p.cluster, s, p);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!ws) continue;
    const long long cc_co = static_cast<long long>(p.Cc) * p.Co;
    if (per_product_fold) {
      dw_reduce_kernel<Op, Op><<<dim3(static_cast<unsigned>((cc_co + 255) / 256),
                                      Op::PRODUCTS / Op::SPAN),
                                 256, 0, s>>>(p, p.parts, cc_co);
    } else {
      dw_reduce_kernel<Plain<Op::TAPS>, Op>
          <<<dim3(static_cast<unsigned>((cc_co + 255) / 256), Op::TAPS), 256,
             0, s>>>(p, p.groups(), cc_co);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *mode = bits;
  return 0;
}

}  // namespace
