// The backward of the fused nearest-upsample x2 + 3x3 convolution
// (upconv3x3.cu) for Hopper (sm_90a): the input gradient dx and the weight
// gradient dw of
//
//   y = conv_3x3_SAME(upsample2_nearest(x), w)
//
// for the cotangent g [B,2H,2W,Co] (the activation's derivative and the
// scale already applied by the caller), x [B,H,W,Cin] NHWC, w [3,3,Cin,Co].
// bf16 or f32 in and out, f32 accumulation.  As in the forward, the
// upsampled map never exists: both adjoints are written over the combined
// 2x2 taps Cw[py,px,a,c] = wc[((py*2+px)*2+a)*2+c] of csrc/upconv3x3.cu,
//
//   dx[b,i,j,:] = sum_{py,px,a,c} g[b, 2(i-py-a+1)+py, 2(j-px-c+1)+px, :]
//                 . Cw[py,px,a,c]^T            (g zero outside the map)
//   dCw[py,px,a,c] = sum_{b,m,n} x[b, m+py+a-1, n+px+c-1, :]^T
//                    . g[b, 2m+py, 2n+px, :]   (x zero outside the map)
//   dW[kh,kw] = sum UNCOMBINE[py][a][kh] * UNCOMBINE[px][c][kw] * dCw[...]
//
// each 16/36 of the multiply-adds of the adjoints of the convolution over
// the upsampled map.
//
// Replaces text_to_image_tpu/ops/pallas/conv.py _parity_dx and _parity_dw
// (reached from the custom VJPs _upconv_bwd and _upconv_bias_bwd), which
// the JAX package leaves to XLA as four 2x2 convolutions over g's parity
// planes and sixteen [Cin x Co] products.
//
// Bound on the H100 SXM, bf16, B = 64: dx and dw each do 2*16*B*H*W*Cin*Co
// operations, as many as the forward: 17.2 GFLOP (0.017 ms at 989 TFLOP/s)
// for every Stage-I up-block, 68.7 GFLOP (0.069 ms) for the first three
// Stage-II ones and 137 GFLOP (0.139 ms) for the last, 128x128x64->64, whose
// g (537 MB) and x (134 MB) take 0.200 ms at 3.35 TB/s: bound by bytes
// there, by operations elsewhere.
//
// upconv3x3_dx: one implicit GEMM, M = B*H*W pixels of dx, N = Cin, K = 16
// taps x Co.  Row (b, i, j) of tap (py, px, a, c) reads g's parity plane
// (py, px) at (i+1-py-a, j+1-px-c), zero outside it.  Paths, from shapes,
// types and alignment only (dx_path; the wrapper mirrors the rule):
//  * wgmma: bf16, Cin a multiple of 64, 16-byte-aligned g, combined
//    weights and dx, and Co a multiple of 64 -- or of 32 on a map where a
//    tile of 128 rows is one TMA box (C-PGGAN's Co 32).  Where a tile is a
//    box, the kernels of upconv_dx.cuh: A by TMA from g's parity planes,
//    the weights K-major straight from the combined weights, a producer
//    warp, 64- or 32-channel K slices, and by the caller's plan (conv.py
//    dx_plan) either the ring kernel (128 x 64/128/256 tiles, the parts of
//    K summed in one cluster) or, at Co 32 and 64 on the 128^2 maps, the
//    transposed kernel (dx^T on m64n128k16, the four taps of a plane from
//    one staged patch).  Maps with no box keep the forward's gather loop
//    (igemm_sm90.cuh: one table read and one bit test per tap and 16-byte
//    cp.async copy, the weights transposed to [16][Co][Cin] by
//    dx_transpose_kernel, K split over whole taps through a workspace and
//    a fixed-order reduce).
//  * pipelined / tile (igemm.cuh, mma.sync / f32 FMA): otherwise, on the
//    transposed weights.
// The gather loop alone took 1.1023 ms on the H100 for a Stage-I plus
// Stage-II G step's 8 calls (2.3x their bound), and Co 32 ran on mma.sync
// at 10x its bound (tools/bench_kernels.py --upconv --grad).
//
// upconv3x3_dw: sixteen GEMMs [Cin x Co] over K = B*H*W pixels of a parity
// plane -- a long-K reduction with few outputs, on the weight-gradient
// kernels of wgrad.cuh (shared with conv5x5_s2_bwd.cu; this file gives
// their policy Dw and the on-chip fold).  No atomics, the same bits every
// run; the parts of K are the caller's (dw_plan).
//  * wgmma (bf16, Cin a multiple of 64 and Co of 32, 16-byte-aligned x and
//    g, a map where a slice of 64 pixels is a part of one image row, whole
//    rows or whole images: wgrad::boxes, every main-path map): both
//    operands are pixel rows of 64 channels (128 bytes) in the
//    128-byte-swizzled layout, A = x shifted by (py+a-1, px+c-1) M-major, B
//    = g's plane N-major; m64nBNk16 with A transposed (the descriptor's
//    transpose bit); both by TMA, x as [B][H][W][Cin] boxes shifted by the
//    product's offset (the tensor map zero-fills past every edge), g as
//    [B][H][2][W][2*Co] so that the plane (py, px) is a coordinate; a
//    producer warp keeps the ring full.  Two designs, by shape (dw_plan):
//    - the on-chip fold (dw_fold_kernel, below; K of at most 16 slices --
//      the 4² maps -- and Co 32, which took the 64-wide mma.sync tile
//      before): a CTA computes the 8 products of one row parity of g for
//      64 input x 64 or 32 output channels (the 32-wide g panel in the
//      64-byte swizzle), folds them into partial taps in shared memory,
//      and the cluster of the two parities (and up to 4 parts) adds them
//      in rank order through distributed shared memory and writes dw:
//      no workspace where one cluster holds the parts;
//    - the per-product blocks (wgrad.cuh dw_wgmma_kernel; every other
//      shape, where they measured faster: tools/conv_plan_sweep.py --ops
//      dw): a block computes one product's [BM x BN] tile over a part of
//      K, writes its f32 sums to the workspace [parts][16][Cc][Co], and
//      dw_reduce_kernel adds the parts in the order 0..parts-1 and folds
//      the 16 products into the nine taps in the same pass.
//    A first version copied both operands by cp.async (the forward's notes
//    measured that feed at ~10 bytes a clock an SM): on the H100 Stage-II's
//    four dw calls took 0.31-1.34 ms, 4.5-6.7x their bound; by TMA
//    0.15-0.42 ms (tools/bench_kernels.py).
//  * mma (bf16 with Cin and Co multiples of 8, 16-byte-aligned x and g: the
//    maps with no box): 64x64 per-product tiles on mma.sync (WMMA
//    16x16x16), slices of 32 pixels staged through shared memory with the
//    next slice's 16-byte loads in flight in registers, A read
//    column-major from the pixel rows; each thread finds its pixel (b, m,
//    n) with two multiplications (FastDiv).
//  * tile (f32 FMA, 64x64 per-product tiles, slices of 16 pixels): every
//    other shape, f32 (tensor cores off) and ragged channels.
// The per-product paths walk Cin in chunks of Cc channels, one launch and
// one reduction each (wgrad.cuh), so that their workspace stays under the
// caller's cap at any Cin * Co.  Whichever the path, the weights' gradient
// is summed in f32 and rounded once to w's type.

#include "upconv_dx.cuh"

namespace {

using igemm::Common;

// ------------------------------------------------------------------ dx ----
// igemm::Common with K channels = Co and N = Cin: a = g, w = Cw^T
// [16][Co][Cin], y = dx; 16 taps, tap t = ((py*2+px)*2+a)*2+c.
struct UpconvDx : Common {
  int H, W;   // dx's map; g's is 2H x 2W

  struct Row {
    int b, i, j;   // b < 0: past the last row
  };

  __device__ Row row(int r) const {
    Row q{-1, 0, 0};
    if (r < M) {
      const int hw = H * W;
      q.b = r / hw;
      const int rem = r - q.b * hw;
      q.i = rem / W;
      q.j = rem - q.i * W;
    }
    return q;
  }

  // tap t reads g's plane (py, px) at (i+1-py-a, j+1-px-c)
  __device__ static int dy(int t) { return 1 - (t >> 3) - ((t >> 1) & 1); }
  __device__ static int dx(int t) { return 1 - ((t >> 2) & 1) - (t & 1); }

  __device__ long long a_off(const Row& q, int tap, int ci) const {
    const int m = q.i + dy(tap), n = q.j + dx(tap);
    if (q.b < 0 || m < 0 || m >= H || n < 0 || n >= W) return -1;
    return ((static_cast<long long>(q.b) * 2 * H + 2 * m + (tap >> 3)) *
                (2 * W) +
            2 * n + ((tap >> 2) & 1)) *
               Cin +
           ci;
  }
  __device__ float add(int, int) const { return 0.f; }

  // igemm_sm90.cuh: the row's base is g's pixel (2i, 2j); tap t sits
  // (2-py-2a, 2-px-2c) from it
  __device__ igemm90::Gather gather(int r, int) const {
    const Row q = row(r);
    if (q.b < 0) return igemm90::Gather{0, 0, 0u};
    unsigned taps = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int m = q.i + dy(t), n = q.j + dx(t);
      if (m >= 0 && m < H && n >= 0 && n < W) taps |= 1u << t;
    }
    return igemm90::Gather{
        ((static_cast<long long>(q.b) * 2 * H + 2 * q.i) * (2 * W) + 2 * q.j) *
            Cin,
        0, taps};
  }
  __device__ long long row_off(const igemm90::Gather& q, int) const {
    return q.base;
  }
  __device__ long long tap_off(int, int t) const {
    const int oy = 2 - (t >> 3) - 2 * ((t >> 1) & 1);
    const int ox = 2 - ((t >> 2) & 1) - 2 * (t & 1);
    return (static_cast<long long>(oy) * 2 * W + ox) * Cin;
  }
  __device__ int slices(int) const { return Cin / igemm90::BK; }
  static constexpr bool kOneWeightMatrix = true;
  __device__ int w_row(int, int tap) const { return tap * Cin; }
};

enum DxPath { kDxTile = 0, kDxPipelined = 1, kDxWgmma = 2 };

UpconvDx make_dx(const void* g, const void* wct, void* dx, int B, int H,
                 int W, int Cin, int Co, int bf16) {
  const int vec = bf16 ? 8 : 4;
  UpconvDx p;
  p.a = g;
  p.w = wct;
  p.y = dx;
  p.M = B * H * W;
  p.N = Cin;
  p.Cin = Co;
  p.taps = 16;
  p.act = igemm::kNone;
  p.vec_a = Co % vec == 0 && igemm::aligned16(g);
  p.vec_w = Cin % vec == 0 && igemm::aligned16(wct);
  p.vec_y = Cin % vec == 0 && igemm::aligned16(dx);
  p.H = H;
  p.W = W;
  return p;
}

// wgmma where a K slice is 64 channels of g (the gather loop takes those
// on any map) or 32 on a map with a box; mma.sync or FMA otherwise
int dx_path(const UpconvDx& p, int H, int W, bool bf16) {
  const bool aligned = igemm::aligned16(p.a) && igemm::aligned16(p.w) &&
                       igemm::aligned16(p.y);
  if (bf16 && aligned && p.N % 64 == 0 &&
      (p.Cin % 64 == 0 || (p.Cin % 32 == 0 && dx90::boxes(H, W))))
    return kDxWgmma;
  return bf16 && p.vec_a && p.vec_w && p.vec_y ? kDxPipelined : kDxTile;
}

// wct[t][co][ci] = wc[t][ci][co]: 32 x 32 tiles through shared memory
template <class S>
__global__ void __launch_bounds__(256)
    dx_transpose_kernel(const S* wc, S* wct, int Cin, int Co) {
  __shared__ S tile[32][33];
  const size_t plane = static_cast<size_t>(Cin) * Co;
  const S* src = wc + blockIdx.z * plane;
  S* dst = wct + blockIdx.z * plane;
  const int co0 = blockIdx.x * 32, ci0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int ci = ci0 + r, co = co0 + tx;
    if (ci < Cin && co < Co) tile[r][tx] = src[static_cast<size_t>(ci) * Co + co];
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int co = co0 + r, ci = ci0 + tx;
    if (ci < Cin && co < Co) dst[static_cast<size_t>(co) * Cin + ci] = tile[tx][r];
  }
}

// ------------------------------------------------------------------ dw ----
// The policy of wgrad.cuh: 16 products p = ((py*2+px)*2+a)*2+c, x shifted
// by (py+a-1, px+c-1) against g's parity plane (py, px), row m = p*Cc +
// (ci - c0) on the per-product paths; each product reads its own plane of g
// (a run each); K runs over x's map H x W (Chunk's Hp x Wp).
struct Dw : wgrad::Chunk {
  static constexpr int PRODUCTS = 16, TAPS = 9, GROUPS = 16, SPAN = 16,
                       SPLIT = 2;
  static constexpr bool THIN = false;

  __device__ __forceinline__ static int dy(int p) {
    return (p >> 3) + ((p >> 1) & 1) - 1;
  }
  __device__ __forceinline__ static int dx(int p) {
    return ((p >> 2) & 1) + (p & 1) - 1;
  }
  __device__ __forceinline__ long long x_at(const wgrad::Pix& q,
                                            int prod) const {
    const int iy = q.i + dy(prod), ix = q.j + dx(prod);
    if (q.b < 0 || iy < 0 || iy >= Hp || ix < 0 || ix >= Wp) return -1;
    return ((static_cast<long long>(q.b) * Hp + iy) * Wp + ix) * Cin;
  }
  __device__ __forceinline__ long long g_at(const wgrad::Pix& q,
                                            int prod) const {
    if (q.b < 0) return -1;
    return ((static_cast<long long>(q.b) * 2 * Hp + 2 * q.i + (prod >> 3)) *
                (2 * Wp) +
            2 * q.j + ((prod >> 2) & 1)) *
           Co;
  }

  // dW[kh][kw] = sum_p U[py][a][kh] * U[px][c][kw] * d[p], the products in
  // the order p = 0..15.  UNCOMBINE as bit masks over kh: U[py][a] =
  // {{kh0}, {kh1, kh2}} for py = 0, {{kh0, kh1}, {kh2}} for py = 1: for
  // each py every kh has one a, a = (kh >= 1 + py).
  __device__ __forceinline__ static bool uncombine(int p, int a, int k) {
    const int mask = p == 0 ? (a == 0 ? 1 : 6) : (a == 0 ? 3 : 4);
    return (mask >> k) & 1;
  }
  template <class F>
  __device__ __forceinline__ static void fold(const float* d, int,
                                              F&& out) {
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        float v = 0.f;
#pragma unroll
        for (int prod = 0; prod < 16; ++prod)
          if (uncombine(prod >> 3, (prod >> 1) & 1, kh) &&
              uncombine((prod >> 2) & 1, prod & 1, kw))
            v += d[prod];
        out(kh * 3 + kw, v);
      }
  }
  static bool can_stage(const Dw&) { return false; }

  // the per-product wgmma kernel's loads: x's shift, g's row parity py and
  // channel offset px * Co
  struct Shift {
    int dy, dx, py, cg;
  };
  __device__ __forceinline__ Shift shift(int prod) const {
    return Shift{dy(prod), dx(prod), prod >> 3, ((prod >> 2) & 1) * Co};
  }
  __device__ __forceinline__ void load_x(uint32_t dst, const CUtensorMap* map,
                                         const Shift& s, int ci,
                                         const wgrad::Pix& q,
                                         uint32_t bar) const {
    igemm90::tma_load_4d(dst, map, ci, q.j + s.dx, q.i + s.dy, q.b, bar);
  }
  __device__ __forceinline__ void load_g(uint32_t dst, const CUtensorMap* map,
                                         const Shift& s, int co,
                                         const wgrad::Pix& q,
                                         uint32_t bar) const {
    wgrad::tma_load_5d(dst, map, s.cg + co, q.j, s.py, q.i, q.b, bar);
  }
  cudaError_t maps(CUtensorMap* xmap, CUtensorMap* gmap, int B) const {
    return maps(xmap, gmap, B, 64);
  }

  // x [B][H][W][Cin] boxes of 64 channels shifted by a view's offset; g
  // [B][2H][2W][Co] as [B][H][2 (py)][W][2 (px) * Co] so that the plane is
  // a coordinate, boxes of bn channels (64: the 128-byte swizzle, 32: the
  // 64-byte one); both by one K slice of x's map
  cudaError_t maps(CUtensorMap* xmap, CUtensorMap* gmap, int B,
                   int bn) const {
    const wgrad::Box bx = wgrad::box(Hp, Wp);
    const cuuint64_t xd[4] = {static_cast<cuuint64_t>(Cin),
                              static_cast<cuuint64_t>(Wp),
                              static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(B)};
    const cuuint64_t xs[3] = {xd[0] * 2, xd[0] * xd[1] * 2,
                              xd[0] * xd[1] * xd[2] * 2};
    const cuuint32_t xb[4] = {64, bx.w, bx.rows, bx.imgs};
    cudaError_t err = igemm90::encode_tiled(xmap, 4, x, xd, xs, xb);
    if (err != cudaSuccess) return err;
    const cuuint64_t gd[5] = {2 * static_cast<cuuint64_t>(Co),
                              static_cast<cuuint64_t>(Wp), 2,
                              static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(B)};
    const cuuint64_t gs[4] = {gd[0] * 2, gd[0] * gd[1] * 2,
                              gd[0] * gd[1] * 2 * 2,
                              gd[0] * gd[1] * 2 * gd[3] * 2};
    const cuuint32_t gb[5] = {static_cast<cuuint32_t>(bn), bx.w, 1, bx.rows,
                              bx.imgs};
    return igemm90::encode_tiled(gmap, 5, g, gd, gs, gb,
                                 bn == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                          : CU_TENSOR_MAP_SWIZZLE_64B);
  }

  cudaError_t launch_wgmma(int tile_m, int tile_n, int B, cudaStream_t s,
                           int* extra) const;
};

}  // namespace

namespace igemm90 {
// m64n32k16 (the up-block's 32-column tile): 16 accumulators a thread
template <int TA>
struct Wgmma<32, TA> {
  __device__ static __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};
}  // namespace igemm90

namespace {

// The up-block's wgmma path, with the fold on chip.  A CTA computes, for a
// tile of 64 input channels x BN output channels and one row parity py of
// g, the 8 products of that parity over its part of K, in slices of 64
// pixels; the cluster's CTAs are its part's two parities times the parts
// in the cluster (rank = 2 * part + py).  A stage holds the slice's 6
// shifted views of x that those products read, (dy, dx) = (py + a - 1,
// -1..1), each its own zero-filled TMA box (a shifted start inside one
// box would break the 128-byte swizzle's phase), and g's two planes (py,
// 0) and (py, 1): 8 boxes where 8 per-product blocks took 16.  Warpgroup
// w = 2 * px + a computes the products (px, a, c = 0, 1): two m64nBNk16
// accumulators of BN / 2 registers; the last warp is the producer.
// The fold: tap (kh, kw) takes, from each plane (py, px), the product a =
// (kh >= 1 + py), c = (kw >= 1 + px) (UNCOMBINE), so the CTA's partial
// taps are the px = 0 warpgroups' products plus the px = 1 ones', added in
// that order in shared memory; the epilogue then adds the cluster's
// partial taps in rank order.
template <int BN>
struct FoldTile {
  static constexpr int X_BOX = 64 * 128;          // 64 pixels x 64 channels
  static constexpr int G_BOX = 64 * BN * 2;       // 64 pixels x BN channels
  static constexpr int G_K16 = 16 * BN * 2;       // 16 pixels of a g box
  static constexpr int STAGE = 6 * X_BOX + 2 * G_BOX;
  static constexpr int STAGES = 3;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static constexpr int CONSUMERS = 4 * 128, THREADS = CONSUMERS + 32;
  static constexpr int ROWS = 9 * 64, LD = BN + 4;  // the staged taps
  static_assert(ROWS * LD * 4 <= STAGES * STAGE, "the taps fit the ring");
};

// g's N-major panel: 128-byte swizzle (BN 64, 8 rows of 128 bytes a
// group) or 64-byte (BN 32: 8 rows of 64 bytes; layout type 2)
template <int BN>
__device__ __forceinline__ uint64_t g_desc(uint32_t addr) {
  if constexpr (BN == 64)
    return igemm90::make_desc(addr, wgrad::PANEL, 1024);
  else
    return (igemm90::make_desc(addr, 512, 512) & ~(3ull << 62)) | (2ull << 62);
}

template <int BN>
__global__ void __launch_bounds__(FoldTile<BN>::THREADS, 1)
    dw_fold_kernel(Dw p, const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap) {
  using T = FoldTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[T::STAGES];
  __shared__ __align__(8) unsigned long long empty[T::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* taps = reinterpret_cast<float*>(smem_raw + (ring - raw));

  const int tid = threadIdx.x;
  const int py = blockIdx.x & 1;
  const int n_co = p.Co / BN;
  const int ci0 = p.c0 + (blockIdx.y / n_co) * 64;
  const int co0 = (blockIdx.y % n_co) * BN;
  const int z = blockIdx.z * p.cluster + (blockIdx.x >> 1);
  const int2 span = wgrad::part(z, p.parts,
                                (p.K + wgrad::SLICE - 1) / wgrad::SLICE);
  const int lo = span.x, n_iter = span.y - span.x;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7, tid128 = tid & 127;
  const int px = wg >> 1, a = wg & 1;
  float acc[2][BN / 2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[c][i] = 0.f;

  if (tid >= T::CONSUMERS) {
    if (tid == T::CONSUMERS) {
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
        for (int v = 0; v < 6; ++v)
          igemm90::tma_load_4d(st + v * T::X_BOX, &xmap, ci0,
                               q.j + v % 3 - 1, q.i + py + v / 3 - 1, q.b,
                               bar);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
          wgrad::tma_load_5d(st + 6 * T::X_BOX + pl * T::G_BOX, &gmap,
                             pl * p.Co + co0, q.j, py, q.i, q.b, bar);
      }
    }
  } else {
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % T::STAGES;
      igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (it / T::STAGES) & 1);
      const uint32_t st = ring + s * T::STAGE;
      const uint32_t gb = st + 6 * T::X_BOX + px * T::G_BOX;
      igemm90::wgmma_fence();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t xv = st + (a * 3 + px + c) * T::X_BOX;
#pragma unroll
        for (int k = 0; k < wgrad::SLICE / 16; ++k)
          igemm90::Wgmma<BN, 1>::mma(
              acc[c], igemm90::make_desc(xv + k * 2048, wgrad::PANEL, 1024),
              g_desc<BN>(gb + k * T::G_K16));
      }
      igemm90::wgmma_commit();
      igemm90::wgmma_wait<1>();
      if (it > 0 && tid128 == 0)
        wgrad::mbar_arrive(
            igemm90::smem_u32(&empty[(it - 1) % T::STAGES]));
    }
    igemm90::wgmma_wait<0>();
  }
  __syncthreads();   // every slice consumed: the ring is free

  // the fold: plane (py, 0)'s products, then plane (py, 1)'s added
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (tid < T::CONSUMERS && px == half) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            if ((kh >= 1 + py) != (a == 1) || (kw >= 1 + px) != (c == 1))
              continue;
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
              float* at = taps + ((kh * 3 + kw) * 64 +
                                  igemm90::acc_row(tid128, i)) * T::LD +
                          igemm90::acc_col(tid128, i);
              *at = half == 0 ? acc[c][i] : *at + acc[c][i];
            }
          }
    }
    __syncthreads();
  }
  const int ci_local = ci0 - p.c0;
  finish_tile<Dw, T::THREADS>(
      p, taps, T::LD, T::ROWS, BN, co0, 2 * p.cluster, p.groups() == 1,
      Dw::TAPS, blockIdx.z,
      [&](int r) { return (r >> 6) * p.Cc + ci_local + (r & 63); });
}

template <int BN>
cudaError_t launch_fold(const Dw& p, int B, cudaStream_t s) {
  using T = FoldTile<BN>;
  auto kernel = dw_fold_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap = {}, gmap = {};
  err = p.maps(&xmap, &gmap, B, BN);
  if (err != cudaSuccess) return err;
  const int tiles = p.Cc / 64 * (p.Co / BN);
  return launch_clustered(kernel, dim3(2 * p.cluster, tiles, p.groups()),
                          T::THREADS, T::SMEM, 2 * p.cluster, s, p, xmap,
                          gmap);
}

// the on-chip fold (tile 64 x 64 or 64 x 32), or the per-product kernel of
// wgrad.cuh (tiles of 64 or 128 rows of one product by 64 or 128 columns)
cudaError_t Dw::launch_wgmma(int tile_m, int tile_n, int B, cudaStream_t s,
                             int* extra) const {
  if (on_chip) {
    *extra = wgrad::kFold | (tile_n == 32 ? wgrad::kBn32 : 0);
    return tile_n == 64 ? launch_fold<64>(*this, B, s)
                        : launch_fold<32>(*this, B, s);
  }
  if (tile_m == 64)
    return tile_n == 64 ? launch_dw_wgmma<Dw, 64, 64>(*this, B, s)
                        : launch_dw_wgmma<Dw, 64, 128>(*this, B, s);
  return tile_n == 64 ? launch_dw_wgmma<Dw, 128, 64>(*this, B, s)
                      : launch_dw_wgmma<Dw, 128, 128>(*this, B, s);
}

int dw_path(const void* x, const void* g, int H, int W, int Cin, int Co,
            bool bf16) {
  const bool aligned = igemm::aligned16(x) && igemm::aligned16(g);
  if (bf16 && aligned && Cin % 64 == 0 && Co % 32 == 0 && wgrad::boxes(H, W))
    return wgrad::kWgmma;
  return bf16 && aligned && Cin % 8 == 0 && Co % 8 == 0 ? wgrad::kMma
                                                        : wgrad::kTile;
}

int g_last_mode = 0;      // the Mode bits of t2i_upconv3x3_dw's last launch
int g_last_dx_mode = 0;   // dx90::Mode bits of t2i_upconv3x3_dx's last launch

}  // namespace

// The path t2i_upconv3x3_dx takes for these pointers and shapes (dx's map
// H x W): 0 the simple tile, 1 the pipelined tile, 2 wgmma.
extern "C" int t2i_upconv3x3_dx_path(const void* g, const void* wc,
                                     const void* dx, int H, int W, int Cin,
                                     int Co, int bf16) {
  return dx_path(make_dx(g, wc, const_cast<void*>(dx), 1, H, W, Cin, Co,
                         bf16),
                 H, W, bf16 != 0);
}

// dx [B][H][W][Cin] from g [B][2H][2W][Co] and the combined weights wc
// [16][Cin][Co] (upconv3x3.cu t2i_upconv3x3_combine), on `stream`.  On the
// wgmma path `kernel` (dx90::Kernel) picks the loop: kRing (`tile` the
// tile's columns, `parts` of K in one cluster) or kTransposed (`tile` 64,
// one part) read wc as it is; kCpAsync (`tile` an igemm90::TileId, not the
// resident one; `parts` of whole taps, above 1 through `ws`, split planes
// of B*H*W x Cin f32) and the other paths first write wct = wc transposed
// to [16][Co][Cin] (the caller's buffer).  Returns the CUDA error code (0
// when launched); no path gives way to another.
extern "C" int t2i_upconv3x3_dx(const void* g, const void* wc, void* wct,
                                void* dx, void* ws, int B, int H, int W,
                                int Cin, int Co, int bf16, int kernel,
                                int tile, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int path =
      dx_path(make_dx(g, wc, dx, B, H, W, Cin, Co, bf16), H, W, bf16 != 0);
  if (path == kDxWgmma && kernel != dx90::kCpAsync)
    return static_cast<int>(dx90::launch(g, wc, dx, B, H, W, Cin, Co,
                                         kernel, tile, parts, s,
                                         &g_last_dx_mode));
  if (wct == nullptr || (path == kDxWgmma && Co % 64)) return cudaErrorInvalidValue;
  const dim3 tgrid((Co + 31) / 32, (Cin + 31) / 32, 16);
  if (bf16)
    dx_transpose_kernel<uint16_t><<<tgrid, 256, 0, s>>>(
        static_cast<const uint16_t*>(wc), static_cast<uint16_t*>(wct), Cin,
        Co);
  else
    dx_transpose_kernel<float><<<tgrid, 256, 0, s>>>(
        static_cast<const float*>(wc), static_cast<float*>(wct), Cin, Co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const UpconvDx p = make_dx(g, wct, dx, B, H, W, Cin, Co, bf16);
  if (path == kDxWgmma) {
    if (tile == igemm90::kResident128x64) return cudaErrorInvalidValue;
    const int split[1] = {parts};
    g_last_dx_mode = dx90::kGather | (parts > 1 ? dx90::kWorkspace : 0);
    return static_cast<int>(
        igemm90::launch(p, tile, split, static_cast<float*>(ws), s));
  }
  g_last_dx_mode = 0;
  return static_cast<int>(igemm::launch(p, bf16 != 0, s));
}

// What the last launch of t2i_upconv3x3_dx in this process did (dx90::Mode
// bits: 1 A by TMA, 2 the shared patch, 4 64-byte K slices, 8 parts summed
// in a cluster, 16 a workspace and its reduce, 32 A gathered by cp.async;
// 0 the mma.sync and FMA tiles).
extern "C" int t2i_upconv3x3_dx_mode() { return g_last_dx_mode; }

// The path t2i_upconv3x3_dw takes for x [B][H][W][Cin] and g: 0 the FMA
// tile, 1 wgmma, 2 mma.sync.
extern "C" int t2i_upconv3x3_dw_path(const void* x, const void* g, int H,
                                     int W, int Cin, int Co, int bf16) {
  return dw_path(x, g, H, W, Cin, Co, bf16 != 0);
}

// dw [3][3][Cin][Co] (bf16 when w_bf16, else f32) from x [B][H][W][Cin] and
// g [B][2H][2W][Co] (both bf16 when bf16, else f32), on `stream`, over
// `parts` parts of K, `cluster` of them in a cluster (wgrad.cuh dw_launch).
// With `fold` on the wgmma path (tile_m 64, tile_n 64 or 32) the 16
// products are folded into the 9 taps on chip and, where parts / cluster
// is 1, written straight to dw; else each cluster's taps go to `ws` (f32,
// (parts/cluster)*9*chunk*Co) and a second launch adds them.  The
// per-product blocks (wgmma without `fold`, mma, tile: cluster 1) write
// every part's 16 products to `ws` (parts*16*chunk*Co) and the second
// launch adds and folds them.
// Returns the CUDA error code (0 when launched).
extern "C" int t2i_upconv3x3_dw(const void* x, const void* g, void* dw,
                                void* ws, int B, int H, int W, int Cin,
                                int Co, int bf16, int w_bf16, int tile_m,
                                int tile_n, int parts, int cluster,
                                int chunk, int fold, void* stream) {
  Dw p;
  if (!p.set(x, g, dw, ws, B, H, W, Cin, Co, parts, cluster, w_bf16, 0))
    return cudaErrorInvalidValue;
  p.on_chip = fold != 0;
  const int path = dw_path(x, g, H, W, Cin, Co, bf16 != 0);
  if (path == wgrad::kWgmma && p.on_chip &&
      (tile_m != 64 || (tile_n != 64 && tile_n != 32) || Co % tile_n ||
       chunk % 64))
    return cudaErrorInvalidValue;
  if (path == wgrad::kWgmma && !p.on_chip &&
      ((tile_m != 64 && tile_m != 128) || (tile_n != 64 && tile_n != 128) ||
       Cin % tile_m || chunk % tile_m || Co % tile_n))
    return cudaErrorInvalidValue;
  return dw_launch(p, path, bf16 != 0, tile_m, tile_n, chunk, B,
                   static_cast<cudaStream_t>(stream), &g_last_mode);
}

// What the last launch of t2i_upconv3x3_dw in this process did
// (wgrad::Mode bits: 1 dw written by the kernel, 2 a cluster's parts
// summed on chip, 4 a workspace and its reduction, 8 the on-chip fold, 16
// the 32-column tile, 64 the producer-warp main loop).
extern "C" int t2i_upconv3x3_dw_mode() { return g_last_mode; }

// Clusters of csize CTAs of the fold kernel of tile_n output channels the
// card holds at once (cudaOccupancyMaxActiveClusters; the plan's
// capacity); -1 on an error.
extern "C" int t2i_upconv3x3_dw_clusters(int csize, int tile_n) {
  return tile_n == 64 ? max_clusters(dw_fold_kernel<64>,
                                     FoldTile<64>::THREADS,
                                     FoldTile<64>::SMEM, csize)
                      : max_clusters(dw_fold_kernel<32>,
                                     FoldTile<32>::THREADS,
                                     FoldTile<32>::SMEM, csize);
}
