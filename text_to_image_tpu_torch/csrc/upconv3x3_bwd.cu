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
// taps x Co.  Row (b, i, j) of tap (py, px, a, c) reads g at the fixed
// offset (2-py-2a, 2-px-2c) from (2i, 2j): the same for every row, so the
// gather is the forward's (igemm_sm90.cuh: one table read and one bit test
// per tap and 16-byte copy, zeros where the tap leaves the map), and the
// weights are Cw transposed, [16][Co][Cin] (dx_transpose_kernel, one launch
// over the combined weights).  Paths, from shapes, types and alignment only
// (dx_path; the wrapper mirrors the rule):
//  * wgmma: bf16 with Cin and Co multiples of 64 (every StackGAN and the
//    C-PGGAN calls up to Co 64): igemm_sm90.cuh's main loop, weights by
//    TMA, A gathered by cp.async; the caller's plan (conv_plan of
//    ops/kernels/conv.py over 16 taps) picks the tile and a split of K over
//    whole taps, reduced in a fixed order.
//  * pipelined / tile (igemm.cuh, mma.sync / f32 FMA): otherwise.
//
// upconv3x3_dw: sixteen GEMMs [Cin x Co] over K = B*H*W pixels of a parity
// plane -- a long-K reduction with few outputs.  A block computes one
// product's [BM x BN] tile over a part of K, writes its f32 sums to the
// caller's workspace [parts][16][Cin][Co], and dw_reduce_kernel adds the
// parts in the order 0..parts-1 and folds the 16 products into the nine
// taps of dW in the same pass: no atomics, the same bits every run.  The
// parts are the caller's (dw_plan): enough blocks for every SM.
//  * wgmma (bf16, Cin and Co multiples of 64, 16-byte-aligned x and g, a
//    map where a slice of 64 pixels is a part of one image row, whole rows
//    or whole images: dw_boxes, every main-path map): both operands are
//    pixel rows of 64 channels (128 bytes) in the 128-byte-swizzled layout,
//    A = x shifted by (py+a-1, px+c-1) M-major, B = g's plane N-major;
//    m64nBNk16 with A transposed (the descriptor's transpose bit), one
//    warpgroup per 64 input channels, a ring of stages as in
//    igemm_sm90.cuh.  Both come by TMA, one box a 64-channel panel: x as
//    [B][H][W][Cin] boxes shifted by the product's offset (the tensor map
//    zero-fills past every edge), g as [B][H][2][W][2*Co] so that the plane
//    (py, px) is a coordinate.  A first version copied both operands by
//    cp.async (the forward's notes measured that feed at ~10 bytes a clock
//    an SM): on the H100 Stage-II's four dw calls took 0.31-1.34 ms,
//    4.5-6.7x their bound and slower than cuDNN's weight gradient over the
//    upsampled x; by TMA 0.15-0.42 ms (tools/bench_kernels.py).
//  * mma (bf16 with Cin and Co multiples of 8, 16-byte-aligned x and g:
//    C-PGGAN's Co 32, and the maps with no box): 64x64 tiles on mma.sync
//    (WMMA 16x16x16), slices of 32 pixels staged through shared memory
//    with the next slice's 16-byte loads in flight in registers, A read
//    column-major from the pixel rows; each thread finds its pixel (b, m,
//    n) with two multiplications (FastDiv).
//  * tile (f32 FMA, 64x64 tiles, slices of 16 pixels): every other shape,
//    f32 (tensor cores off) and ragged channels.
// Whichever the path, the weights' gradient is summed in f32 and rounded
// once to w's type.

#include "igemm_sm90.cuh"

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

int dx_path(const UpconvDx& p, bool bf16) {
  if (bf16 && igemm90::applies(p)) return kDxWgmma;
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
// n / d for n < 2^31 by a multiplication (the round-up method: for d > 1,
// mul = ceil(2^(31+l) / d) with l = ceil(log2 d), q = umulhi(n, mul) >> (l-1))
struct FastDiv {
  unsigned d, mul;
  int shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shift;
  }
};

FastDiv fast_div(unsigned d) {
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

struct Dw {
  const void* x;   // [B][H][W][Cin]
  const void* g;   // [B][2H][2W][Co]
  float* ws;       // [parts][16][Cin][Co]
  int H, W, Cin, Co, K, parts;   // K = B*H*W pixels of a parity plane
  FastDiv hw, w;   // by H*W and by W

  // product p = ((py*2+px)*2+a)*2+c: x shifted by (py+a-1, px+c-1), g's
  // plane (py, px)
  __device__ float* plane(int z, int prod) const {
    return ws + (static_cast<size_t>(z) * 16 + prod) * Cin * Co;
  }
};

// Pixel k of a parity plane, and where product `prod` reads x and g for it:
// element offsets of channel 0, -1 where x's shifted pixel leaves the map
// (g's is -1 only past the last pixel).
struct Pixel {
  long long x_off, g_off;
};

__device__ __forceinline__ Pixel pixel(const Dw& p, int k, int prod) {
  if (k >= p.K) return Pixel{-1, -1};
  const int b = static_cast<int>(p.hw.div(static_cast<unsigned>(k)));
  const int rem = k - b * p.H * p.W;
  const int m = static_cast<int>(p.w.div(static_cast<unsigned>(rem)));
  const int n = rem - m * p.W;
  const int py = prod >> 3, px = (prod >> 2) & 1;
  const int iy = m + py + ((prod >> 1) & 1) - 1, ix = n + px + (prod & 1) - 1;
  Pixel q;
  q.x_off = (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W)
                ? -1
                : ((static_cast<long long>(b) * p.H + iy) * p.W + ix) * p.Cin;
  q.g_off = ((static_cast<long long>(b) * 2 * p.H + 2 * m + py) * (2 * p.W) +
             2 * n + px) *
            p.Co;
  return q;
}

// wgmma path: a block computes product blockIdx.x % 16's [BM x BN] tile
// (BM input channels, BN output channels) over part blockIdx.y of K, in
// slices of 64 pixels.  Shared memory per stage: A = 64 pixels x BM
// channels as BM/64 panels of [64 pixels][128 bytes] (M-major), B = 64
// pixels x BN channels as BN/64 panels (N-major), both swizzled by TMA:
// 16-byte chunk c of 128-byte row r at chunk c ^ (r & 7).
constexpr int DW_SLICE = 64;   // pixels per K slice (wgmma path)
constexpr int DW_PANEL = 64 * 128;

template <int BM, int BN>
struct DwTile {
  static constexpr int THREADS = BM * 2;           // a warpgroup per 64 rows
  static constexpr int A_STAGE = BM * 128, B_STAGE = BN * 128;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int STAGES = STAGE <= 24 * 1024 ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + hand alignment
};

// A slice of 64 pixels as one box of each map (see the note at the top):
// a 64-pixel part of one row, 64 / W whole rows of one image, or 64 / (H*W)
// whole images; the wgmma path takes the maps where one of these is a box
bool dw_boxes(int H, int W) {
  const long long hw = static_cast<long long>(H) * W;
  return W % 64 == 0 || (64 % W == 0 && (hw % 64 == 0 || 64 % hw == 0));
}

cudaError_t dw_maps(CUtensorMap* xmap, CUtensorMap* gmap, const void* x,
                    const void* g, int B, int H, int W, int Cin, int Co) {
  const cuuint32_t bw = W < 64 ? W : 64;
  const cuuint32_t rows = W >= 64 ? 1 : (64 / W < H ? 64 / W : H);
  const cuuint32_t imgs = H * W < 64 ? 64 / (H * W) : 1;
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t xs[3] = {xd[0] * 2, xd[0] * xd[1] * 2,
                            xd[0] * xd[1] * xd[2] * 2};
  const cuuint32_t xb[4] = {64, bw, rows, imgs};
  cudaError_t err = igemm90::encode_tiled(xmap, 4, x, xd, xs, xb);
  if (err != cudaSuccess) return err;
  // g [B][2H][2W][Co] as [B][H][2 (py)][W][2 (px) * Co]
  const cuuint64_t gd[5] = {2 * static_cast<cuuint64_t>(Co),
                            static_cast<cuuint64_t>(W), 2,
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t gs[4] = {gd[0] * 2, gd[0] * gd[1] * 2,
                            gd[0] * gd[1] * 2 * 2, gd[0] * gd[1] * 2 * gd[3] * 2};
  const cuuint32_t gb[5] = {64, bw, 1, rows, imgs};
  return igemm90::encode_tiled(gmap, 5, g, gd, gs, gb);
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

template <int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
    dw_wgmma_kernel(Dw p, const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap) {
  using T = DwTile<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[T::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int prod = blockIdx.x % 16;
  const int tile = blockIdx.x / 16;
  const int n_tiles = p.Co / BN;
  const int ci0 = (tile / n_tiles) * BM, co0 = (tile % n_tiles) * BN;
  const int z = blockIdx.y;
  const int total = (p.K + DW_SLICE - 1) / DW_SLICE;
  const int lo = static_cast<int>(static_cast<long long>(z) * total / p.parts);
  const int hi =
      static_cast<int>(static_cast<long long>(z + 1) * total / p.parts);
  const int n_iter = hi - lo;

  const int py = prod >> 3, px = (prod >> 2) & 1;
  const int dy = py + ((prod >> 1) & 1) - 1, dx = px + (prod & 1) - 1;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 asks for the slice's BM/64 + BN/64 panels
  auto issue = [&](int stage, int slice) {
    const uint32_t st = ring + stage * T::STAGE;
    const uint32_t bar = igemm90::smem_u32(&full[stage]);
    igemm90::mbar_expect_tx(bar, T::STAGE);
    const int k0 = slice * DW_SLICE;
    const int b0 = static_cast<int>(p.hw.div(static_cast<unsigned>(k0)));
    const int rem = k0 - b0 * p.H * p.W;
    const int m0 = static_cast<int>(p.w.div(static_cast<unsigned>(rem)));
    const int n0 = rem - m0 * p.W;
#pragma unroll
    for (int pa = 0; pa < BM / 64; ++pa)
      igemm90::tma_load_4d(st + pa * DW_PANEL, &xmap, ci0 + pa * 64, n0 + dx,
                           m0 + dy, b0, bar);
#pragma unroll
    for (int pb = 0; pb < BN / 64; ++pb)
      tma_load_5d(st + T::A_STAGE + pb * DW_PANEL, &gmap,
                  px * p.Co + co0 + pb * 64, n0, py, m0, b0, bar);
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
    for (int k = 0; k < DW_SLICE / 16; ++k)
      igemm90::Wgmma<BN, 1>::mma(
          acc, igemm90::make_desc(st + wg * DW_PANEL + k * 2048, DW_PANEL, 1024),
          igemm90::make_desc(st + T::A_STAGE + k * 2048, DW_PANEL, 1024));
    igemm90::wgmma_commit();
    const int nxt = it + T::STAGES - 1;
    if (tid == 0 && nxt < n_iter) issue(nxt % T::STAGES, lo + nxt);
    igemm90::wgmma_wait<0>();
  }

  float* out = p.plane(z, prod);
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int ci = ci0 + wg * 64 + igemm90::acc_row(tid128, i);
    const int co = co0 + igemm90::acc_col(tid128, i);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(ci) * p.Co + co) =
        make_float2(acc[i], acc[i + 1]);
  }
}

// tile path: a block computes product blockIdx.x % 16's 64 x 64 tile over
// part blockIdx.y of K in slices of 16 pixels, 4 x 4 outputs a thread on
// f32 FMA; any channels (masked), bf16 or f32 inputs.
constexpr int DW_TILE_SLICE = 16;

template <class S>
__global__ void __launch_bounds__(256) dw_tile_kernel(Dw p) {
  __shared__ __align__(16) float xs[DW_TILE_SLICE][64];
  __shared__ __align__(16) float gs[DW_TILE_SLICE][64];
  const int tid = threadIdx.x;
  const int prod = blockIdx.x % 16;
  const int tile = blockIdx.x / 16;
  const int n_tiles = (p.Co + 63) / 64;
  const int ci0 = (tile / n_tiles) * 64, co0 = (tile % n_tiles) * 64;
  const int z = blockIdx.y;
  const int total = (p.K + DW_TILE_SLICE - 1) / DW_TILE_SLICE;
  const int lo = static_cast<int>(static_cast<long long>(z) * total / p.parts);
  const int hi =
      static_cast<int>(static_cast<long long>(z + 1) * total / p.parts);
  const S* x = static_cast<const S*>(p.x);
  const S* g = static_cast<const S*>(p.g);
  // loads: channel tid % 64 of pixel rows tid / 64 + 4i
  const int ch = tid & 63, r0 = tid >> 6;
  const bool ci_ok = ci0 + ch < p.Cin, co_ok = co0 + ch < p.Co;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = lo; s < hi; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * i;
      const Pixel q = pixel(p, s * DW_TILE_SLICE + r, prod);
      xs[r][ch] = q.x_off >= 0 && ci_ok
                      ? igemm::to_float(x[q.x_off + ci0 + ch]) : 0.f;
      gs[r][ch] = q.g_off >= 0 && co_ok
                      ? igemm::to_float(g[q.g_off + co0 + ch]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DW_TILE_SLICE; ++k) {
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
  float* out = p.plane(z, prod);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= p.Cin) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < p.Co) out[static_cast<size_t>(ci) * p.Co + co] = acc[i][j];
    }
  }
}

// mma path: a block computes product blockIdx.x % 16's 64 x 64 tile over
// part blockIdx.y of K in slices of 32 pixels; 8 warps of 16 x 32 outputs
// (two 16x16 fragments).  Thread t copies chunk t % 8 (8 channels) of x's
// and g's pixel row t / 8 of each slice; chunks past Cin or Co are zeros.
constexpr int DW_MMA_SLICE = 32;
constexpr int DW_MMA_LD = 64 + 8;   // 144-byte rows

__global__ void __launch_bounds__(256) dw_mma_kernel(Dw p) {
  using namespace nvcuda;
  __shared__ __align__(32) uint16_t xs[DW_MMA_SLICE][DW_MMA_LD];
  __shared__ __align__(32) uint16_t gs[DW_MMA_SLICE][DW_MMA_LD];
  __shared__ __align__(32) float stage[64][64];
  const int tid = threadIdx.x;
  const int prod = blockIdx.x % 16;
  const int tile = blockIdx.x / 16;
  const int n_tiles = (p.Co + 63) / 64;
  const int ci0 = (tile / n_tiles) * 64, co0 = (tile % n_tiles) * 64;
  const int z = blockIdx.y;
  const int total = (p.K + DW_MMA_SLICE - 1) / DW_MMA_SLICE;
  const int lo = static_cast<int>(static_cast<long long>(z) * total / p.parts);
  const int hi =
      static_cast<int>(static_cast<long long>(z + 1) * total / p.parts);
  const uint16_t* x = static_cast<const uint16_t*>(p.x);
  const uint16_t* g = static_cast<const uint16_t*>(p.g);
  const int r = tid >> 3, c8 = (tid & 7) * 8;
  const bool ci_ok = ci0 + c8 < p.Cin, co_ok = co0 + c8 < p.Co;

  uint4 xr, gr;
  auto load = [&](int s) {
    const Pixel q = pixel(p, s * DW_MMA_SLICE + r, prod);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    xr = q.x_off >= 0 && ci_ok
             ? __ldg(reinterpret_cast<const uint4*>(x + q.x_off + ci0 + c8))
             : zero;
    gr = q.g_off >= 0 && co_ok
             ? __ldg(reinterpret_cast<const uint4*>(g + q.g_off + co0 + c8))
             : zero;
  };

  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  if (lo < hi) load(lo);
  for (int s = lo; s < hi; ++s) {
    *reinterpret_cast<uint4*>(&xs[r][c8]) = xr;
    *reinterpret_cast<uint4*>(&gs[r][c8]) = gr;
    __syncthreads();
    if (s + 1 < hi) load(s + 1);
#pragma unroll
    for (int kk = 0; kk < DW_MMA_SLICE; kk += 16) {
      // A[ci][k] = xs[k][ci]: column-major with rows of DW_MMA_LD
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa;
      wmma::load_matrix_sync(
          fa, reinterpret_cast<const __nv_bfloat16*>(&xs[kk][wm * 16]),
          DW_MMA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(
            fb,
            reinterpret_cast<const __nv_bfloat16*>(&gs[kk][wn * 32 + j * 16]),
            DW_MMA_LD);
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
  float* out = p.plane(z, prod);
  for (int e = tid; e < 64 * 64; e += 256) {
    const int ci = ci0 + (e >> 6), co = co0 + (e & 63);
    if (ci < p.Cin && co < p.Co)
      out[static_cast<size_t>(ci) * p.Co + co] = stage[e >> 6][e & 63];
  }
}

// dW[kh][kw][ci][co] = sum_p U[py][a][kh] * U[px][c][kw] * sum_z ws[z][p],
// the parts added in the order 0..parts-1, then the products in the order
// p = 0..15.  UNCOMBINE as bit masks over kh: U[py][a] = {{kh0}, {kh1, kh2}}
// for py = 0, {{kh0, kh1}, {kh2}} for py = 1.  One thread per (ci, co).
__device__ __forceinline__ bool uncombine(int p, int a, int k) {
  const int mask = p == 0 ? (a == 0 ? 1 : 6) : (a == 0 ? 3 : 4);
  return (mask >> k) & 1;
}

template <class O>
__global__ void __launch_bounds__(256)
    dw_reduce_kernel(const float* ws, O* dw, int parts, long long cico) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= cico) return;
  float d[16];
#pragma unroll
  for (int prod = 0; prod < 16; ++prod) {
    float s = 0.f;
    for (int z = 0; z < parts; ++z) s += ws[(z * 16LL + prod) * cico + i];
    d[prod] = s;
  }
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
      O* out = dw + (kh * 3 + kw) * cico + i;
      if constexpr (std::is_same<O, uint16_t>::value)
        *out = __bfloat16_as_ushort(__float2bfloat16(v));
      else
        *out = v;
    }
}

enum DwPath { kDwTile = 0, kDwWgmma = 1, kDwMma = 2 };

int dw_path(const void* x, const void* g, int H, int W, int Cin, int Co,
            bool bf16) {
  const bool aligned = igemm::aligned16(x) && igemm::aligned16(g);
  if (bf16 && aligned && Cin % 64 == 0 && Co % 64 == 0 && dw_boxes(H, W))
    return kDwWgmma;
  return bf16 && aligned && Cin % 8 == 0 && Co % 8 == 0 ? kDwMma : kDwTile;
}

template <int BM, int BN>
cudaError_t launch_dw_wgmma(const Dw& p, int B, int tiles, cudaStream_t s) {
  using T = DwTile<BM, BN>;
  auto kernel = dw_wgmma_kernel<BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap = {}, gmap = {};
  err = dw_maps(&xmap, &gmap, p.x, p.g, B, p.H, p.W, p.Cin, p.Co);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles * 16, p.parts), T::THREADS, T::SMEM, s>>>(p, xmap,
                                                                 gmap);
  return cudaGetLastError();
}

}  // namespace

// The path t2i_upconv3x3_dx takes for these pointers and shapes: 0 the
// simple tile, 1 the pipelined tile, 2 wgmma.
extern "C" int t2i_upconv3x3_dx_path(const void* g, const void* wct,
                                     const void* dx, int Cin, int Co,
                                     int bf16) {
  return dx_path(make_dx(g, wct, const_cast<void*>(dx), 1, 1, 1, Cin, Co,
                         bf16),
                 bf16 != 0);
}

// dx [B][H][W][Cin] from g [B][2H][2W][Co] and the combined weights wc
// [16][Cin][Co] (upconv3x3.cu t2i_upconv3x3_combine), on `stream`: first
// wct = wc transposed to [16][Co][Cin] (the caller's buffer), then the
// GEMM.  `tile` (igemm90::TileId, not the resident kernel) and `split`
// (parts of K, whole taps each; above 1 needs `ws`, split planes of
// B*H*W x Cin f32) are read on the wgmma path only.  Returns the CUDA
// error code (0 when launched); no path gives way to another.
extern "C" int t2i_upconv3x3_dx(const void* g, const void* wc, void* wct,
                                void* dx, void* ws, int B, int H, int W,
                                int Cin, int Co, int bf16, int tile,
                                int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  if (dx_path(p, bf16 != 0) == kDxWgmma) {
    if (tile == igemm90::kResident128x64) return cudaErrorInvalidValue;
    const int parts[1] = {split};
    return static_cast<int>(
        igemm90::launch(p, tile, parts, static_cast<float*>(ws), s));
  }
  return static_cast<int>(igemm::launch(p, bf16 != 0, s));
}

// The path t2i_upconv3x3_dw takes for x [B][H][W][Cin] and g: 0 the FMA
// tile, 1 wgmma, 2 mma.sync.
extern "C" int t2i_upconv3x3_dw_path(const void* x, const void* g, int H,
                                     int W, int Cin, int Co, int bf16) {
  return dw_path(x, g, H, W, Cin, Co, bf16 != 0);
}

// dw [3][3][Cin][Co] (bf16 when w_bf16, else f32) from x [B][H][W][Cin] and
// g [B][2H][2W][Co] (both bf16 when bf16, else f32), on `stream`: the 16
// products in `parts` parts of K each into `ws` (f32, parts*16*Cin*Co),
// then their sum and recombination.  tile_m x tile_n (64 or 128 each,
// dividing Cin and Co) is read on the wgmma path only.  Returns the CUDA
// error code (0 when launched).
extern "C" int t2i_upconv3x3_dw(const void* x, const void* g, void* dw,
                                void* ws, int B, int H, int W, int Cin,
                                int Co, int bf16, int w_bf16, int tile_m,
                                int tile_n, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long K = static_cast<long long>(B) * H * W;
  if (parts < 1 || K >= (1ll << 31) || ws == nullptr)
    return cudaErrorInvalidValue;
  Dw p;
  p.x = x;
  p.g = g;
  p.ws = static_cast<float*>(ws);
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Co = Co;
  p.K = static_cast<int>(K);
  p.parts = parts;
  p.hw = fast_div(static_cast<unsigned>(H * W));
  p.w = fast_div(static_cast<unsigned>(W));
  cudaError_t err;
  const int path = dw_path(x, g, H, W, Cin, Co, bf16 != 0);
  if (path == kDwWgmma) {
    if ((tile_m != 64 && tile_m != 128) || (tile_n != 64 && tile_n != 128) ||
        Cin % tile_m || Co % tile_n)
      return cudaErrorInvalidValue;
    const int tiles = (Cin / tile_m) * (Co / tile_n);
    if (tile_m == 64)
      err = tile_n == 64 ? launch_dw_wgmma<64, 64>(p, B, tiles, s)
                         : launch_dw_wgmma<64, 128>(p, B, tiles, s);
    else
      err = tile_n == 64 ? launch_dw_wgmma<128, 64>(p, B, tiles, s)
                         : launch_dw_wgmma<128, 128>(p, B, tiles, s);
  } else {
    const int tiles = ((Cin + 63) / 64) * ((Co + 63) / 64);
    const dim3 grid(tiles * 16, parts);
    if (path == kDwMma)
      dw_mma_kernel<<<grid, 256, 0, s>>>(p);
    else if (bf16)
      dw_tile_kernel<uint16_t><<<grid, 256, 0, s>>>(p);
    else
      dw_tile_kernel<float><<<grid, 256, 0, s>>>(p);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cico = static_cast<long long>(Cin) * Co;
  const unsigned blocks = static_cast<unsigned>((cico + 255) / 256);
  if (w_bf16)
    dw_reduce_kernel<uint16_t><<<blocks, 256, 0, s>>>(
        p.ws, static_cast<uint16_t*>(dw), parts, cico);
  else
    dw_reduce_kernel<float><<<blocks, 256, 0, s>>>(
        p.ws, static_cast<float*>(dw), parts, cico);
  return static_cast<int>(cudaGetLastError());
}
