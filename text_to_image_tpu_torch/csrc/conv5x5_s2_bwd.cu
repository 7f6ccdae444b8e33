// The weight gradient of the discriminator's down-block convolution
// (conv5x5_s2.cu) for Hopper (sm_90a), and through it of the generator's
// transposed convolution (deconv5x5_s2.cu):
//
//   dw[kh][kw][ci][co] = sum_{b,oh,ow} xpad[b, 2oh+kh, 2ow+kw, ci]
//                                      * g[b, oh, ow, co]
//
// for x [B,H,W,Cin] NHWC, its TF SAME padding (pt, pl) = (1, 1) on even maps,
// (2, 2) on odd ones (zeros outside x), and the cotangent g
// [B,ceil(H/2),ceil(W/2),Co] (the activation's derivative already in it, in
// x's type).  bf16 or f32 in, f32 sums, dw rounded once to w's type.  The
// transposed convolution's dw is this kernel with its cotangent as x and
// its input as g, flipped and transposed by the caller.  The transposed
// convolution's dx is deconv5x5_s2_dx below (bf16, Cin a multiple of 64 and
// Co a multiple of 64 or at most 4; the other shapes the conv's forward
// kernel with w flipped and transposed); the conv's dx is conv5x5_s2_dx
// below (bf16, Cin and Co multiples of 64; the other shapes the transposed
// convolution's forward kernel with w flipped and transposed): no library
// convolution.
//
// conv5x5_s2_dx replaces the input half of text_to_image_tpu/ops/pallas/
// conv.py _conv_bwd (jax.vjp of _lax_conv_s2, left to XLA): dx [B,H,W,Cin]
// as four parity GEMMs of 9, 6, 6 and 4 taps (M = B*Ho*Wo rows of a
// parity plane, N = Cin, K = taps x Co), 2*25*B*Ho*Wo*Cin*Co operations,
// as many as the forward: bound by operations on every deep call of the
// 64 px and 256 px D (0.020 ms for each of the 64 px D's three at 3*64,
// 0.326 ms for the 256 px D's 128^2 x 64 at 3*64).  Two loops (the
// caller's plan, conv.py conv_dx_plan; tools/conv_plan_sweep.py --ops cdx
// fitted it): dx90's ring loop (upconv_dx.cuh) under the policy CDxRing,
// and at Cin 64 on the 128^2 maps the patch kernel (cdxp) -- see below.
//
// Replaces the weight half of text_to_image_tpu/ops/pallas/conv.py
// _conv_bwd (jax.vjp of _lax_conv_s2) and _deconv_bwd
// (jax.linear_transpose of lax.conv_transpose), which the JAX package
// leaves to XLA inside the custom VJPs of its Pallas convolutions.
//
// 25 long-K products [Cin x Co] over K = B*ceil(H/2)*ceil(W/2) pixels: one
// GEMM dw[25*Cin x Co] = im2col(x)^T [25*Cin x K] . g [K x Co], row m =
// tap*Cin + ci (dw's own layout).  Bound on the H100 SXM, bf16: 2*25*K*Cin*Co
// operations, as many as the forward; the 64 px discriminator's deep layers
// at 3 x 64 rows do 2.5-5.0 GFLOP each (2.5-5 us at 989 TFLOP/s), its RGB
// layer and the generator's are bound by the bytes of x and g.
//
// Design (the weight-gradient kernels of wgrad.cuh, shared with
// upconv3x3_bwd.cu's upconv3x3_dw; this file gives their policy CDw): a
// block computes a [BM x BN] tile of the product matrix -- a tile of dw,
// since the products are dw's taps -- over a part of K.  The parts of a
// tile run as one thread-block cluster (at most 8) and are added in rank
// order through distributed shared memory, then rounded once and stored
// straight into dw, or, for the transposed convolution's caller, into its
// own weight's layout Wd[kh][kw][ci][co] = dw[4-kh][4-kw][co][ci] (`flip`):
// no f32 workspace, no second launch, no copy.  Only a plan with more parts
// than a cluster holds (the long-K RGB layers) writes each cluster's f32
// sum to a workspace [groups][25][Cc][Co] that a second launch adds in the
// order 0..groups-1.  No atomics, the same bits every launch.  Paths, from
// shapes, types and alignment only (cdw_path; the wrapper mirrors it):
//  * wgmma: bf16, Cin and Co multiples of 64, 16-byte-aligned x and g, an
//    even map whose half has a TMA box of one K slice (wgrad::boxes; every
//    main-path map).  A block's tile lies in one tap (kh, kw); with
//    kh - pt = 2 qh + rh (rh the row parity, qh the shift) and the same for
//    columns, the tap reads x's parity plane (rh, rw) shifted by (qh, qw)
//    against g's pixel, so x is a 5-D tensor map [B][H/2][2][W/2][2*Cin]
//    whose plane is a coordinate and whose shift is the box's offset (the
//    tensor map fills zeros past every edge, the SAME pads among them), g
//    a 4-D map [B][Ho][Wo][Co] of the same boxes.  A producer warp keeps
//    the ring's loads in flight; the consumers keep one wgmma group in
//    flight.
//  * mma (bf16, Co a multiple of 8 and Cin a multiple of 8 or at most 4,
//    16-byte-aligned x and g: odd maps, the RGB layers): a tile's rows may
//    span taps (Cin = 3: 75 rows, two tiles, not 25, each row gathered
//    from its own tap: THIN).  Where 64 pixels are one row of g's map or
//    two whole rows of 32 (every main-path RGB layer), a slice is 64 pixels
//    whose input rows (5 of 131 pixels, or 7 of 67) come first into shared
//    memory in one coalesced pass, and the 75 rows are read from there
//    (staged).
//  * tile (f32 FMA): f32 and ragged channels.

#include "down0.cuh"
#include "upconv_dx.cuh"

namespace {

// The policy of wgrad.cuh: 25 products, row m = tap*Cc + (ci - c0), tap =
// kh*5 + kw; every tap reads g's pixel (one run); K runs over g's map
// Ho x Wo (Chunk's Hp x Wp).
struct CDw : wgrad::Chunk {
  static constexpr int PRODUCTS = 25, TAPS = 25, GROUPS = 1, SPAN = 1,
                       SPLIT = 1;
  static constexpr bool THIN = true;
  // the staged rows of a slice of 64 pixels of g's map, one row (Wo a
  // multiple of 64) or two whole rows of 32: x's rows 2i0 - pt + k (k < 5,
  // or < 7 for two rows), pixels 2j0 - pl .. 2j0 - pl + FOOT_W - 1
  static constexpr int FOOT_W1 = 2 * 63 + 5, FOOT_W2 = 2 * 31 + 5;
  int H, W, pt, pl;   // x's map and its SAME pads (1, 1) even, (2, 2) odd

  // x's pixel that tap (kh, kw) reads for g's pixel q: (2i + kh - pt,
  // 2j + kw - pl)
  __device__ __forceinline__ long long x_at(const wgrad::Pix& q,
                                            int tap) const {
    const int iy = 2 * q.i + tap / 5 - pt, ix = 2 * q.j + tap % 5 - pl;
    if (q.b < 0 || iy < 0 || iy >= H || ix < 0 || ix >= W) return -1;
    return ((static_cast<long long>(q.b) * H + iy) * W + ix) * Cin;
  }
  __device__ __forceinline__ long long g_at(const wgrad::Pix& q, int) const {
    return q.b < 0 ? -1
                   : ((static_cast<long long>(q.b) * Hp + q.i) * Wp + q.j) *
                         Co;
  }
  // kh - pt = 2*qh + rh: x's parity plane rh shifted by qh (floor), and
  // the same for columns, rw a channel offset of rw * Cin
  struct Shift {
    int cx, qw, rh, qh;
  };
  __device__ __forceinline__ Shift shift(int tap) const {
    const int eh = tap / 5 - pt, ew = tap % 5 - pl;
    const int rh = eh & 1, rw = ew & 1;
    return Shift{rw * Cin, (ew - rw) / 2, rh, (eh - rh) / 2};
  }
  __device__ __forceinline__ void load_x(uint32_t dst, const CUtensorMap* map,
                                         const Shift& s, int ci,
                                         const wgrad::Pix& q,
                                         uint32_t bar) const {
    wgrad::tma_load_5d(dst, map, s.cx + ci, q.j + s.qw, s.rh, q.i + s.qh,
                       q.b, bar);
  }
  __device__ __forceinline__ void load_g(uint32_t dst, const CUtensorMap* map,
                                         const Shift&, int co,
                                         const wgrad::Pix& q,
                                         uint32_t bar) const {
    igemm90::tma_load_4d(dst, map, co, q.j, q.i, q.b, bar);
  }
  // the products are dw's taps
  template <class F>
  __device__ __forceinline__ static void fold(const float* d, int tap,
                                              F&& out) {
    out(tap, d[0]);
  }

  // the RGB layers' staged gather: where every slice of 64 pixels is one
  // row of g's map or two whole rows of 32 of one image (5 * FOOT_W1 *
  // Cin <= wgrad STAGE_ELEMS)
  static bool can_stage(const CDw& p) {
    return p.Cin <= 4 &&
           (p.Wp % STAGED_SLICE == 0 || (p.Wp == 32 && p.Hp % 2 == 0));
  }
  // staged element e's row k and offset along it (k past the rows: none)
  __device__ __forceinline__ void stage_split(int e, int& k,
                                              int& rem) const {
    const bool two = Wp < STAGED_SLICE;
    const int row = (two ? FOOT_W2 : FOOT_W1) * Cin;
    k = e / row;
    rem = e - k * row;
    if (k >= (two ? 7 : 5)) k = 1 << 20;
  }
  // that element for the slice from pixel q0: x's row 2i0 - pt + k from
  // pixel 2j0 - pl, contiguous along the row; 0 off the map
  __device__ __forceinline__ uint16_t stage_rows(const wgrad::Pix& q0, int k,
                                                 int rem) const {
    const int iy = 2 * q0.i - pt + k, fx = (2 * q0.j - pl) * Cin + rem;
    if (q0.b < 0 || iy < 0 || iy >= H || fx < 0 || fx >= W * Cin) return 0;
    return static_cast<const uint16_t*>(
        x)[(static_cast<long long>(q0.b) * H + iy) * W * Cin + fx];
  }
  // where (tap, ci) and pixel rr of the slice sit in the staged rows: pixel
  // (di, dj) of the slice reads staged row 2di + kh, pixel 2dj + kw, so the
  // offset is staged_pixel(rr) + staged_row(tap, ci)
  __device__ __forceinline__ int staged_row(int tap, int ci) const {
    const int fw = Wp < STAGED_SLICE ? FOOT_W2 : FOOT_W1;
    return ((tap / 5) * fw + tap % 5) * Cin + ci;
  }
  __device__ __forceinline__ int staged_pixel(int rr) const {
    const bool two = Wp < STAGED_SLICE;
    const int di = two ? rr >> 5 : 0, dj = two ? rr & 31 : rr;
    return (2 * di * (two ? FOOT_W2 : FOOT_W1) + 2 * dj) * Cin;
  }

  cudaError_t launch_wgmma(int tile_m, int tile_n, int B, cudaStream_t s,
                           int*) const {
    if (tile_m == 64)
      return tile_n == 64 ? launch_dw_wgmma<CDw, 64, 64>(*this, B, s)
                          : launch_dw_wgmma<CDw, 64, 128>(*this, B, s);
    return tile_n == 64 ? launch_dw_wgmma<CDw, 128, 64>(*this, B, s)
                        : launch_dw_wgmma<CDw, 128, 128>(*this, B, s);
  }

  // x [B][H][W][Cin] as [B][H/2][2 (rh)][W/2][2 (rw) * Cin] and g
  // [B][Ho][Wo][Co], boxes of 64 channels by one K slice of g's map
  cudaError_t maps(CUtensorMap* xmap, CUtensorMap* gmap, int B) const {
    const wgrad::Box bx = wgrad::box(Hp, Wp);
    const cuuint64_t cin = static_cast<cuuint64_t>(Cin);
    const cuuint64_t xd[5] = {2 * cin, static_cast<cuuint64_t>(Wp), 2,
                              static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(B)};
    const cuuint64_t xs[4] = {2 * cin * 2, W * cin * 2, 2 * W * cin * 2,
                              static_cast<cuuint64_t>(H) * W * cin * 2};
    const cuuint32_t xb[5] = {64, bx.w, 1, bx.rows, bx.imgs};
    cudaError_t err = igemm90::encode_tiled(xmap, 5, x, xd, xs, xb);
    if (err != cudaSuccess) return err;
    const cuuint64_t gd[4] = {static_cast<cuuint64_t>(Co),
                              static_cast<cuuint64_t>(Wp),
                              static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(B)};
    const cuuint64_t gs[3] = {gd[0] * 2, gd[0] * gd[1] * 2,
                              gd[0] * gd[1] * gd[2] * 2};
    const cuuint32_t gb[4] = {64, bx.w, bx.rows, bx.imgs};
    return igemm90::encode_tiled(gmap, 4, g, gd, gs, gb);
  }
};

int cdw_path(const void* x, const void* g, int H, int W, int Cin, int Co,
             bool bf16) {
  const bool aligned = igemm::aligned16(x) && igemm::aligned16(g);
  if (bf16 && aligned && Cin % 64 == 0 && Co % 64 == 0 && H % 2 == 0 &&
      W % 2 == 0 && wgrad::boxes(H / 2, W / 2))
    return wgrad::kWgmma;
  return bf16 && aligned && (Cin % 8 == 0 || Cin <= 4) && Co % 8 == 0
             ? wgrad::kMma : wgrad::kTile;
}

// ---------------------------------------------------------------- dx ----
// The conv's input gradient on dx90's ring loop (upconv_dx.cuh), under the
// policy CDxRing.  For dx's parity (py, px) and the SAME pads (pt, pl), the
// taps kh = (py + pt) % 2 + 2*ih (ih < 3 where py + pt is even, else < 2)
// read gc's row m + (py + pt - kh) / 2 for dx row i = 2m + py, and the same
// along the columns: four GEMMs of 9, 6, 6 and 4 taps, M = B*Ho*Wo rows of
// a parity plane of dx (a row past the map on an odd map writes nothing),
// N = Cin, K = taps x Co.
//
// A tile is BM pixels of the plane as one box of gc [B][Ho][Wo][Co] of
// 2^lw pixels x 2^lh rows x 2^lb images (each a power of two, the box
// zero-filled past every edge of gc, the SAME pads among them), shifted by
// the tap's offset: every map has a box, the rows of a box past the map are
// computed and dropped.  The weights are w [25][Cin][Co] as they lie, Co
// (K) contiguous: wgmma's K-major operand, no flipped or transposed copy,
// the flip a table of taps.  Row r of the tile is dx's pixel (2m + py,
// 2n + px), written in place (no crop).  The parities run heaviest first
// (the 9-tap one), and the parts of K of a tile are one cluster, summed on
// chip and rounded once (no workspace).
struct CDxParams : dx90::Params {
  int B, Ho, Wo, pt, pl;
  int lw, lh, lb;    // log2 of the tile box's pixels, rows and images
  int ntw, nth;      // tiles along a row of the plane, along its rows
  int tiles;         // tiles of one parity
};

struct CDxRing {
  using P = CDxParams;
  static constexpr bool kOneBlock = false;
  struct T {
    int n0, items, py, px, nw, b0, m0, j0;
  };
  __device__ static T tile(const P& p, int y, int bn) {
    T t;
    const int col = y % p.n_col, rest = y / p.n_col;
    const int k = rest / p.tiles, u = rest - k * p.tiles;
    const int qy = k >> 1, qx = k & 1;   // 0: the 3-tap direction
    t.n0 = col * bn;
    t.py = (p.pt & 1) ^ qy;
    t.px = (p.pl & 1) ^ qx;
    t.nw = 3 - qx;
    t.items = (3 - qy) * t.nw * p.S;
    const int per_img = p.nth * p.ntw, ib = u / per_img,
              rem = u - ib * per_img, ih = rem / p.ntw;
    t.b0 = ib << p.lb;
    t.m0 = ih << p.lh;
    t.j0 = (rem - ih * p.ntw) << p.lw;
    return t;
  }
  template <int BK>
  __device__ static void load(const P& p, const T& t, int item, uint32_t a,
                              uint32_t b, const CUtensorMap* gmap,
                              const CUtensorMap* wmap, uint32_t bar) {
    const int tap = item / p.S, k0 = (item - tap * p.S) * BK;
    const int ih = tap / t.nw, iw = tap - ih * t.nw;
    const int kh = ((t.py + p.pt) & 1) + 2 * ih;
    const int kw = ((t.px + p.pl) & 1) + 2 * iw;
    igemm90::tma_load_4d(a, gmap, k0, t.j0 + (t.px + p.pl - kw) / 2,
                         t.m0 + (t.py + p.pt - kh) / 2, t.b0, bar);
    igemm90::tma_load_2d(b, wmap, k0, (kh * 5 + kw) * p.Cin + t.n0, bar);
  }
  __device__ static long long out(const P& p, const T& t, int r) {
    const int b = t.b0 + (r >> (p.lh + p.lw));
    const int i = 2 * (t.m0 + ((r >> p.lw) & ((1 << p.lh) - 1))) + t.py;
    const int j = 2 * (t.j0 + (r & ((1 << p.lw) - 1))) + t.px;
    if (b >= p.B || i >= p.H || j >= p.W) return -1;
    return ((static_cast<long long>(b) * p.H + i) * p.W + j) * p.Cin;
  }
};

inline int log2_ceil(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// The tile's box of bm pixels of an Ho x Wo plane: 2^lw pixels (the row's
// power of two, at most bm), 2^lh rows, 2^lb images.
inline void cdx_box(CDxParams& p, int bm) {
  const int lbm = log2_ceil(bm);
  p.lw = log2_ceil(p.Wo) < lbm ? log2_ceil(p.Wo) : lbm;
  p.lh = log2_ceil(p.Ho) < lbm - p.lw ? log2_ceil(p.Ho) : lbm - p.lw;
  p.lb = lbm - p.lw - p.lh;
  p.ntw = (p.Wo + (1 << p.lw) - 1) >> p.lw;
  p.nth = (p.Ho + (1 << p.lh) - 1) >> p.lh;
  p.tiles = ((p.B + (1 << p.lb) - 1) >> p.lb) * p.nth * p.ntw;
}

template <int BN>
cudaError_t launch_cdx(const void* gc, const void* w, void* dx, int B, int H,
                       int W, int Cin, int Co, int parts, cudaStream_t s) {
  constexpr int BK = 64;
  using R = dx90::Ring<BN, BK>;
  auto kernel = dx90::ring_kernel<BN, BK, CDxRing>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  CDxParams p;
  static_cast<dx90::Params&>(p) =
      dx90::params(dx, B, H, W, Cin, Co, BK, BN, parts);
  p.B = B;
  p.Ho = (H + 1) / 2;
  p.Wo = (W + 1) / 2;
  p.pt = ((p.Ho - 1) * 2 + 5 - H) / 2;
  p.pl = ((p.Wo - 1) * 2 + 5 - W) / 2;
  cdx_box(p, dx90::BM);
  const long long blocks = 4LL * p.tiles * p.n_col;
  if (blocks > 65535) return cudaErrorInvalidValue;   // the grid's y extent
  const cuuint64_t gd[4] = {static_cast<cuuint64_t>(Co),
                            static_cast<cuuint64_t>(p.Wo),
                            static_cast<cuuint64_t>(p.Ho),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t gs[3] = {gd[0] * 2, gd[0] * gd[1] * 2,
                            gd[0] * gd[1] * gd[2] * 2};
  const cuuint32_t gb[4] = {BK, 1u << p.lw, 1u << p.lh, 1u << p.lb};
  CUtensorMap gmap = {}, wmap = {};
  if ((err = igemm90::encode_tiled(&gmap, 4, gc, gd, gs, gb)) !=
          cudaSuccess ||
      (err = dx90::w_map(&wmap, w, Cin, Co, BK, BN, 25)) != cudaSuccess)
    return err;
  return launch_clustered(kernel, dim3(parts, static_cast<unsigned>(blocks),
                                       1),
                          dx90::THREADS, R::SMEM, parts, s, p, gmap, wmap);
}

// The patch kernel (Cin 64 on maps of 64-pixel plane rows: the 256 px D's
// 128^2 dx, bound by operations at 2*25*B*64^2*64*Co / 4, where the box of
// gc a tap of the ring moves 25x gc and, with it, the weights of a tile
// across L2 -> SM for only 64 columns of dx): a block owns one parity
// plane's tile of 8 plane rows x 64 pixels and computes dx^T, D[64 ci x 64
// px] per plane row on m64n64k16, the weights w[kh][kw] (64 ci x 64 k, as
// they lie) as the 64-row operand.  Every tap of the parity reads one staged
// patch of gc (10 rows x 66 pixels around the tile, zero-filled past the
// edges): tap (di, dj) of plane row r starts its descriptor at patch row
// r + di + 1, pixel dj + 1 -- whole 128-byte rows of the swizzled layout,
// so no base offset.  L2 -> SM bytes of A fall from 25x gc to ~1.3x gc per
// parity's taps, of weights to a tap's 8 KB per 512 pixels.  A producer
// warp keeps two patches (a K slice each) and three weight tiles in
// flight; the blocks are persistent (one an SM), walking the tiles of the
// four parities heaviest first.  Each warpgroup owns 4 plane rows; a row's
// 64 px x 64 ci go out through a swizzled staging tile and one TMA store
// into dx viewed as [B][H/2][2][W/2][2*Cin], the parity plane a
// coordinate, while the next tile's loads run.
namespace cdxp {

constexpr int TR = 8, TW = 64, PW = TW + 2, ROWS = TR + 2;
constexpr int PATCH = (ROWS * PW * 128 + 1023) / 1024 * 1024;
constexpr int PATCH_BOX = ROWS * PW * 128;
constexpr int W_TILE = 64 * 128;
constexpr int W_STAGES = 3;
constexpr int Y_TILE = TW * 128;                     // 64 px x 64 ci bf16
constexpr int SMEM = 1024 + 2 * PATCH + W_STAGES * W_TILE + 2 * Y_TILE;

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

struct Tile {
  int py, px, nw, taps, b, m0, j0;
};

__device__ __forceinline__ Tile tile_of(const CDxParams& p, int t) {
  Tile q;
  const int k = t / p.tiles, u = t - k * p.tiles;
  const int qy = k >> 1, qx = k & 1;
  q.py = (p.pt & 1) ^ qy;
  q.px = (p.pl & 1) ^ qx;
  q.nw = 3 - qx;
  q.taps = (3 - qy) * q.nw;
  const int per_img = p.nth * p.ntw, rem = u % per_img;
  q.b = u / per_img;
  q.m0 = rem / p.ntw * TR;
  q.j0 = rem % p.ntw * TW;
  return q;
}

// tap i of the tile's parity: (kh, kw) and gc's offset (di, dj)
__device__ __forceinline__ int4 tap_of(const CDxParams& p, const Tile& q,
                                       int i) {
  const int ih = i / q.nw, iw = i - ih * q.nw;
  const int kh = ((q.py + p.pt) & 1) + 2 * ih;
  const int kw = ((q.px + p.pl) & 1) + 2 * iw;
  return make_int4(kh, kw, (q.py + p.pt - kh) / 2, (q.px + p.pl - kw) / 2);
}

__global__ void __launch_bounds__(dx90::THREADS, 1)
    patch_kernel(const CDxParams p, const __grid_constant__ CUtensorMap gmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap ymap) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long pfull[2], pempty[2];
  __shared__ __align__(8) unsigned long long wfull[W_STAGES], wempty[W_STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t patches = (raw + 1023u) & ~1023u;
  const uint32_t wts = patches + 2 * PATCH;
  const uint32_t ystage = wts + W_STAGES * W_TILE;
  const int tid = threadIdx.x;
  const int total = 4 * p.tiles;
  const int my_tiles = blockIdx.x < total
                           ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x
                           : 0;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&pfull[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&pempty[s]), 2);
    }
    for (int s = 0; s < W_STAGES; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&wfull[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&wempty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= dx90::CONSUMERS) {
    if (tid == dx90::CONSUMERS) {
      int np = 0, nw = 0;   // patches and weight tiles loaded so far
      for (int k = 0; k < my_tiles; ++k) {
        const Tile q = tile_of(p, blockIdx.x + k * gridDim.x);
        for (int s = 0; s < p.S; ++s, ++np) {
          const int ps = np & 1;
          if (np >= 2)
            igemm90::mbar_wait(igemm90::smem_u32(&pempty[ps]),
                               ((np >> 1) + 1) & 1);
          const uint32_t bar = igemm90::smem_u32(&pfull[ps]);
          igemm90::mbar_expect_tx(bar, PATCH_BOX);
          igemm90::tma_load_4d(patches + ps * PATCH, &gmap, s * 64,
                               q.j0 - 1, q.m0 - 1, q.b, bar);
          for (int i = 0; i < q.taps; ++i, ++nw) {
            const int ws = nw % W_STAGES;
            if (nw >= W_STAGES)
              igemm90::mbar_wait(igemm90::smem_u32(&wempty[ws]),
                                 ((nw / W_STAGES) + 1) & 1);
            const int4 t = tap_of(p, q, i);
            const uint32_t wb = igemm90::smem_u32(&wfull[ws]);
            igemm90::mbar_expect_tx(wb, W_TILE);
            igemm90::tma_load_2d(wts + ws * W_TILE, &wmap, s * 64,
                                 (t.x * 5 + t.y) * p.Cin, wb);
          }
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, tid128 = tid & 127;
  const uint32_t y_mine = ystage + wg * Y_TILE;
  uint8_t* y_ptr = smem_raw + (y_mine - raw);
  float acc[4][32];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[r][i] = 0.f;
  int np = 0, nw = 0;
  for (int k = 0; k < my_tiles; ++k) {
    const Tile q = tile_of(p, blockIdx.x + k * gridDim.x);
    for (int s = 0; s < p.S; ++s, ++np) {
      const int ps = np & 1;
      igemm90::mbar_wait(igemm90::smem_u32(&pfull[ps]), (np >> 1) & 1);
      const uint32_t patch = patches + ps * PATCH;
      for (int i = 0; i < q.taps; ++i, ++nw) {
        const int ws = nw % W_STAGES;
        igemm90::mbar_wait(igemm90::smem_u32(&wfull[ws]),
                           (nw / W_STAGES) & 1);
        const int4 t = tap_of(p, q, i);
        const uint64_t ad = dx90::desc<128>(wts + ws * W_TILE);
        igemm90::wgmma_fence();
        const uint64_t bd = dx90::desc<128>(
            patch + ((wg * 4 + t.z + 1) * PW + t.w + 1) * 128);
        // the four rows' chains interleaved (each row's k16 steps in
        // order): one row's next step waits on its accumulator
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)     // +32 bytes a k16 step
#pragma unroll
          for (int r = 0; r < 4; ++r)      // +PW rows of 128 bytes a row
            dx90::Mma<64>::mma(acc[r], ad + 2 * kk,
                               bd + 2 * kk + r * (PW * 128 >> 4));
        igemm90::wgmma_commit();
        igemm90::wgmma_wait<1>();
        // the group of the previous tap of this slice is done: its
        // weights are free
        if (i > 0 && tid128 == 0)
          wgrad::mbar_arrive(
              igemm90::smem_u32(&wempty[(nw - 1) % W_STAGES]));
      }
      igemm90::wgmma_wait<0>();
      if (tid128 == 0) {
        wgrad::mbar_arrive(igemm90::smem_u32(&wempty[(nw - 1) % W_STAGES]));
        wgrad::mbar_arrive(igemm90::smem_u32(&pempty[ps]));
      }
    }
    // the warpgroup's 4 plane rows out: 64 px x 64 ci each, transposed
    // into the swizzled staging tile, one TMA store into the parity view
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (tid128 == 0) dx90::bulk_wait_read();
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int ci = igemm90::acc_row(tid128, i);
        const int px = igemm90::acc_col(tid128, i);
        *reinterpret_cast<__nv_bfloat16*>(
            y_ptr + px * 128 + (((ci >> 3) ^ (px & 7)) << 4) + (ci & 7) * 2) =
            __float2bfloat16(acc[r][i]);
        acc[r][i] = 0.f;
      }
      igemm90::fence_async_proxy();
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      if (tid128 == 0)
        tma_store_5d(&ymap, y_mine, q.px * p.Cin, q.j0, q.py,
                     q.m0 + wg * 4 + r, q.b);
    }
  }
  if (tid128 == 0) dx90::bulk_wait();
}

}  // namespace cdxp

// the patch kernel's maps: 8-row x 64-pixel plane tiles, dx viewed by
// parity plane (even maps)
inline bool cdx_patches(int H, int W) { return H % 16 == 0 && W % 128 == 0; }

cudaError_t launch_cdx_patch(const void* gc, const void* w, void* dx, int B,
                             int H, int W, int Cin, int Co, cudaStream_t s) {
  auto kernel = cdxp::patch_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cdxp::SMEM);
  if (err != cudaSuccess) return err;
  CDxParams p;
  static_cast<dx90::Params&>(p) = dx90::params(dx, B, H, W, Cin, Co, 64, 64, 1);
  p.B = B;
  p.Ho = H / 2;
  p.Wo = W / 2;
  p.pt = 1;
  p.pl = 1;
  p.ntw = p.Wo / cdxp::TW;
  p.nth = p.Ho / cdxp::TR;
  p.tiles = B * p.nth * p.ntw;
  const cuuint64_t gd[4] = {static_cast<cuuint64_t>(Co),
                            static_cast<cuuint64_t>(p.Wo),
                            static_cast<cuuint64_t>(p.Ho),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t gs[3] = {gd[0] * 2, gd[0] * gd[1] * 2,
                            gd[0] * gd[1] * gd[2] * 2};
  const cuuint32_t gb[4] = {64, cdxp::PW, cdxp::ROWS, 1};
  const cuuint32_t yb[3] = {cdxp::TW, 1, 1};
  CUtensorMap gmap = {}, wmap = {}, ymap = {};
  if ((err = igemm90::encode_tiled(&gmap, 4, gc, gd, gs, gb)) !=
          cudaSuccess ||
      (err = dx90::w_map(&wmap, w, Cin, Co, 64, 64, 25)) != cudaSuccess ||
      (err = dx90::g_map(&ymap, dx, B, p.Ho, p.Wo, Cin, 64, yb)) !=
          cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int grid = 4 * p.tiles < sms ? 4 * p.tiles : sms;
  kernel<<<grid, dx90::THREADS, cdxp::SMEM, s>>>(p, gmap, wmap, ymap);
  return cudaGetLastError();
}

enum CDxKernel { kCdxRing = 0, kCdxPatch = 1 };
// What a launch of t2i_conv5x5_s2_dx did, as bits: A by TMA (every launch),
// the parts of K summed in a cluster, the taps of a parity from one staged
// patch (the patch kernel's dx^T)
enum CDxMode { kCdxTmaA = 1, kCdxCluster = 2, kCdxShared = 4 };

// bf16, Cin and Co multiples of 64, 16-byte-aligned gc, w and dx: every
// map (odd ones too) has a box
bool cdx_applies(const void* gc, const void* w, const void* dx, int Cin,
                 int Co, bool bf16) {
  return bf16 && Cin % 64 == 0 && Co % 64 == 0 && igemm::aligned16(gc) &&
         igemm::aligned16(w) && igemm::aligned16(dx);
}

int g_last_dx_mode = 0;   // the CDxMode bits of t2i_conv5x5_s2_dx's last launch

// ----------------------------------------------------------- deconv dx ----
// deconv5x5_s2_dx: the transposed convolution's input gradient, the input
// half of text_to_image_tpu/ops/pallas/conv.py _deconv_bwd (the
// jax.linear_transpose of its lax.conv_transpose, left to XLA):
//
//   dx[b,i,j,ci] = sum_{kh,kw,co} d[b, 2i+kh-1, 2j+kw-1, co]
//                                 * w[4-kh, 4-kw, ci, co]
//
// for the cotangent d [B,2H,2W,Co] (act' and the scale already in it) and
// w [5,5,Cin,Co]: the stride-2 SAME conv of d with w flipped and
// transposed, M = B*H*W rows of dx, N = Cin, K = 25*Co, 2*M*N*K operations
// (0.0271 ms at 989 TFLOP/s for each of the GAN-CLS generator's three deep
// calls at B 64; its RGB layer's, Co = 3, bound by dx's bytes: 0.0055 ms).
// No flipped copy of w, no zero bias, no workspace.  Two paths (the
// wrapper mirrors the rule, ops/kernels/conv.py deconv_dx_path):
//  * ring (bf16, Cin and Co multiples of 64): dx90's ring loop under the
//    policy DDxRing.  d's map is always even, so tap kh reads d's row
//    parity py = (kh + 1) % 2 shifted by (kh - 1 - py) / 2 in {-1, 0, 1}:
//    one zero-filled box a tap of d viewed as [B][H][2][W][2*Co] (the dw
//    kernels' view; the SAME pads (1, 2) are the box's edges), a tile of
//    BM pixels of dx a box of 2^lw x 2^lh x 2^lb (cdx_box).  B is w[4-kh,
//    4-kw] = [Cin][Co] with Co (K) contiguous, wgmma's K-major operand as
//    the weight lies: the flip is a table of taps.  dx is written in plain
//    NHWC rows by the cluster's sum_store, the parts of K of a tile summed
//    on chip (the 4^2 output: M = 1024, K = 12800).
//  * thin (bf16, Co <= 4, Cin a multiple of 64; the RGB layer's dx and the
//    critic's first-layer dx in the gradient penalty's second order):
//    down0.cuh's kernel with N = 128 (64 where Cin is not a multiple of
//    128) columns of dx a block, the weights B[(kh,kw,c)][n] = w[4-kh]
//    [4-kw][n][c] built in shared memory from w as it lies (its taps copied
//    by 16-byte loads, then gathered with the flip and the transpose in the
//    index); d read once, dx written as whole rows.
struct DDxRing {
  using P = CDxParams;   // Ho x Wo: dx's map H x W
  static constexpr bool kOneBlock = true;
  struct T {
    int n0, items, b0, i0, j0;
  };
  __device__ static T tile(const P& p, int y, int bn) {
    T t;
    const int col = y % p.n_col, u = y / p.n_col;
    t.n0 = col * bn;
    t.items = 25 * p.S;
    const int per_img = p.nth * p.ntw, ib = u / per_img,
              rem = u - ib * per_img, ih = rem / p.ntw;
    t.b0 = ib << p.lb;
    t.i0 = ih << p.lh;
    t.j0 = (rem - ih * p.ntw) << p.lw;
    return t;
  }
  template <int BK>
  __device__ static void load(const P& p, const T& t, int item, uint32_t a,
                              uint32_t b, const CUtensorMap* gmap,
                              const CUtensorMap* wmap, uint32_t bar) {
    const int tap = item / p.S, k0 = (item - tap * p.S) * BK;
    const int kh = tap / 5, kw = tap - kh * 5;
    const int py = (kh + 1) & 1, px = (kw + 1) & 1;
    wgrad::tma_load_5d(a, gmap, px * p.Co + k0, t.j0 + (kw - 1 - px) / 2,
                       py, t.i0 + (kh - 1 - py) / 2, t.b0, bar);
    igemm90::tma_load_2d(b, wmap, k0, (24 - tap) * p.Cin + t.n0, bar);
  }
  __device__ static long long out(const P& p, const T& t, int r) {
    const int b = t.b0 + (r >> (p.lh + p.lw));
    const int i = t.i0 + ((r >> p.lw) & ((1 << p.lh) - 1));
    const int j = t.j0 + (r & ((1 << p.lw) - 1));
    if (b >= p.B || i >= p.H || j >= p.W) return -1;
    return ((static_cast<long long>(b) * p.H + i) * p.W + j) * p.Cin;
  }
};

template <int BN>
cudaError_t launch_ddx(const void* d, const void* w, void* dx, int B, int H,
                       int W, int Cin, int Co, int parts, cudaStream_t s) {
  constexpr int BK = 64;
  using R = dx90::Ring<BN, BK, DDxRing::kOneBlock>;
  auto kernel = dx90::ring_kernel<BN, BK, DDxRing>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  CDxParams p;
  static_cast<dx90::Params&>(p) =
      dx90::params(dx, B, H, W, Cin, Co, BK, BN, parts);
  p.B = B;
  p.Ho = H;
  p.Wo = W;
  p.pt = p.pl = 1;
  cdx_box(p, dx90::BM);
  const long long blocks = static_cast<long long>(p.tiles) * p.n_col;
  if (blocks > 65535) return cudaErrorInvalidValue;   // the grid's y extent
  const cuuint32_t box[3] = {1u << p.lw, 1u << p.lh, 1u << p.lb};
  CUtensorMap gmap = {}, wmap = {};
  if ((err = dx90::g_map(&gmap, d, B, H, W, Co, BK, box)) != cudaSuccess ||
      (err = dx90::w_map(&wmap, w, Cin, Co, BK, BN, 25)) != cudaSuccess)
    return err;
  return launch_clustered(kernel, dim3(parts, static_cast<unsigned>(blocks),
                                       1),
                          dx90::THREADS, R::SMEM, parts, s, p, gmap, wmap);
}

// down0.cuh's problem for the thin path: the conv of d (2H x 2W, Co <= 4
// channels, pads (1, 2)) into dx's H x W map, Cin columns; no bias, no
// activation
struct DDxThin : igemm::Common {
  static constexpr bool kOneColumnTile = false;   // Cin / N column tiles
  int H, W, Ho, Wo, pad_top, pad_left;
  __device__ float add(int, int) const { return 0.f; }
  // the weights [K][N] of column tile n0: each tap's slice w[t][n0 ..
  // n0 + N)[0 .. CIN) (contiguous) copied into `scratch` by 16-byte loads,
  // then B[(kh, kw, c)][n] = w[4 - kh][4 - kw][n0 + n][c] gathered from it
  template <int CIN, int NT, int KP, int THREADS>
  __device__ void stage_weights(uint8_t* b, uint8_t* scratch, int n0,
                                int tid) const {
    constexpr int TAP = NT * CIN, V = TAP / 8;
    constexpr int LOADS = (25 * V + THREADS - 1) / THREADS;
    const uint16_t* wp = static_cast<const uint16_t*>(w);
    uint16_t* sc = reinterpret_cast<uint16_t*>(scratch);
    // every load of this thread in flight together, then stored
    uint4 r[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int q = tid + i * THREADS, t = q / V, v = q - t * V;
      if (q < 25 * V)
        r[i] = __ldg(reinterpret_cast<const uint4*>(
            wp + (static_cast<long long>(t) * N + n0) * CIN + v * 8));
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int q = tid + i * THREADS;   // tap q / V, vector q % V
      if (q < 25 * V) *reinterpret_cast<uint4*>(sc + q * 8) = r[i];
    }
    __syncthreads();
    for (int q = tid; q < KP * (NT / 8); q += THREADS) {
      const int kr = q / (NT / 8), c = q % (NT / 8);
      uint32_t u[4] = {0u, 0u, 0u, 0u};
      if (kr < 25 * CIN) {
        const int tap = kr / CIN, ch = kr - tap * CIN;
        const uint16_t* src = sc + (24 - tap) * TAP + c * 8 * CIN + ch;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          u[e >> 1] |= static_cast<uint32_t>(src[e * CIN]) << (16 * (e & 1));
      }
      *reinterpret_cast<uint4*>(b + down0::b_chunk(kr, c)) =
          make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
};

template <int N>
cudaError_t launch_ddx_thin(const void* d, const void* w, void* dx, int B,
                            int H, int W, int Cin, int Co, cudaStream_t s) {
  DDxThin p;
  p.a = d;
  p.w = w;
  p.y = dx;
  p.M = B * H * W;
  p.N = Cin;
  p.Cin = Co;
  p.taps = 25;
  p.act = igemm::kNone;
  p.vec_a = p.vec_w = p.vec_y = 1;
  p.H = 2 * H;
  p.W = 2 * W;
  p.Ho = H;
  p.Wo = W;
  p.pad_top = p.pad_left = 1;
  switch (Co) {
    case 1: return down0::launch<1, N>(p, B, s);
    case 2: return down0::launch<2, N>(p, B, s);
    case 3: return down0::launch<3, N>(p, B, s);
    default: return down0::launch<4, N>(p, B, s);
  }
}

enum DDxPath { kDdxConv = 0, kDdxRing = 1, kDdxThin = 2 };

// bf16 and 16-byte-aligned d, w and dx: the ring for Cin and Co multiples
// of 64, the thin path for Co <= 4 and Cin a multiple of 64; else the
// caller's route (conv5x5_s2_act of d with w flipped and transposed)
int ddx_path(const void* d, const void* w, const void* dx, int Cin, int Co,
             bool bf16) {
  if (!bf16 || !igemm::aligned16(d) || !igemm::aligned16(w) ||
      !igemm::aligned16(dx) || Cin % 64)
    return kDdxConv;
  if (Co % 64 == 0) return kDdxRing;
  return Co <= 4 ? kDdxThin : kDdxConv;
}

}  // namespace

// The path t2i_conv5x5_s2_dw takes for x [B][H][W][Cin] and g: 0 the FMA
// tile, 1 wgmma, 2 mma.sync.
extern "C" int t2i_conv5x5_s2_dw_path(const void* x, const void* g, int H,
                                      int W, int Cin, int Co, int bf16) {
  return cdw_path(x, g, H, W, Cin, Co, bf16 != 0);
}

static int g_last_mode = 0;   // the Mode bits of the last launch

// dw [5][5][Cin][Co] (bf16 when w_bf16, else f32), or with `flip` the
// transposed convolution's weight gradient [5][5][Co][Cin] (tap 24 - t,
// (co, ci) swapped), from x [B][H][W][Cin] and g
// [B][ceil(H/2)][ceil(W/2)][Co] (both bf16 when bf16, else f32), on
// `stream`: the 25 products in `parts` parts of K, `cluster` of them in a
// cluster (wgrad.cuh dw_launch); where parts / cluster > 1, each cluster's
// sum into `ws` (f32, (parts/cluster)*25*chunk*Co, a chunk of `chunk`
// input channels at a time) and then the sum of those into dw.  tile_m x
// tile_n is read on the wgmma path only.  Returns the CUDA error code (0
// when launched).
extern "C" int t2i_conv5x5_s2_dw(const void* x, const void* g, void* dw,
                                 void* ws, int B, int H, int W, int Cin,
                                 int Co, int bf16, int w_bf16, int tile_m,
                                 int tile_n, int parts, int cluster,
                                 int chunk, int flip, void* stream) {
  CDw p;
  if (!p.set(x, g, dw, ws, B, (H + 1) / 2, (W + 1) / 2, Cin, Co, parts,
             cluster, w_bf16, flip))
    return cudaErrorInvalidValue;
  p.H = H;
  p.W = W;
  p.pt = ((p.Hp - 1) * 2 + 5 - H) / 2;
  p.pl = ((p.Wp - 1) * 2 + 5 - W) / 2;
  const int path = cdw_path(x, g, H, W, Cin, Co, bf16 != 0);
  if (path == wgrad::kWgmma &&
      ((tile_m != 64 && tile_m != 128) || (tile_n != 64 && tile_n != 128) ||
       Cin % tile_m || chunk % tile_m || Co % tile_n))
    return cudaErrorInvalidValue;
  return dw_launch(p, path, bf16 != 0, tile_m, tile_n, chunk, B,
                   static_cast<cudaStream_t>(stream), &g_last_mode);
}

// What the last launch of t2i_conv5x5_s2_dw in this process did
// (wgrad::Mode bits: 1 dw written by the kernel, 2 a cluster's parts
// summed on chip, 4 a workspace and its reduction, 32 the staged RGB
// gather, 64 the producer-warp main loop).
extern "C" int t2i_conv5x5_s2_dw_mode() { return g_last_mode; }

// Clusters of csize CTAs of the wgmma kernel of tile tile_m x tile_n the
// card holds at once (cudaOccupancyMaxActiveClusters; the plan's
// capacity); -1 on an error.
extern "C" int t2i_conv5x5_s2_dw_clusters(int csize, int tile_m,
                                          int tile_n) {
  if (tile_m == 64)
    return tile_n == 64
               ? max_clusters(dw_wgmma_kernel<CDw, 64, 64>,
                              wgrad::Tile<64, 64>::THREADS,
                              wgrad::Tile<64, 64>::SMEM, csize)
               : max_clusters(dw_wgmma_kernel<CDw, 64, 128>,
                              wgrad::Tile<64, 128>::THREADS,
                              wgrad::Tile<64, 128>::SMEM, csize);
  return tile_n == 64 ? max_clusters(dw_wgmma_kernel<CDw, 128, 64>,
                                     wgrad::Tile<128, 64>::THREADS,
                                     wgrad::Tile<128, 64>::SMEM, csize)
                      : max_clusters(dw_wgmma_kernel<CDw, 128, 128>,
                                     wgrad::Tile<128, 128>::THREADS,
                                     wgrad::Tile<128, 128>::SMEM, csize);
}

// 1 where t2i_conv5x5_s2_dx takes these pointers and shapes, else 0 (the
// caller's route for the others: deconv5x5_s2 with w flipped and
// transposed).
extern "C" int t2i_conv5x5_s2_dx_path(const void* gc, const void* w,
                                      const void* dx, int Cin, int Co,
                                      int bf16) {
  return cdx_applies(gc, w, dx, Cin, Co, bf16 != 0) ? 1 : 0;
}

// dx [B][H][W][Cin] of conv5x5_s2 SAME for the cotangent gc
// [B][ceil(H/2)][ceil(W/2)][Co] and w [5][5][Cin][Co] (all bf16), on
// `stream`: `kernel` kCdxRing with tiles of 128 pixels x `tile_n` (64, 128,
// 256; dividing Cin) columns and `parts` (1..8, at most the 4*Co/64 items
// of the lightest parity) parts of K in one cluster, or kCdxPatch (Cin 64,
// tile_n 64, one part, H % 16 == 0 and W % 128 == 0).  Returns the CUDA error
// code (0 when launched); no path gives way to another.
extern "C" int t2i_conv5x5_s2_dx(const void* gc, const void* w, void* dx,
                                 int B, int H, int W, int Cin, int Co,
                                 int kernel, int tile_n, int parts,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cdx_applies(gc, w, dx, Cin, Co, true) || parts < 1 ||
      parts > dx90::MAX_PARTS || parts > 4 * (Co / 64) ||
      static_cast<long long>(B) * H * W * Cin >= (1ll << 31))
    return cudaErrorInvalidValue;
  const int cluster = parts > 1 ? kCdxCluster : 0;
  if (kernel == kCdxPatch) {
    if (Cin != 64 || tile_n != 64 || parts != 1 || !cdx_patches(H, W))
      return cudaErrorInvalidValue;
    g_last_dx_mode = kCdxTmaA | kCdxShared;
    return static_cast<int>(
        launch_cdx_patch(gc, w, dx, B, H, W, Cin, Co, s));
  }
  if (kernel != kCdxRing ||
      (tile_n != 64 && tile_n != 128 && tile_n != 256) || Cin % tile_n)
    return cudaErrorInvalidValue;
  g_last_dx_mode = kCdxTmaA | cluster;
  switch (tile_n) {
    case 64:
      return static_cast<int>(
          launch_cdx<64>(gc, w, dx, B, H, W, Cin, Co, parts, s));
    case 128:
      return static_cast<int>(
          launch_cdx<128>(gc, w, dx, B, H, W, Cin, Co, parts, s));
    default:
      return static_cast<int>(
          launch_cdx<256>(gc, w, dx, B, H, W, Cin, Co, parts, s));
  }
}

// What the last launch of t2i_conv5x5_s2_dx in this process did (CDxMode
// bits: 1 A by TMA, 2 parts summed in a cluster, 4 the taps of a parity
// from one staged patch).
extern "C" int t2i_conv5x5_s2_dx_mode() { return g_last_dx_mode; }

// The path t2i_deconv5x5_s2_dx takes for these pointers and channels: 0
// none (the caller's conv5x5_s2_act route), 1 the ring, 2 thin.
extern "C" int t2i_deconv5x5_s2_dx_path(const void* d, const void* w,
                                        const void* dx, int Cin, int Co,
                                        int bf16) {
  return ddx_path(d, w, dx, Cin, Co, bf16 != 0);
}

// dx [B][H][W][Cin] of deconv5x5_s2 for its cotangent d [B][2H][2W][Co]
// and w [5][5][Cin][Co] (all bf16), on `stream`: the ring with tiles of
// 128 pixels x `tile_n` (64, 128, 256; dividing Cin) columns and `parts`
// (1..8) parts of K in one cluster, or the thin path (tile_n 128 where Cin
// is a multiple of 128, else 64; one part).  Returns the CUDA error code
// (0 when launched); no path gives way to another.
extern "C" int t2i_deconv5x5_s2_dx(const void* d, const void* w, void* dx,
                                   int B, int H, int W, int Cin, int Co,
                                   int tile_n, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int path = ddx_path(d, w, dx, Cin, Co, true);
  if (path == kDdxConv || parts < 1 || B < 1 || H < 1 || W < 1 ||
      static_cast<long long>(B) * H * W * Cin >= (1ll << 31) ||
      static_cast<long long>(B) * 4 * H * W * Co >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (path == kDdxThin) {
    if (parts != 1 || tile_n != (Cin % 128 == 0 ? 128 : 64))
      return cudaErrorInvalidValue;
    return static_cast<int>(
        tile_n == 128
            ? launch_ddx_thin<128>(d, w, dx, B, H, W, Cin, Co, s)
            : launch_ddx_thin<64>(d, w, dx, B, H, W, Cin, Co, s));
  }
  if ((tile_n != 64 && tile_n != 128 && tile_n != 256) || Cin % tile_n ||
      parts > dx90::MAX_PARTS)
    return cudaErrorInvalidValue;
  switch (tile_n) {
    case 64:
      return static_cast<int>(
          launch_ddx<64>(d, w, dx, B, H, W, Cin, Co, parts, s));
    case 128:
      return static_cast<int>(
          launch_ddx<128>(d, w, dx, B, H, W, Cin, Co, parts, s));
    default:
      return static_cast<int>(
          launch_ddx<256>(d, w, dx, B, H, W, Cin, Co, parts, s));
  }
}
