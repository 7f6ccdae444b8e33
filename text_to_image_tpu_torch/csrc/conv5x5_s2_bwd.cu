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
// its input as g, flipped and transposed by the caller.  The input
// gradients of both ops are the other op's forward kernel (ops/kernels/
// conv.py `_Conv` / `_Deconv`): no library convolution.
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

#include "wgrad.cuh"

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
