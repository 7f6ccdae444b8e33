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
// block computes a [BM x BN] tile of the product matrix over a part of K,
// writes its f32 sums to the caller's workspace [parts][25][Cc][Co], and
// the reduction adds the parts in the order 0..parts-1 into dw: no
// atomics, the same bits every launch.  Cin is walked in chunks of Cc
// channels (every tap of them), one launch and one reduction each, so that
// the workspace stays under the caller's cap at any Cin * Co.  Paths, from
// shapes, types and alignment only (cdw_path; the wrapper mirrors it):
//  * wgmma: bf16, Cin and Co multiples of 64, 16-byte-aligned x and g, an
//    even map whose half has a TMA box of one K slice (wgrad::boxes; every
//    main-path map).  A block's tile lies in one tap (kh, kw); with
//    kh - pt = 2 qh + rh (rh the row parity, qh the shift) and the same for
//    columns, the tap reads x's parity plane (rh, rw) shifted by (qh, qw)
//    against g's pixel, so x is a 5-D tensor map [B][H/2][2][W/2][2*Cin]
//    whose plane is a coordinate and whose shift is the box's offset (the
//    tensor map fills zeros past every edge, the SAME pads among them), g
//    a 4-D map [B][Ho][Wo][Co] of the same boxes.  The 25 taps group by
//    parity into 9 / 6 / 6 / 4 planes (deconv_plan's groups).
//  * mma (bf16, Co a multiple of 8 and Cin a multiple of 8 or at most 4,
//    16-byte-aligned x and g: odd maps, the RGB layers): a tile's rows may
//    span taps (Cin = 3: 75 rows, two tiles, not 25, each row gathered
//    from its own tap: THIN).
//  * tile (f32 FMA): f32 and ragged channels.

#include "wgrad.cuh"

namespace {

// The policy of wgrad.cuh: 25 products, row m = tap*Cc + (ci - c0), tap =
// kh*5 + kw; every tap reads g's pixel (one run); K runs over g's map
// Ho x Wo (Chunk's Hp x Wp).
struct CDw : wgrad::Chunk {
  static constexpr int PRODUCTS = 25, GROUPS = 1, SPAN = 1;
  static constexpr bool THIN = true;
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

// dw [5][5][Cin][Co] (bf16 when w_bf16, else f32) from x [B][H][W][Cin] and
// g [B][ceil(H/2)][ceil(W/2)][Co] (both bf16 when bf16, else f32), on
// `stream`: for each chunk of `chunk` input channels, the 25 products in
// `parts` parts of K each into `ws` (f32, parts*25*chunk*Co), then their
// sum into the chunk's rows of dw (wgrad.cuh dw_launch).  tile_m x tile_n
// is read on the wgmma path only.  Returns the CUDA error code (0 when
// launched).
extern "C" int t2i_conv5x5_s2_dw(const void* x, const void* g, void* dw,
                                 void* ws, int B, int H, int W, int Cin,
                                 int Co, int bf16, int w_bf16, int tile_m,
                                 int tile_n, int parts, int chunk,
                                 void* stream) {
  CDw p;
  if (!p.set(x, g, ws, B, (H + 1) / 2, (W + 1) / 2, Cin, Co, parts))
    return cudaErrorInvalidValue;
  p.H = H;
  p.W = W;
  p.pt = ((p.Hp - 1) * 2 + 5 - H) / 2;
  p.pl = ((p.Wp - 1) * 2 + 5 - W) / 2;
  return dw_launch(p, cdw_path(x, g, H, W, Cin, Co, bf16 != 0), bf16 != 0,
                   w_bf16 != 0, tile_m, tile_n, chunk, B, dw,
                   static_cast<cudaStream_t>(stream));
}
