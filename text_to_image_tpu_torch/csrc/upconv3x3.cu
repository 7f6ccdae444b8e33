// Fused nearest-upsample x2 + 3x3 convolution for Hopper (sm_90a): the
// StackGAN / PGGAN generator up-block.
//
//   y = act(conv_3x3_SAME(upsample2_nearest(x), w) * scale + shift)
//
// x NHWC [B,H,W,Cin], y NHWC [B,2H,2W,Co], scale and shift f32 [Co]; bf16 or
// f32 in and out, f32 accumulation and epilogue.  The kernel does not read w
// but the combined weights wc [2,2,2,2,Cin,Co] = [py,px,a,b,Cin,Co] that the
// wrapper builds from w in x's type (ops/kernels/conv.py
// combine_upconv_weights): nearest upsampling repeats every input pixel, so
// per spatial dim the three taps over the upsampled map fall on two input
// pixels,
//
//   parity 0: {x[m-1]: W0,    x[m]:   W1+W2}
//   parity 1: {x[m]:   W0+W1, x[m+1]: W2}
//
//   y[b, 2m+py, 2n+px, :] = act(scale * sum_{a,b in {0,1}}
//       x~[b, m+py+a-1, n+px+b-1, :] . wc[py,px,a,b] + shift)
//
// with x~ zero outside the image.  That is 16/36 of the products of the
// convolution over the upsampled map, which is 4x the size of x and never
// exists.
//
// Replaces text_to_image_tpu/ops/pallas/conv.py upconv3x3 / upconv3x3_bias,
// whose Pallas bodies are _upconv_kernel (whole-image blocks, via
// _upconv_op) and _upconv_halo_kernel (row tiles with a one-row halo and
// hand-written double-buffered copies, via _upconv_halo_pallas).  What those
// bodies do for the TPU is not carried over: the padded copy of the image in
// fast memory, channels padded to 128 / 64 lanes, the (px, co)-major lane
// folding of the output, the split into two bodies at H*W > 1024 and the
// row-tile size picked from a memory budget.  One kernel takes every shape.
//
// Decomposition: four implicit GEMMs, one per output parity, each with
// M = B*H*W input-resolution pixels, N = Co and K = 4*Cin walked tap by tap;
// row (b, m, n) of parity (py, px) gathers tap (a, b) at input pixel
// (m+py+a-1, n+px+b-1), zeros outside the image, and the epilogue stores its
// Co outputs at output pixel (2m+py, 2n+px) of the interleaved NHWC map.
// One launch runs all four (igemm.cuh `groups`): the parity is the fastest
// part of the block index, so the four blocks that gather the same input
// tile run together and find it in L2.
//
// Bound on the H100 SXM, bf16, B = 64: operations 2*16*B*H*W*Cin*Co at
// 989 TFLOP/s against bytes x + wc + y at 3.35 TB/s.  Every Stage-I layer
// does 17.2 GFLOP (0.017 ms) against 17-51 MB (0.005-0.015 ms) and the
// first three Stage-II layers 68.7 GFLOP (0.069 ms) against 55-202 MB
// (0.016-0.060 ms): bound by operations, 64x64x128->64 nearly at par.  The
// last Stage-II layer, 128x128x64->64, is bound by bytes: it reads 134 MB
// and writes 537 MB (0.200 ms) against 137 GFLOP (0.139 ms).
//
// Design (first version: simple and right): the GEMM tiles of igemm.cuh.
// bf16 with 16-byte-aligned channels runs 128x128 WMMA tiles fed by a
// 3-stage cp.async ring; f32 and ragged channels run the simple 128x64 tile,
// which masks Cin, Co and M.  Left for later: one block computing all four
// parities from one staged 3x3 neighbourhood (x is read four times from L2
// now), 64-wide N tiles for the Co = 64 layers (half of each 128-wide MMA
// tile is masked there), wgmma + TMA.

#include "igemm.cuh"

namespace {

using igemm::Common;

struct Upconv : Common {
  const float* scale;
  const float* shift;
  int H, W;

  struct Row {
    int b, m, n;  // b < 0: past the last row
  };

  __device__ Row row(int r) const {
    Row q{-1, 0, 0};
    if (r < M) {
      const int hw = H * W;
      q.b = r / hw;
      const int rem = r - q.b * hw;
      q.m = rem / W;
      q.n = rem - q.m * W;
    }
    return q;
  }

  // the parity (py, px) this block computes: py = group >> 1, px = group & 1
  __device__ long long a_off(const Row& q, int tap, int ci) const {
    const int g = group();
    const int iy = q.m + (g >> 1) + (tap >> 1) - 1;
    const int ix = q.n + (g & 1) + (tap & 1) - 1;
    if (q.b < 0 || iy < 0 || iy >= H || ix < 0 || ix >= W) return -1;
    return ((static_cast<long long>(q.b) * H + iy) * W + ix) * Cin + ci;
  }

  __device__ int w_tap(int tap) const { return group() * 4 + tap; }

  __device__ size_t y_row(int r) const {
    const Row q = row(r);
    const int g = group();
    const size_t oy = 2 * q.m + (g >> 1), ox = 2 * q.n + (g & 1);
    return ((static_cast<size_t>(q.b) * (2 * H) + oy) * (2 * W) + ox) * N;
  }

  __device__ float mul(int co) const { return scale[co]; }
  __device__ float add(int, int co) const { return shift[co]; }
};

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 when launched).
// wc is the combined weight [16][Cin][Co], parity-major ((py*2+px)*4 + a*2+b).
extern "C" int t2i_upconv3x3(const void* x, const void* wc, const void* scale,
                             const void* shift, void* y, int B, int H, int W,
                             int Cin, int Co, int act, int bf16,
                             void* stream) {
  const int vec = bf16 ? 8 : 4;
  Upconv p;
  p.a = x;
  p.w = wc;
  p.y = y;
  p.M = B * H * W;
  p.N = Co;
  p.Cin = Cin;
  p.taps = 4;
  p.act = act;
  p.vec_a = Cin % vec == 0 && igemm::aligned16(x);
  p.vec_w = Co % vec == 0 && igemm::aligned16(wc);
  p.vec_y = Co % vec == 0 && igemm::aligned16(y);
  p.groups = 4;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.H = H;
  p.W = W;
  return static_cast<int>(
      igemm::launch(p, bf16 != 0, static_cast<cudaStream_t>(stream)));
}
