// Fused nearest-upsample x2 + 3x3 convolution for Hopper (sm_90a): the
// StackGAN / PGGAN generator up-block.
//
//   y = act(conv_3x3_SAME(upsample2_nearest(x), w) * scale + shift)
//
// x NHWC [B,H,W,Cin], y NHWC [B,2H,2W,Co], scale and shift f32 [Co]; bf16 or
// f32 in and out, f32 accumulation and epilogue.  The kernel does not read w
// but the combined weights wc [2,2,2,2,Cin,Co] = [py,px,a,b,Cin,Co], which
// combine_kernel below builds from w in one launch, in w's type (the sums
// rounded as ops/kernels/conv.py combine_upconv_weights rounds them):
// nearest upsampling repeats every input pixel, so per spatial dim the three
// taps over the upsampled map fall on two input pixels,
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
// row-tile size picked from a memory budget.
//
// Decomposition: four implicit GEMMs, one per output parity, each with
// M = B*H*W input-resolution pixels, N = Co and K = 4*Cin walked tap by tap;
// row (b, m, n) of parity (py, px) gathers tap (a, b) at input pixel
// (m+py+a-1, n+px+b-1), zeros outside the image, and the epilogue stores its
// Co outputs at output pixel (2m+py, 2n+px) of the interleaved NHWC map.
// One launch runs all four as groups; the parity is the fastest part of the
// block index, so the four blocks that gather the same input tile run
// together and find it in L2.
//
// Bound on the H100 SXM, bf16, B = 64: operations 2*16*B*H*W*Cin*Co at
// 989 TFLOP/s against bytes x + wc + y at 3.35 TB/s.  Every Stage-I layer
// does 17.2 GFLOP (0.017 ms) against 17-51 MB (0.005-0.015 ms) and the
// first three Stage-II layers 68.7 GFLOP (0.069 ms) against 55-202 MB
// (0.016-0.060 ms): bound by operations, 64x64x128->64 nearly at par.  The
// last Stage-II layer, 128x128x64->64, is bound by bytes: it reads 134 MB
// and writes 537 MB (0.200 ms) against 137 GFLOP (0.139 ms).
//
// Paths, chosen from shapes, types and alignment only (upconv_path below;
// the wrapper mirrors the rule in Python):
//  * wgmma: bf16 with Cin and Co multiples of 64 -- all eight StackGAN
//    calls.  The grouped GEMM of igemm_sm90.cuh (wc [16*Cin][Co] by TMA,
//    w_row(g, t) = (4g + t)*Cin; the gather's base and tap mask depend on
//    the parity; on power-of-two maps A comes by TMA too, tap (a, b) of
//    parity (py, px) one box of x shifted by (py+a-1, px+b-1)).  The first
//    version ran igemm.cuh's mma.sync 128x128 tile at 55-138 TFLOP/s, half
//    of it masked where Co = 64.  The caller's plan (upconv_plan in
//    ops/kernels/conv.py) picks the tile -- 128x64 where Co = 64 -- and,
//    for K of at most 4 slices (128^2x64->64), the resident kernel: two
//    blocks per SM keep their parity's weights in shared memory and stream
//    many row tiles through one ring.  A split of K is a candidate too; on
//    the H100 no main-path call is faster with one.
//  * co32 (upconv_co32.cuh): bf16 with Cin 64 and Co a multiple of 32 but
//    not of 64 on maps of 128-pixel row segments (W % 128 == 0) -- C-PGGAN
//    256 px's 128^2x64->32 up-block: a block keeps its 32-channel column of
//    wc resident, walks consecutive rows of a segment with one staged row
//    of x loaded a tile, reads the 16 products' taps by shifted descriptor
//    starts, and stores whole output rows by TMA.
//  * pipelined / tile (igemm.cuh, mma.sync / f32 FMA): bf16 with channels
//    that are multiples of 8 on the other shapes; f32 and ragged channels
//    (the simple tile masks Cin, Co and M, so it takes every shape).
// The epilogue runs in f32 and stores each output once.

#include "igemm_sm90.cuh"
#include "upconv_co32.cuh"

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

  __device__ size_t y_row(int r) const { return y_row(r, group()); }
  __device__ size_t y_row(int r, int g) const {
    const Row q = row(r);
    const size_t oy = 2 * q.m + (g >> 1), ox = 2 * q.n + (g & 1);
    return ((static_cast<size_t>(q.b) * (2 * H) + oy) * (2 * W) + ox) * N;
  }

  __device__ float mul(int co) const { return scale[co]; }
  __device__ float add(int, int co) const { return shift[co]; }

  // igemm_sm90.cuh: group g's row r gathers tap (a, b) = (t >> 1, t & 1) at
  // input pixel (m+py-1+a, n+px-1+b); the base is (m+py-1, n+px-1)
  __host__ __device__ long long weight_rows() const {   // wc as [16*Cin][Co]
    return 16LL * Cin;
  }
  __device__ igemm90::Gather gather(int r, int g) const {
    const Row q = row(r);
    if (q.b < 0) return igemm90::Gather{0, 0, 0u};
    const int iy0 = q.m + (g >> 1) - 1, ix0 = q.n + (g & 1) - 1;
    unsigned taps = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int iy = iy0 + (t >> 1), ix = ix0 + (t & 1);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) taps |= 1u << t;
    }
    return igemm90::Gather{
        ((static_cast<long long>(q.b) * H + iy0) * W + ix0) * Cin, 0, taps};
  }
  __device__ long long row_off(const igemm90::Gather& q, int) const {
    return q.base;
  }
  __device__ long long tap_off(int, int tap) const {
    return (static_cast<long long>(tap >> 1) * W + (tap & 1)) * Cin;
  }
  __device__ int slices(int) const { return Cin / igemm90::BK; }
  static constexpr bool kOneWeightMatrix = true;
  __device__ int w_row(int g, int tap) const { return (4 * g + tap) * Cin; }

  // A by TMA where row tiles are whole image rows: tap (a, b) of parity
  // (py, px) is the tile's box shifted by (py+a-1, px+b-1)
  static constexpr bool kGrouped = true;
  static constexpr bool kImageA = true;
  bool a_boxes(int bm) const { return igemm90::image_boxes(H, W, bm); }
  cudaError_t a_map(CUtensorMap* map, int bm) const {
    return igemm90::make_image_map(map, a, M / (H * W), H, W, Cin, bm);
  }
  __device__ int3 a_box(int row0, int g, int tap) const {
    return igemm90::image_box(row0, H, W, (g >> 1) + (tap >> 1) - 1,
                              (g & 1) + (tap & 1) - 1);
  }
};

// wc[py,px,a,b,ci,co] from w[kh,kw,ci,co] (the table at the top), in w's
// type: the kh sums first, then the kw sums, each rounded to S as torch
// rounds a sum of two tensors of that type.  One thread per (ci, co).
template <class S>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<S, uint16_t>::value)
    return __bfloat162float(__float2bfloat16(v));
  else
    return v;
}

template <class S>
__global__ void __launch_bounds__(256)
    combine_kernel(const S* w, S* wc, long long cico) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= cico) return;
  float v[3][3];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      v[kh][kw] = igemm::to_float(w[(kh * 3 + kw) * cico + i]);
  float rows[2][2][3];   // [py][a][kw]
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    rows[0][0][kw] = v[0][kw];
    rows[0][1][kw] = round_to<S>(v[1][kw] + v[2][kw]);
    rows[1][0][kw] = round_to<S>(v[0][kw] + v[1][kw]);
    rows[1][1][kw] = v[2][kw];
  }
#pragma unroll
  for (int py = 0; py < 2; ++py)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float* r = rows[py][a];
      const float c[2][2] = {{r[0], round_to<S>(r[1] + r[2])},
                             {round_to<S>(r[0] + r[1]), r[2]}};   // [px][b]
#pragma unroll
      for (int px = 0; px < 2; ++px)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          S* out = wc + ((((py * 2 + px) * 2 + a) * 2 + b) * cico + i);
          if constexpr (std::is_same<S, uint16_t>::value)
            *out = __bfloat16_as_ushort(__float2bfloat16(c[px][b]));
          else
            *out = c[px][b];
        }
    }
}

enum Path { kTile = 0, kPipelined = 1, kWgmma = 2, kCo32 = 3 };

Upconv make_upconv(const void* x, const void* wc, const void* scale,
                   const void* shift, void* y, int B, int H, int W, int Cin,
                   int Co, int act, int bf16) {
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
  return p;
}

// The path a call takes: from shapes, types and alignment only.
int upconv_path(const Upconv& p, bool bf16) {
  if (bf16 && igemm90::applies(p)) return kWgmma;
  const bool vec = p.vec_a && p.vec_w && p.vec_y;
  if (bf16 && vec && up32::applies(p.Cin, p.N, p.W)) return kCo32;
  return bf16 && vec ? kPipelined : kTile;
}

}  // namespace

// Builds wc [16][Cin][Co] from w [3][3][Cin][Co] (both bf16 or both f32)
// on `stream`; returns the CUDA error code.
extern "C" int t2i_upconv3x3_combine(const void* w, void* wc, int Cin, int Co,
                                     int bf16, void* stream) {
  const long long cico = static_cast<long long>(Cin) * Co;
  const unsigned blocks = static_cast<unsigned>((cico + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    combine_kernel<uint16_t><<<blocks, 256, 0, s>>>(
        static_cast<const uint16_t*>(w), static_cast<uint16_t*>(wc), cico);
  else
    combine_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(w), static_cast<float*>(wc), cico);
  return static_cast<int>(cudaGetLastError());
}

// The path t2i_upconv3x3 takes for these pointers and shapes (x's width W):
// 0 the simple tile, 1 the pipelined tile, 2 wgmma, 3 co32.
extern "C" int t2i_upconv3x3_path(const void* x, const void* wc, const void* y,
                                  int W, int Cin, int Co, int bf16) {
  return upconv_path(make_upconv(x, wc, nullptr, nullptr, const_cast<void*>(y),
                                 1, 1, W, Cin, Co, 0, bf16),
                     bf16 != 0);
}

// Launches on `stream` and returns the CUDA error code (0 when launched).
// wc is the combined weight [16][Cin][Co], parity-major ((py*2+px)*4 + a*2+b).
// `tile` (igemm90::TileId, kResident128x64 included) and the parts of K of
// parities 0-3 (p0..p3, whole taps each) are read on the wgmma path; a
// part count above 1 needs `ws`, f32 scratch of one B*H*W x Co plane per
// part of every split parity.  No path gives way to another.
extern "C" int t2i_upconv3x3(const void* x, const void* wc, const void* scale,
                             const void* shift, void* y, void* ws, int B,
                             int H, int W, int Cin, int Co, int act, int bf16,
                             int tile, int p0, int p1, int p2, int p3,
                             void* stream) {
  const Upconv p =
      make_upconv(x, wc, scale, shift, y, B, H, W, Cin, Co, act, bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int path = upconv_path(p, bf16 != 0);
  if (path == kCo32)
    return static_cast<int>(up32::launch(x, wc, p.scale, p.shift, y, B, H,
                                         W, Cin, Co, act, s));
  if (path == kWgmma) {
    const int parts[4] = {p0, p1, p2, p3};
    return static_cast<int>(
        igemm90::launch(p, tile, parts, static_cast<float*>(ws), s));
  }
  return static_cast<int>(igemm::launch(p, bf16 != 0, s));
}
