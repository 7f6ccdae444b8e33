// Fused 5x5 stride-2 convolution for Hopper (sm_90a): the discriminator's
// down-block.
//
//   y = act(conv_5x5_s2_SAME(x, w) + b)
//
// x NHWC [B,H,W,Cin], w HWIO [5,5,Cin,Co], b f32 [Co], y NHWC
// [B,Ho,Wo,Co] with TF SAME padding (Ho = ceil(H/2); an even map pads 1
// before and 2 after, an odd one 2 and 2); bf16 or f32 in and out, f32
// accumulation and epilogue.
//
// Replaces text_to_image_tpu/ops/pallas/conv.py conv5x5_s2_act, whose
// Pallas bodies are _conv_kernel_vpad (via _conv_pallas_vpad) and its
// HBM-staged twin _conv_kernel (via _conv_pallas).  The TPU kernel pads the
// image (1, 3) in VMEM and reads the taps from a parity view of it.
//
// Decomposition: an implicit GEMM with M = B*Ho*Wo output pixels, N = Co and
// K = 25*Cin, walked tap by tap; output pixel (oy, ox) reads tap (kh, kw) at
// input (2*oy + kh - pad_top, 2*ox + kw - pad_left), and zeros stand outside
// the image, so the padded copy never exists.  Bias and the activation are
// fused in the epilogue.
//
// Bound on the H100 SXM, bf16: each deep layer of the 64 px discriminator at
// B = 192 (64->128, 128->256, 256->512) does 2*M*N*K = 20.1 GFLOP, 0.020 ms
// at 989 TFLOP/s, against 4-6 MB of traffic, and each deep layer of the
// 256 px one 322 GFLOP (0.326 ms): bound by tensor-core operations.  down0
// (Cin = 3) is bound by its bytes: 4.7 MB in and 25 MB out at 64 px (0.009
// ms at 3.35 TB/s), 75 MB and 403 MB at 256 px (0.143 ms).
//
// Paths, chosen from shapes, types and alignment only (conv_path below; the
// wrapper mirrors the rule in Python):
//  * wgmma: bf16 with Cin and Co multiples of 64 -- every deep call.  The
//    kernel of igemm_sm90.cuh: K slices of 64 channels in 128-byte-swizzled
//    shared memory, m64nNk16 warpgroup products, the gather hoisted out of
//    the K loop (a row's base offset and a 25-bit mask of the taps inside
//    the image), the weights [25*Cin][Co] by TMA, the epilogue from the
//    accumulator registers.  The caller picks the tile (128x128, 128x64,
//    64x128, 128x256) and a split of K over whole
//    taps, so that the calls with few output tiles (8x8 and 16x16 maps)
//    still fill 132 SMs; partial sums are reduced in a fixed order.
//  * down0_mma: bf16, Cin <= 4, Co = 64 -- the RGB input (down0.cuh, which
//    the transposed conv's RGB dx shares at N = 64 / 128).  One block makes
//    all 64 channels of a tile of 8x16 output pixels: it stages the 19x35
//    input patch once, builds the im2col tile [128][K padded to 16] in
//    swizzled shared memory and runs K/16 wgmma steps against the weights,
//    which stay resident while the block walks over tiles; the next tile's
//    patch is read into registers while this one is multiplied and stored.
//    x is read once and every 128-byte output row is written whole.
//  * pipelined / tile (igemm.cuh, mma.sync): bf16 with channels that are
//    multiples of 8 but not of 64; f32 and ragged channels.
//  * direct: Cin <= 4 otherwise (f32, or Co != 64): one thread per output
//    pixel and 16 output channels, f32 FMA.

#include "down0.cuh"

namespace {

using igemm::Common;

struct Conv : Common {
  const float* bias;
  int H, W, Ho, Wo, pad_top, pad_left;

  struct Row {
    int b, oy, ox;  // b < 0: past the last row
  };

  __device__ Row row(int r) const {
    Row q{-1, 0, 0};
    if (r < M) {
      const int hw = Ho * Wo;
      q.b = r / hw;
      const int rem = r - q.b * hw;
      q.oy = rem / Wo;
      q.ox = rem - q.oy * Wo;
    }
    return q;
  }

  __device__ long long a_off(const Row& q, int tap, int ci) const {
    const int kh = tap / 5, kw = tap - 5 * (tap / 5);
    const int iy = 2 * q.oy + kh - pad_top, ix = 2 * q.ox + kw - pad_left;
    if (q.b < 0 || iy < 0 || iy >= H || ix < 0 || ix >= W) return -1;
    return ((static_cast<long long>(q.b) * H + iy) * W + ix) * Cin + ci;
  }

  __device__ float add(int, int co) const { return bias[co]; }

  // The gather hoisted for igemm_sm90.cuh: row r's offset of tap (0, 0),
  // which may lie in the padding, and the taps that lie inside the image.
  __device__ igemm90::Gather gather(int r, int) const {
    const Row q = row(r);
    if (q.b < 0) return igemm90::Gather{0, 0, 0u};
    const int iy0 = 2 * q.oy - pad_top, ix0 = 2 * q.ox - pad_left;
    unsigned mw = 0, taps = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (ix0 + k >= 0 && ix0 + k < W) mw |= 1u << k;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (iy0 + k >= 0 && iy0 + k < H) taps |= mw << (5 * k);
    return igemm90::Gather{
        ((static_cast<long long>(q.b) * H + iy0) * W + ix0) * Cin, 0, taps};
  }

  __device__ long long row_off(const igemm90::Gather& g, int) const {
    return g.base;
  }

  __device__ int slices(int) const { return Cin / igemm90::BK; }

  static constexpr bool kOneWeightMatrix = true;   // HWIO is [25*Cin][Co]
  __device__ int w_row(int, int tap) const { return tap * Cin; }

  __device__ long long tap_off(int, int tap) const {
    const int kh = tap / 5, kw = tap - 5 * kh;
    return (static_cast<long long>(kh) * W + kw) * Cin;
  }

  // down0.cuh's launch has one column tile (N = Co = 64): its column
  // offsets fold to constants
  static constexpr bool kOneColumnTile = true;
  // down0.cuh's weights [K][N]: w [25*Cin][Co] as it lies, 16 bytes a
  // chunk of 8 columns
  template <int CIN, int NT, int KP, int THREADS>
  __device__ void stage_weights(uint8_t* b, uint8_t*, int, int tid) const {
    const uint16_t* wp = static_cast<const uint16_t*>(w);
    for (int q = tid; q < KP * (NT / 8); q += THREADS) {
      const int kr = q / (NT / 8), c = q % (NT / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (kr < 25 * CIN)
        v = __ldg(reinterpret_cast<const uint4*>(wp + kr * NT + c * 8));
      *reinterpret_cast<uint4*>(b + down0::b_chunk(kr, c)) = v;
    }
  }
};

// ---------------------------------------------------------------------------
// Cin <= 4 (the RGB input): a GEMM tile would stage K = 25*Cin in 32-deep
// slices that are 90 % zeros, so one thread takes one output pixel and
// D_CT output channels and walks the 25 taps itself.
constexpr int D_THREADS = 256;
constexpr int D_CT = 16;       // output channels per thread (grid.y walks Co)
constexpr int D_MAX_CIN = 4;

template <bool BF16>
__global__ void __launch_bounds__(D_THREADS) direct_kernel(Conv p) {
  using S = typename std::conditional<BF16, uint16_t, float>::type;
  constexpr int VEC = 16 / sizeof(S);
  __shared__ __align__(16) float wsm[25 * D_MAX_CIN][D_CT];
  const int co0 = blockIdx.y * D_CT;
  const S* w = static_cast<const S*>(p.w);
  for (int i = threadIdx.x; i < 25 * p.Cin * D_CT; i += D_THREADS) {
    const int k = i / D_CT, c = i - k * D_CT;
    wsm[k][c] = co0 + c < p.N
                    ? igemm::to_float(w[static_cast<size_t>(k) * p.N + co0 + c])
                    : 0.f;
  }
  __syncthreads();

  const int r = blockIdx.x * D_THREADS + threadIdx.x;
  if (r >= p.M) return;
  const Conv::Row q = p.row(r);
  const S* x = static_cast<const S*>(p.a);

  float acc[D_CT];
#pragma unroll
  for (int c = 0; c < D_CT; ++c) acc[c] = 0.f;
  for (int tap = 0; tap < 25; ++tap) {
    const long long off = p.a_off(q, tap, 0);
    if (off < 0) continue;
    for (int ci = 0; ci < p.Cin; ++ci) {
      const float xe = igemm::to_float(x[off + ci]);
      const float* wr = wsm[tap * p.Cin + ci];
#pragma unroll
      for (int c = 0; c < D_CT; ++c) acc[c] = fmaf(xe, wr[c], acc[c]);
    }
  }
#pragma unroll
  for (int c0 = 0; c0 < D_CT; c0 += VEC) {
    const int co = co0 + c0;
    if (co < p.N)
      igemm::store_out<Conv, BF16>(p, r, co, acc + c0,
                                   p.N - co < VEC ? p.N - co : VEC);
  }
}

enum Path { kTile = 0, kPipelined = 1, kDirect = 2, kWgmma = 3, kDown0Mma = 4 };

// The path a call takes: from shapes, types and alignment only.
int conv_path(const Conv& p, bool bf16) {
  if (p.Cin <= D_MAX_CIN)
    return bf16 && p.N == 64 && p.vec_w && p.vec_y ? kDown0Mma : kDirect;
  if (bf16 && igemm90::applies(p)) return kWgmma;
  return bf16 && p.vec_a && p.vec_w && p.vec_y ? kPipelined : kTile;
}

Conv make_conv(const void* x, const void* w, const void* b, void* y, int B,
               int H, int W, int Cin, int Co, int act, int bf16) {
  const int vec = bf16 ? 8 : 4;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int pad_h = (Ho - 1) * 2 + 5 - H, pad_w = (Wo - 1) * 2 + 5 - W;
  Conv p;
  p.a = x;
  p.w = w;
  p.y = y;
  p.M = B * Ho * Wo;
  p.N = Co;
  p.Cin = Cin;
  p.taps = 25;
  p.act = act;
  p.vec_a = Cin % vec == 0 && igemm::aligned16(x);
  p.vec_w = Co % vec == 0 && igemm::aligned16(w);
  p.vec_y = Co % vec == 0 && igemm::aligned16(y);
  p.bias = static_cast<const float*>(b);
  p.H = H;
  p.W = W;
  p.Ho = Ho;
  p.Wo = Wo;
  p.pad_top = pad_h / 2;
  p.pad_left = pad_w / 2;
  return p;
}

}  // namespace

// The path t2i_conv5x5_s2 takes for these pointers and shapes: 0 the simple
// tile, 1 the pipelined tile, 2 the direct kernel, 3 wgmma, 4 down0 on the
// tensor cores.
extern "C" int t2i_conv5x5_s2_path(const void* x, const void* w, const void* y,
                                   int Cin, int Co, int bf16) {
  return conv_path(make_conv(x, w, nullptr, const_cast<void*>(y), 1, 1, 1, Cin,
                             Co, 0, bf16),
                   bf16 != 0);
}

// Launches on `stream` and returns the CUDA error code (0 when launched).
// `tile` (igemm90::TileId) and `split` are read on the wgmma path only;
// split > 1 needs `ws`, f32 scratch of split*M*Co elements.  No path gives
// way to another: a refused launch is returned.
extern "C" int t2i_conv5x5_s2(const void* x, const void* w, const void* b,
                              void* y, void* ws, int B, int H, int W, int Cin,
                              int Co, int act, int bf16, int tile, int split,
                              void* stream) {
  const Conv p = make_conv(x, w, b, y, B, H, W, Cin, Co, act, bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (conv_path(p, bf16 != 0)) {
    case kWgmma:
      return static_cast<int>(
          igemm90::launch(p, tile, &split, static_cast<float*>(ws), s));
    case kDown0Mma:
      switch (Cin) {
        case 1: return static_cast<int>(down0::launch<1, 64>(p, B, s));
        case 2: return static_cast<int>(down0::launch<2, 64>(p, B, s));
        case 3: return static_cast<int>(down0::launch<3, 64>(p, B, s));
        default: return static_cast<int>(down0::launch<4, 64>(p, B, s));
      }
    case kDirect: {
      const dim3 grid((p.M + D_THREADS - 1) / D_THREADS,
                      (Co + D_CT - 1) / D_CT);
      if (bf16)
        direct_kernel<true><<<grid, D_THREADS, 0, s>>>(p);
      else
        direct_kernel<false><<<grid, D_THREADS, 0, s>>>(p);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(igemm::launch(p, bf16 != 0, s));
  }
}
