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
// Bound on the H100 SXM, the GAN-CLS 64 px discriminator at B = 192 (three
// streams of 64), bf16: each deep layer (64->128, 128->256, 256->512)
// does 2*M*N*K = 20.1 GFLOP, 0.020 ms at 989 TFLOP/s, against 4-6 MB of
// traffic: bound by tensor-core operations.  down0 (Cin = 3) is bound by its
// bytes: 4.7 MB in and 25 MB out, about 0.009 ms at 3.35 TB/s.
//
// Design (first version: simple and right).  The GEMM tiles are the ones of
// csrc/deconv5x5_s2.cu, shared through igemm.cuh: bf16 with 16-byte-aligned
// channels runs 128x128 WMMA tiles fed by a 3-stage cp.async ring; f32 and
// ragged channels run the simple 128x64 tile.  Cin <= 4 (down0: K = 75, not
// 16-byte aligned) runs a direct kernel: one thread per output pixel and 16
// output channels, the block's 25*Cin x 16 weights in shared memory (read as
// broadcasts), f32 FMA.  Left for later: wgmma + TMA and split-K for the
// 4x4-output layer, whose 96 blocks do not fill the 132 SMs.

#include "igemm.cuh"

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

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 when launched).
// Path, chosen from the shapes: Cin <= 4 -> the direct kernel; bf16 with
// channels that allow 16-byte copies -> the pipelined tile; anything else
// -> the simple tile.
extern "C" int t2i_conv5x5_s2(const void* x, const void* w, const void* b,
                              void* y, int B, int H, int W, int Cin, int Co,
                              int act, int bf16, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin <= D_MAX_CIN) {
    const dim3 grid((p.M + D_THREADS - 1) / D_THREADS, (Co + D_CT - 1) / D_CT);
    if (bf16)
      direct_kernel<true><<<grid, D_THREADS, 0, s>>>(p);
    else
      direct_kernel<false><<<grid, D_THREADS, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(igemm::launch(p, bf16 != 0, s));
}
