// Fused 5x5 stride-2 transposed convolution for Hopper (sm_90a).
//
//   y = act(conv_transpose_5x5_s2_SAME(x, w) * scale + shift)
//
// with lax.conv_transpose semantics (the kernel is not flipped), x NHWC
// [B,H,W,Cin], w HWIO [5,5,Cin,Co], scale/shift f32 [Co], y NHWC
// [B,2H,2W,Co]; bf16 or f32 in and out, f32 accumulation and epilogue.
//
// Replaces text_to_image_tpu/ops/pallas/conv.py deconv5x5_s2, whose Pallas
// bodies are _deconv_kernel_vpad (via _deconv_pallas_vpad) and its
// HBM-staged twin _deconv_kernel (via _deconv_pallas).  What those bodies
// do for the TPU is not carried over: the (1, 2)-padded copy of x in fast
// memory and the sequential walk of the grid over the parity planes.
//
// Decomposition (the TPU kernel's tap table, conv.py _DECONV_TAPS): per
// spatial dim, output parity p in {0,1} sums taps t = 0 .. 1+p that read
// input index m + t - 1 through kernel index k = 2t + 1 - p:
//   O[2m]   = X[m-1] W1 + X[m] W3
//   O[2m+1] = X[m-1] W0 + X[m] W2 + X[m+1] W4
// So each of the four output-parity planes is a GEMM with M = B*H*W rows,
// N = Co and K = (2+py)(2+px)*Cin, whose A rows are gathered from x at a
// per-tap offset.  Reads outside the image are zeros: the (1,2)-padded copy
// of x never exists in memory.
//
// Bound on the H100 SXM: the generator's three deep layers (B=64, bf16) do
// 2*25*B*H*W*Cin*Co = 26.8 GFLOP each, 27 us at 989 TFLOP/s, against about
// 30 MB of traffic (9 us at 3.35 TB/s): bound by tensor-core operations.
// The RGB layer (Co=3, tanh) is bound by its bytes (18.4 MB, 5.5 us).
//
// Paths, chosen from shapes, types and alignment only (deconv_path below;
// the wrapper mirrors the rule in Python):
//  * wgmma: bf16 with Cin and Co multiples of 64 -- the three deep layers.
//    The four parities are the groups of one grouped GEMM on the main loop
//    of igemm_sm90.cuh (Deconv below): K slices of 64 channels in
//    128-byte-swizzled shared memory, m64nNk16 warpgroup products, the
//    gather hoisted out of the K loop (a row's offset of input pixel
//    (m-1, n-1) and a mask of the taps inside the image) or, on
//    power-of-two maps, A by TMA (tap (th, tw) one box of x shifted by
//    (th-1, tw-1)), the weights [25*Cin][Co] by TMA, each tap's rows
//    picked by the tap table.  What
//    held the first version (mma.sync from padded shared memory, one fixed
//    128x128 tile, K never split) back was the first layer: 64x4^2x1024 ->
//    512 gives 128 blocks of 4-9 taps for 132 SMs, so the 9-tap blocks ran
//    on a quarter of the card.  Now the caller's plan (deconv_plan in
//    ops/kernels/conv.py) picks the tile and splits each parity's K over
//    whole taps in its own number of parts, so that the blocks even out;
//    partial sums are reduced in a fixed order (the same bits every run).
//  * thin: Co <= 4 with Cin a multiple of 16 up to 512, bf16, 16-byte-
//    aligned x, w and y (the RGB layer; the conv's first-layer dx): one
//    GEMM per input pixel of its 3x3 neighbourhood against the four
//    parities' weights, m64n16k16 on wgmma from one staged patch of x a K
//    slice (thin:: below).
//  * direct: Co <= 4 otherwise (f32, ragged Cin): one thread per input
//    pixel and its 2x2 outputs, f32 FMA, all weights in shared memory.
//  * pipelined: bf16 with channels that are multiples of 8 otherwise: the
//    first version's 128x128 mma.sync tile in a 3-stage cp.async ring.
//  * tile: f32 and ragged channels: 128x64 tiles, K slices of 32 through
//    registers, WMMA (bf16) or an 8x4 FMA register tile (f32); it masks
//    Cin, Co and the image edges, so it takes every shape.
// The epilogue act(acc*scale + shift) runs in f32 and each output is stored
// once, straight into the interleaved NHWC image.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "igemm_sm90.cuh"

namespace {

constexpr int BM = 128;      // GEMM rows (output pixels of one parity) per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K slice staged per step
constexpr int PAD = 8;       // shared-memory row padding (elements)
constexpr int THREADS = 256;

enum Act { kNone = 0, kRelu = 1, kLrelu = 2, kTanh = 3 };

struct Params {
  const void* x;
  const void* w;
  const float* scale;
  const float* shift;
  void* y;
  int B, H, W, Cin, Co, act;
  int vec_x, vec_w, vec_y;  // 16-byte accesses are legal for x / w / y
};

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kLrelu: return v >= 0.f ? v : 0.2f * v;
    case kTanh: return tanhf(v);
    default: return v;
  }
}

// Offset of output pixel (b, 2m+py, 2n+px, 0) for GEMM row r of a parity.
__device__ __forceinline__ size_t out_base(const Params& p, int r, int py,
                                           int px) {
  const int hw = p.H * p.W;
  const int b = r / hw;
  const int rem = r - b * hw;
  const int m = rem / p.W;
  const int n = rem - m * p.W;
  return ((static_cast<size_t>(b) * 2 * p.H + 2 * m + py) * 2 * p.W + 2 * n +
          px) * static_cast<size_t>(p.Co);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) deconv5x5_s2_kernel(Params p) {
  // bf16 values travel as their raw 16 bits until the MMA reads them
  using S = typename std::conditional<BF16, uint16_t, float>::type;
  constexpr int VEC = 16 / sizeof(S);                 // elements per uint4
  constexpr int A_VPR = BK / VEC;                     // uint4s per A row
  constexpr int B_VPR = BN / VEC;                     // uint4s per B row
  constexpr int A_LOADS = BM * A_VPR / THREADS;
  constexpr int B_LOADS = BK * B_VPR / THREADS;
  union Vec {
    uint4 u;
    S e[VEC];
  };

  __shared__ __align__(128) S As[BM][BK + PAD];
  __shared__ __align__(128) S Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int py = blockIdx.z >> 1, px = blockIdx.z & 1;
  const int row0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  const int hw = p.H * p.W, M = p.B * hw;
  const S* x = static_cast<const S*>(p.x);
  const S* w = static_cast<const S*>(p.w);

  // The A rows this thread gathers, decoded once: b < 0 marks a row past M.
  int a_b[A_LOADS], a_m[A_LOADS], a_n[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int r = row0 + (tid + i * THREADS) / A_VPR;
    a_b[i] = r < M ? r / hw : -1;
    const int rem = r - a_b[i] * hw;
    a_m[i] = rem / p.W;
    a_n[i] = rem - a_m[i] * p.W;
  }

  const int ntw = 2 + px;                    // taps along W for this parity
  const int nk = (p.Cin + BK - 1) / BK;      // K slices per tap
  const int n_iter = (2 + py) * ntw * nk;

  uint4 a_reg[A_LOADS], b_reg[B_LOADS];
  auto load_slice = [&](int it) {
    const int tap = it / nk;
    const int ci0 = (it - tap * nk) * BK;
    const int th = tap / ntw, tw = tap - th * ntw;
    const int kh = 2 * th + 1 - py, kw = 2 * tw + 1 - px;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int ci = ci0 + ((tid + i * THREADS) % A_VPR) * VEC;
      const int iy = a_m[i] + th - 1, ix = a_n[i] + tw - 1;
      Vec v;
      v.u = make_uint4(0, 0, 0, 0);
      if (a_b[i] >= 0 && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W &&
          ci < p.Cin) {
        const S* src =
            x + ((static_cast<size_t>(a_b[i]) * p.H + iy) * p.W + ix) *
                    static_cast<size_t>(p.Cin) + ci;
        if (p.vec_x) {
          v.u = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v.e[e] = ci + e < p.Cin ? src[e] : S(0);
        }
      }
      a_reg[i] = v.u;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int ci = ci0 + idx / B_VPR;
      const int co = co0 + (idx % B_VPR) * VEC;
      Vec v;
      v.u = make_uint4(0, 0, 0, 0);
      if (ci < p.Cin && co < p.Co) {
        const S* src = w + (static_cast<size_t>(kh * 5 + kw) * p.Cin + ci) *
                               static_cast<size_t>(p.Co) + co;
        if (p.vec_w) {
          v.u = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v.e[e] = co + e < p.Co ? src[e] : S(0);
        }
      }
      b_reg[i] = v.u;
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp >> 1, wn = warp & 1;   // bf16: 4x2 warps of 32x32
  const int ty = tid / 16, tx = tid % 16;    // f32: 16x16 threads of 8x4
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_mma[2][2];
  float acc_fma[8][4];
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc_mma[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_fma[i][j] = 0.f;
  }

  load_slice(0);
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&As[idx / A_VPR][(idx % A_VPR) * VEC]) =
          a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&Bs[idx / B_VPR][(idx % B_VPR) * VEC]) =
          b_reg[i];
    }
    __syncthreads();
    if (it + 1 < n_iter) load_slice(it + 1);

    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i],
              reinterpret_cast<const __nv_bfloat16*>(&As[wm * 32 + i * 16][kk]),
              BK + PAD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j],
              reinterpret_cast<const __nv_bfloat16*>(&Bs[kk][wn * 32 + j * 16]),
              BN + PAD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc_mma[i][j], fa[i], fb[j], acc_mma[i][j]);
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[ty * 8 + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_fma[i][j] = fmaf(a[i], b[j], acc_fma[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: act(acc * scale + shift) in f32, one store per output.
  if constexpr (BF16) {
    // Each warp stages one 16x16 accumulator at a time through its own
    // 1 KB of the (now idle) A tile; lane l then owns row l/2, 8 columns.
    float* stage = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
    const int rr = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(stage, acc_mma[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = row0 + wm * 32 + i * 16 + rr;
        const int co = co0 + wn * 32 + j * 16 + cc;
        if (r < M && co < p.Co) {
          const size_t base = out_base(p, r, py, px);
          union {
            uint4 u;
            uint16_t e[8];
          } o;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = co + e < p.Co ? co + e : co;
            const float v = apply_act(
                stage[rr * 16 + cc + e] * p.scale[c] + p.shift[c], p.act);
            o.e[e] = __bfloat16_as_ushort(__float2bfloat16(v));
          }
          if (p.vec_y) {
            *reinterpret_cast<uint4*>(y + base + co) = o.u;
          } else {
            for (int e = 0; e < 8 && co + e < p.Co; ++e)
              y[base + co + e] = __ushort_as_bfloat16(o.e[e]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    float* y = static_cast<float*>(p.y);
    const int co = co0 + tx * 4;
    if (co < p.Co) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + ty * 8 + i;
        if (r >= M) break;
        const size_t base = out_base(p, r, py, px);
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = co + j < p.Co ? co + j : co;
          o[j] = apply_act(acc_fma[i][j] * p.scale[c] + p.shift[c], p.act);
        }
        if (p.vec_y) {
          *reinterpret_cast<float4*>(y + base + co) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
          for (int j = 0; j < 4 && co + j < p.Co; ++j) y[base + co + j] = o[j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 with 16-byte-aligned channels (every deep generator layer): 128x128
// tiles, 8 warps of 64x32, K slices copied global -> shared with cp.async
// (zero-filled where the tap leaves the image) in a 3-stage ring.
constexpr int P_BM = 128, P_BN = 128, P_BK = 32, P_STAGES = 3;
constexpr int P_LDA = P_BK + PAD;            // 80-byte rows: ldmatrix conflict-free
constexpr int P_LDB = P_BN + PAD;            // 272-byte rows
constexpr int P_A_STAGE = P_BM * P_LDA;      // elements per stage
constexpr int P_B_STAGE = P_BK * P_LDB;
constexpr int P_SMEM = P_STAGES * (P_A_STAGE + P_B_STAGE) * 2;  // 56,832 bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__global__ void __launch_bounds__(THREADS)
    deconv5x5_s2_pipelined_kernel(Params p) {
  constexpr int B_STAGE = P_B_STAGE, LDB = P_LDB;
  constexpr int B_CPR = P_BN / 8;                // 16-byte chunks per B row
  constexpr int B_LOADS = P_BK * B_CPR / THREADS;
  constexpr int WARPS_N = P_BN / 32;             // 2 x 4 warps of 64 x 32
  constexpr int FM = 4;                          // 16-row fragments per warp
  extern __shared__ __align__(128) uint16_t smem[];
  uint16_t* As = smem;                           // [STAGES][BM][LDA]
  uint16_t* Bs = smem + P_STAGES * P_A_STAGE;    // [STAGES][BK][LDB]

  const int tid = threadIdx.x;
  const int py = blockIdx.z >> 1, px = blockIdx.z & 1;
  const int row0 = blockIdx.x * P_BM, co0 = blockIdx.y * P_BN;
  const int hw = p.H * p.W, M = p.B * hw;
  const uint16_t* x = static_cast<const uint16_t*>(p.x);
  const uint16_t* w = static_cast<const uint16_t*>(p.w);

  // A tile: 128 rows x 4 chunks of 8 channels; B tile: 32 x 16 chunks.
  // Each thread copies 2 of each; its A rows are decoded once.
  int a_b[2], a_m[2], a_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ((tid + i * THREADS) >> 2);
    a_b[i] = r < M ? r / hw : -1;
    const int rem = r - a_b[i] * hw;
    a_m[i] = rem / p.W;
    a_n[i] = rem - a_m[i] * p.W;
  }
  const int ntw = 2 + px;
  const int nk = (p.Cin + P_BK - 1) / P_BK;
  const int n_iter = (2 + py) * ntw * nk;

  auto issue = [&](int it, int stage) {
    const int tap = it / nk;
    const int ci0 = (it - tap * nk) * P_BK;
    const int th = tap / ntw, tw = tap - th * ntw;
    const int kh = 2 * th + 1 - py, kw = 2 * tw + 1 - px;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 2, c8 = (idx & 3) * 8, ci = ci0 + c8;
      const int iy = a_m[i] + th - 1, ix = a_n[i] + tw - 1;
      const bool valid = a_b[i] >= 0 && iy >= 0 && iy < p.H && ix >= 0 &&
                         ix < p.W && ci < p.Cin;
      const uint16_t* src =
          valid ? x + ((static_cast<size_t>(a_b[i]) * p.H + iy) * p.W + ix) *
                          static_cast<size_t>(p.Cin) + ci
                : x;
      cp_async16(As + stage * P_A_STAGE + row * P_LDA + c8, src, valid);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kr = idx / B_CPR, c8 = (idx % B_CPR) * 8;
      const int ci = ci0 + kr, co = co0 + c8;
      const bool valid = ci < p.Cin && co < p.Co;
      const uint16_t* src =
          valid ? w + (static_cast<size_t>(kh * 5 + kw) * p.Cin + ci) *
                          static_cast<size_t>(p.Co) + co
                : w;
      cp_async16(Bs + stage * B_STAGE + kr * LDB + c8, src, valid);
    }
  };

  using namespace nvcuda;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < P_STAGES - 1; ++s) {
    if (s < n_iter) issue(s, s);
    asm volatile("cp.async.commit_group;\n");
  }
  for (int it = 0; it < n_iter; ++it) {
    // slice `it` has landed; every warp is done with the stage refilled next
    asm volatile("cp.async.wait_group %0;\n" ::"n"(P_STAGES - 2));
    __syncthreads();
    const int nxt = it + P_STAGES - 1;
    if (nxt < n_iter) issue(nxt, nxt % P_STAGES);
    asm volatile("cp.async.commit_group;\n");

    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(
        As + (it % P_STAGES) * P_A_STAGE);
    const __nv_bfloat16* b_s = reinterpret_cast<const __nv_bfloat16*>(
        Bs + (it % P_STAGES) * B_STAGE);
#pragma unroll
    for (int kk = 0; kk < P_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            fa[i], a_s + (wm * FM * 16 + i * 16) * P_LDA + kk, P_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_s + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_all;\n");
  __syncthreads();

  // Epilogue as in the tile kernel: each warp stages one 16x16 accumulator
  // at a time through 1 KB of the idle ring; lane l owns row l/2, 8 columns
  // (Co % 8 == 0 on this path, so each lane stores 16 bytes).
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  const int rr = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = row0 + wm * FM * 16 + i * 16 + rr;
      const int co = co0 + wn * 32 + j * 16 + cc;
      if (r < M && co < p.Co) {
        union {
          uint4 u;
          uint16_t e[8];
        } o;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = apply_act(
              stage[rr * 16 + cc + e] * p.scale[co + e] + p.shift[co + e],
              p.act);
          o.e[e] = __bfloat16_as_ushort(__float2bfloat16(v));
        }
        *reinterpret_cast<uint4*>(y + out_base(p, r, py, px) + co) = o.u;
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Narrow Co in f32 or with ragged Cin (the thin path below takes the bf16
// RGB layer): one thread takes one input pixel and computes the 2x2 output
// pixels it feeds (its 3x3 neighbourhood through the 25 taps), in f32 FMA.
// All 25*Cin weight rows sit in shared memory as float4 (Co padded to 4),
// read as warp-wide broadcasts.
constexpr int D_THREADS = 256;
constexpr int D_MAX_SMEM = 200 * 1024;

__device__ __forceinline__ float to_float(uint16_t bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ float to_float(float v) { return v; }

template <bool BF16, int CO>
__global__ void __launch_bounds__(D_THREADS)
    deconv5x5_s2_direct_kernel(Params p) {
  using S = typename std::conditional<BF16, uint16_t, float>::type;
  constexpr int VEC = 16 / sizeof(S);
  extern __shared__ float4 wsm[];              // [25 * Cin], one per (tap, ci)
  const S* w = static_cast<const S*>(p.w);
  for (int i = threadIdx.x; i < 25 * p.Cin; i += D_THREADS) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < CO; ++c) v[c] = to_float(w[static_cast<size_t>(i) * CO + c]);
    wsm[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  const int hw = p.H * p.W;
  const int r = blockIdx.x * D_THREADS + threadIdx.x;
  if (r >= p.B * hw) return;
  const int b = r / hw, rem = r - b * hw, m = rem / p.W, n = rem - m * p.W;
  const S* x = static_cast<const S*>(p.x);

  float acc[4][CO];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[q][c] = 0.f;

#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int iy = m + dy;
    if (iy < 0 || iy >= p.H) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int ix = n + dx;
      if (ix < 0 || ix >= p.W) continue;
      const S* xp = x + ((static_cast<size_t>(b) * p.H + iy) * p.W + ix) *
                            static_cast<size_t>(p.Cin);
      for (int ci0 = 0; ci0 < p.Cin; ci0 += VEC) {
        union {
          uint4 u;
          S e[VEC];
        } xv;
        if (p.vec_x) {
          xv.u = __ldg(reinterpret_cast<const uint4*>(xp + ci0));
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            xv.e[e] = ci0 + e < p.Cin ? xp[ci0 + e] : S(0);
        }
        const int ne = p.Cin - ci0 < VEC ? p.Cin - ci0 : VEC;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int qy = q >> 1, qx = q & 1;
          // parity 0 reads offsets {-1, 0} through k = 2d+3; parity 1
          // reads {-1, 0, 1} through k = 2d+2
          if ((qy == 0 && dy > 0) || (qx == 0 && dx > 0)) continue;
          const int kh = qy ? 2 * dy + 2 : 2 * dy + 3;
          const int kw = qx ? 2 * dx + 2 : 2 * dx + 3;
          const float4* wr = wsm + (kh * 5 + kw) * p.Cin + ci0;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if (e < ne) {
              const float xe = to_float(xv.e[e]);
              const float4 wv = wr[e];
              const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int c = 0; c < CO; ++c) acc[q][c] = fmaf(xe, wc[c], acc[q][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t base = ((static_cast<size_t>(b) * 2 * p.H + 2 * m + (q >> 1)) *
                             2 * p.W + 2 * n + (q & 1)) * CO;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const float v = apply_act(acc[q][c] * p.scale[c] + p.shift[c], p.act);
      if constexpr (BF16)
        static_cast<__nv_bfloat16*>(p.y)[base + c] = __float2bfloat16(v);
      else
        static_cast<float*>(p.y)[base + c] = v;
    }
  }
}

template <bool BF16, int CO>
cudaError_t launch_direct(const Params& p, cudaStream_t s) {
  const int smem = 25 * p.Cin * static_cast<int>(sizeof(float4));
  cudaError_t err = cudaFuncSetAttribute(
      deconv5x5_s2_direct_kernel<BF16, CO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long M = static_cast<long long>(p.B) * p.H * p.W;
  deconv5x5_s2_direct_kernel<BF16, CO>
      <<<static_cast<unsigned>((M + D_THREADS - 1) / D_THREADS), D_THREADS,
         smem, s>>>(p);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_direct_co(const Params& p, cudaStream_t s) {
  switch (p.Co) {
    case 1: return launch_direct<BF16, 1>(p, s);
    case 2: return launch_direct<BF16, 2>(p, s);
    case 3: return launch_direct<BF16, 3>(p, s);
    default: return launch_direct<BF16, 4>(p, s);
  }
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// ---------------------------------------------------------------------------
// thin: Co <= 4 on the tensor cores (bf16, Cin a multiple of 16 up to 512,
// 16-byte-aligned x, w and y: the RGB layer and the conv's first-layer dx),
// in place of the direct kernel's f32 FMA.  Bound by the bytes of x (the
// RGB layer: 16.8 MB in, 1.6 MB out, 5.5 us at 3.35 TB/s; its 2*25*Cin*Co
// operations a pixel are nothing to the tensor cores), so the design reads
// x once from HBM and once into shared memory, with little over:
//  * one GEMM per input pixel (m, n): its 3x3 neighbourhood x Cin against
//    a [9*Cin x 16] matrix whose 16 columns are the 4 output parities x 4
//    channels (channels past Co zero), with zeros where a parity does not
//    read a neighbour (parity 0 reads offsets {-1, 0} through taps 3 + 2d,
//    parity 1 reads {-1, 0, 1} through taps 2 + 2d): m64n16k16, the extra
//    products free at this intensity.  That matrix is built in shared
//    memory by each block from w (no torch-side copy).
//  * A tile is TR image rows x TW pixels.  Its input, with a one-pixel
//    halo, is one TMA box of x a K slice: (TR+2) rows of PW = TW + 2
//    pixels, zero-filled past every edge.  The GEMM's rows are the patch's
//    pixels in order (the halo columns among them, computed and dropped),
//    so the A operand of neighbour (dy, dx) is the same patch from a start
//    dy*PW + dx rows on: nine descriptor starts, no nine boxes (the
//    swizzle follows the address bits in TMA and wgmma alike, so any row
//    may start a descriptor).  L2 -> SM bytes (TR+2)*PW / (TR*TW) of x.
//  * A producer warp keeps the patches coming; blocks are persistent (the
//    weights are built once a block) and walk tiles, two warpgroups taking
//    alternate ones, each through its own ring of patches, so that one's
//    epilogue runs beside the other's products.
//  * The epilogue act(acc*scale + shift) in f32, the tile's 2TR x 2TW x Co
//    outputs staged in shared memory and stored coalesced, row by row.
// On the H100 one warpgroup ran it at 4-8x its bytes bound, held not by
// the loads (a copy of the patches alone runs near the memory rate) but by
// the products and the epilogue after them (PERF.md).
namespace thin {

constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int THREADS = CONSUMERS + 32;       // + the producer warp
constexpr int SMEM_CAP = 227 * 1024;
constexpr int MAX_STAGES = 8;

struct P {
  const uint16_t* w;
  const float* scale;
  const float* shift;
  uint16_t* y;
  int B, H, W, Cin, Co, act;
  int tr, tw, pw, nb;      // a tile: rows, pixels, patch row, m64 blocks
  int slices, ntw, nth, tiles;
  int stages;              // patches in flight, half a warpgroup
  int patch_bytes;         // one stage (a patch and its slack rows)
  int box_bytes;           // what one TMA box brings
  int w_bytes;             // the built weights
};

// byte offset `a` (from an atom-aligned base) in the RB-byte swizzle
template <int RB>
__device__ __forceinline__ uint32_t swizzled(uint32_t a) {
  constexpr uint32_t mask = RB / 16 - 1;
  return a ^ (((a >> 7) & mask) << 4);
}

// K-major descriptor of rows of RB bytes in the RB-byte swizzle (layout
// type 1, 2, 3 for 128, 64, 32; 8-row groups 8*RB bytes apart)
template <int RB>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t type = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  return (igemm90::make_desc(addr, 16, 8 * RB) & ~(3ull << 62)) |
         (type << 62);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// D[64 x 16] += A[64 x 16] * B[16 x 16], both K-major
__device__ __forceinline__ void mma16(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <int BK, int NB>
__global__ void __launch_bounds__(THREADS)
    thin_kernel(const P p, const __grid_constant__ CUtensorMap xmap) {
  constexpr int RB = BK * 2, W_BLOCK = 16 * RB;   // 16 columns x a slice
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[MAX_STAGES];
  __shared__ __align__(8) unsigned long long empty[MAX_STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t wts = base;                            // [9][slices][16][RB]
  const uint32_t ring = wts + ((p.w_bytes + 1023) & ~1023);
  const int tid = threadIdx.x, wg = tid >> 7, tid128 = tid & 127;
  const int half = p.stages / 2;   // each warpgroup's ring of patches
  const int ow = 2 * p.tw * p.Co;   // a staged output row
  uint16_t* out = reinterpret_cast<uint16_t*>(
                      smem_raw + (ring - raw) + p.stages * p.patch_bytes) +
                  wg * 2 * p.tr * ow;

  // the [9*Cin x 16] matrix, a K slice at a time: the slice's rows of w
  // (BK*Co contiguous elements a tap) staged raw in the ring by 16-byte
  // loads, then scattered into the swizzled blocks of its nine
  // neighbours; neighbour o = (dy+1)*3 + dx+1, column n = (py*2+px)*4 + co
  {
    uint16_t* raw_w = reinterpret_cast<uint16_t*>(smem_raw + (ring - raw));
    const int tap_words = BK * p.Co / 8;   // 16-byte words of a tap's rows
    for (int sl = 0; sl < p.slices; ++sl) {
      for (int q = tid; q < 25 * tap_words; q += THREADS) {
        const int tap = q / tap_words;
        reinterpret_cast<uint4*>(raw_w)[q] = __ldg(
            reinterpret_cast<const uint4*>(p.w + (tap * p.Cin + sl * BK) *
                                                     p.Co) +
            (q - tap * tap_words));
      }
      __syncthreads();
      for (int e = tid; e < 9 * 16 * BK; e += THREADS) {
        const int kk = e % BK, n = (e / BK) % 16, o = e / (16 * BK);
        const int dy = o / 3 - 1, dx = o % 3 - 1;
        const int py = n >> 3, px = (n >> 2) & 1, co = n & 3;
        uint16_t v = 0;
        if (co < p.Co && (py || dy <= 0) && (px || dx <= 0)) {
          const int kh = py ? 2 * dy + 2 : 2 * dy + 3;
          const int kw = px ? 2 * dx + 2 : 2 * dx + 3;
          v = raw_w[((kh * 5 + kw) * BK + kk) * p.Co + co];
        }
        *reinterpret_cast<uint16_t*>(smem_raw + (wts - raw) +
                                     (o * p.slices + sl) * W_BLOCK +
                                     swizzled<RB>(n * RB + kk * 2)) = v;
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  igemm90::fence_async_proxy();   // the weights, for wgmma
  __syncthreads();

  const int my_tiles = blockIdx.x < p.tiles
                           ? (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                           : 0;
  auto origin = [&](int k) {   // (col0, row0, b) of this block's k-th tile
    const int t = blockIdx.x + k * gridDim.x;
    const int per = p.nth * p.ntw, b = t / per, rem = t - b * per;
    const int ih = rem / p.ntw;
    return make_int3((rem - ih * p.ntw) * p.tw, ih * p.tr, b);
  };

  // tile k goes to warpgroup k % 2, its slices through that warpgroup's
  // own ring of `half` stages (so that one warpgroup's epilogue overlaps
  // the other's products)
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      int n[2] = {0, 0};   // items loaded into each warpgroup's ring
      for (int k = 0; k < my_tiles; ++k) {
        const int w = k & 1;
        const int3 q = origin(k);
        for (int sl = 0; sl < p.slices; ++sl, ++n[w]) {
          const int s = w * half + n[w] % half;
          if (n[w] >= half)
            igemm90::mbar_wait(igemm90::smem_u32(&empty[s]),
                               ((n[w] / half) + 1) & 1);
          const uint32_t bar = igemm90::smem_u32(&full[s]);
          igemm90::mbar_expect_tx(bar, p.box_bytes);
          igemm90::tma_load_4d(ring + s * p.patch_bytes, &xmap, sl * BK,
                               q.x - 1, q.y - 1, q.z, bar);
        }
      }
    }
    return;
  }

  float acc[NB][8];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[b][i] = 0.f;
  // where this thread's accumulators go, the same for every tile: rows
  // warp*16 + lane/4 (+8) of m64 block b are the patch's pixel pos = PW + 1
  // + 64b + row at (r, c) = (pos / PW, pos % PW), valid on 1..TR x 1..TW;
  // columns n = (i>>2)*8 + (tid&3)*2 + (i&1): py = i>>2, px = (tid&3)>>1,
  // co = 2*(tid&1) + (i&1)
  const int co0 = 2 * (tid & 1), px_t = (tid & 3) >> 1;
  float sc[2], sh[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    sc[j] = co0 + j < p.Co ? p.scale[co0 + j] : 0.f;
    sh[j] = co0 + j < p.Co ? p.shift[co0 + j] : 0.f;
  }
  const int pos0 = p.pw + 1 + igemm90::acc_row(tid128, 0);
  const int r0 = pos0 / p.pw, c0 = pos0 - r0 * p.pw;
  const int step8_r = 8 / p.pw, step8_c = 8 - step8_r * p.pw;
  const int step56_r = 56 / p.pw, step56_c = 56 - step56_r * p.pw;
  int it = 0;   // items of this warpgroup's ring
  for (int k = wg; k < my_tiles; k += 2) {
    for (int sl = 0; sl < p.slices; ++sl, ++it) {
      const int s = wg * half + it % half;
      igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (it / half) & 1);
      const uint32_t patch = ring + s * p.patch_bytes;
      // a commit group a neighbour, one in flight behind the next (a group
      // that spans a loop's back edge would serialize its wgmmas)
#pragma unroll 1
      for (int o = 0; o < 9; ++o) {
        const int shift = (o / 3 - 1) * p.pw + o % 3 - 1;
        const uint64_t bd = desc<RB>(wts + (o * p.slices + sl) * W_BLOCK);
        const uint64_t ad = desc<RB>(patch + (p.pw + 1 + shift) * RB);
        igemm90::wgmma_fence();
        // the NB blocks' chains interleaved: a k16 step of m64n16 is too
        // short to cover the latency of the next one on its accumulator
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)   // +32 bytes a k16 step
#pragma unroll
          for (int b = 0; b < NB; ++b)         // +64 rows a block
            mma16(acc[b], ad + 2 * kk + b * (64 * RB >> 4), bd + 2 * kk);
        igemm90::wgmma_commit();
        igemm90::wgmma_wait<1>();
      }
      igemm90::wgmma_wait<0>();
      if (tid128 == 0) mbar_arrive(igemm90::smem_u32(&empty[s]));
    }

    // the tile's outputs: act(acc*scale + shift), staged [2TR][2TW][Co];
    // (r, c) of each row stepped from the last (no division a value)
    {
      int r = r0, c = c0;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // rows +8 (h) then +56 (the next block's first)
          const int at_h =
              r >= 1 && r <= p.tr && c >= 1 && c <= p.tw
                  ? 2 * (r - 1) * ow + (2 * (c - 1) + px_t) * p.Co + co0
                  : -1;
#pragma unroll
          for (int i = 2 * h; i < 8; i += 4) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              // read on every thread's path: an accumulator read behind a
              // branch would serialize the wgmmas
              const float a = acc[b][i + j];
              acc[b][i + j] = 0.f;
              if (at_h >= 0 && co0 + j < p.Co)
                out[at_h + (i >> 2) * ow + j] =
                    __bfloat16_as_ushort(__float2bfloat16(
                        apply_act(fmaf(a, sc[j], sh[j]), p.act)));
            }
          }
          const int step_r = h ? step56_r : step8_r;
          const int step_c = h ? step56_c : step8_c;
          c += step_c;
          r += step_r + (c >= p.pw ? 1 : 0);
          c -= c >= p.pw ? p.pw : 0;
        }
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    // row by row, 4 bytes a thread (rows, their starts and ow are even)
    const int3 q = origin(k);
    const int x0 = 2 * q.x * p.Co, xw = 2 * p.W * p.Co;
    const int words = ((xw - x0 < ow ? xw - x0 : ow)) / 2;
    for (int oy = 0; oy < 2 * p.tr && 2 * q.y + oy < 2 * p.H; ++oy) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          p.y + (static_cast<size_t>(q.z) * 2 * p.H + 2 * q.y + oy) * xw +
          x0);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(out + oy * ow);
      for (int e = tid128; e < words; e += 128) dst[e] = src[e];
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
}

// The tile of a map: TW = min(W, 64) pixels of TR rows, a tile's GEMM rows
// NB m64 blocks (NB of 8, 4, 2: a template argument, so that no wgmma sits
// behind a branch), TR the most rows whose patch those rows cover: of the
// three, the fewest rows computed over the map (ties to the larger NB)
// whose two patches, weights and staged outputs fit the SM.  The stage and
// smem sizes with it.
template <int BK>
bool plan(P& p, int& smem) {
  constexpr int RB = BK * 2;
  p.tw = p.W < 64 ? p.W : 64;
  p.pw = p.tw + 2;
  p.slices = p.Cin / BK;
  p.w_bytes = 9 * p.Cin * 16 * 2;
  long long best = -1;
  P pick = p;
  int pick_smem = 0;
  const int choices[3] = {8, 4, 2};
  for (int nb : choices) {
    P q = p;
    q.nb = nb;
    q.tr = (64 * nb + 2) / q.pw;
    if (q.tr > q.H) q.tr = q.H;
    if (q.tr < 1) continue;
    // rows read: up to 2*PW + 1 + 64*NB past the start (slack past the
    // patch: computed and dropped), 8-row atoms
    const int box_rows = (q.tr + 2) * q.pw;
    const int reach = 2 * q.pw + 2 + 64 * nb;
    const int rows = ((box_rows > reach ? box_rows : reach) + 7) / 8 * 8;
    q.patch_bytes = (rows * RB + 1023) / 1024 * 1024;
    q.box_bytes = box_rows * RB;
    const int out_bytes = 2 * q.tr * 2 * q.tw * q.Co * 2;   // a warpgroup's
    const int fixed =
        1024 + (q.w_bytes + 1023) / 1024 * 1024 + 2 * out_bytes;
    q.stages = (SMEM_CAP - fixed) / q.patch_bytes;
    if (q.stages > MAX_STAGES) q.stages = MAX_STAGES;
    q.stages &= ~1;   // a ring each warpgroup
    if (q.stages < 2) continue;
    const int need = fixed + q.stages * q.patch_bytes;
    const long long cost =
        static_cast<long long>((q.H + q.tr - 1) / q.tr) * nb;
    if (best < 0 || cost < best) {
      best = cost;
      pick = q;
      pick_smem = need;
    }
  }
  if (best < 0) return false;
  p = pick;
  smem = pick_smem;
  p.ntw = (p.W + p.tw - 1) / p.tw;
  p.nth = (p.H + p.tr - 1) / p.tr;
  p.tiles = p.B * p.nth * p.ntw;
  return true;
}

template <int BK, int NB>
cudaError_t launch_nb(const P& p, const CUtensorMap& xmap, int smem,
                      cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      thin_kernel<BK, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, thin_kernel<BK, NB>, THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = p.tiles < per_sm * sms ? p.tiles : per_sm * sms;
  thin_kernel<BK, NB><<<grid, THREADS, smem, s>>>(p, xmap);
  return cudaGetLastError();
}

template <int BK>
cudaError_t launch(const Params& q, cudaStream_t s) {
  P p;
  p.w = static_cast<const uint16_t*>(q.w);
  p.scale = q.scale;
  p.shift = q.shift;
  p.y = static_cast<uint16_t*>(q.y);
  p.B = q.B;
  p.H = q.H;
  p.W = q.W;
  p.Cin = q.Cin;
  p.Co = q.Co;
  p.act = q.act;
  int smem = 0;
  if (!plan<BK>(p, smem)) return cudaErrorInvalidValue;
  // x [B][H][W][Cin]: boxes of BK channels x PW pixels x TR+2 rows
  const cuuint64_t d[4] = {static_cast<cuuint64_t>(q.Cin),
                           static_cast<cuuint64_t>(q.W),
                           static_cast<cuuint64_t>(q.H),
                           static_cast<cuuint64_t>(q.B)};
  const cuuint64_t st[3] = {d[0] * 2, d[0] * d[1] * 2, d[0] * d[1] * d[2] * 2};
  const cuuint32_t box[4] = {BK, static_cast<cuuint32_t>(p.pw),
                             static_cast<cuuint32_t>(p.tr + 2), 1};
  CUtensorMap xmap = {};
  cudaError_t err = igemm90::encode_tiled(
      &xmap, 4, q.x, d, st, box,
      BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : BK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != cudaSuccess) return err;
  switch (p.nb) {
    case 8: return launch_nb<BK, 8>(p, xmap, smem, s);
    case 4: return launch_nb<BK, 4>(p, xmap, smem, s);
    default: return launch_nb<BK, 2>(p, xmap, smem, s);
  }
}

}  // namespace thin

// ---------------------------------------------------------------------------
// The wgmma path: four groups, one per output parity g = (py, px) =
// (g >> 1, g & 1), (2+py)(2+px) taps each; tap t = (th, tw), th = t / (2+px).
struct Deconv : igemm::Common {
  const float* scale;
  const float* shift;
  int H, W;

  __host__ __device__ int group_taps(int g) const {
    return (2 + (g >> 1)) * (2 + (g & 1));
  }
  __host__ __device__ long long weight_rows() const {   // HWIO as [25*Cin][Co]
    return 25LL * Cin;
  }

  // row r = (b, m, n) of parity g reads input pixel (m-1+th, n-1+tw) at tap
  // (th, tw): the base is pixel (m-1, n-1), which may lie in the padding
  __device__ igemm90::Gather gather(int r, int g) const {
    if (r >= M) return igemm90::Gather{0, 0, 0u};
    const int hw = H * W, b = r / hw, rem = r - b * hw;
    const int m = rem / W, n = rem - m * W;
    const int nth = 2 + (g >> 1), ntw = 2 + (g & 1);
    unsigned mw = 0, taps = 0;
    for (int tw = 0; tw < ntw; ++tw)
      if (n - 1 + tw >= 0 && n - 1 + tw < W) mw |= 1u << tw;
    for (int th = 0; th < nth; ++th)
      if (m - 1 + th >= 0 && m - 1 + th < H) taps |= mw << (th * ntw);
    return igemm90::Gather{
        ((static_cast<long long>(b) * H + m - 1) * W + n - 1) * Cin, 0, taps};
  }
  __device__ long long row_off(const igemm90::Gather& q, int) const {
    return q.base;
  }
  __device__ long long tap_off(int g, int tap) const {
    const int ntw = 2 + (g & 1), th = tap / ntw, tw = tap - th * ntw;
    return (static_cast<long long>(th) * W + tw) * Cin;
  }
  __device__ int slices(int) const { return Cin / igemm90::BK; }

  static constexpr bool kOneWeightMatrix = true;
  // tap (th, tw) of parity (py, px) reads kernel tap (2th+1-py, 2tw+1-px)
  __device__ int w_row(int g, int tap) const {
    const int py = g >> 1, px = g & 1, ntw = 2 + px;
    const int th = tap / ntw, tw = tap - th * ntw;
    return ((2 * th + 1 - py) * 5 + 2 * tw + 1 - px) * Cin;
  }

  __device__ size_t y_row(int r, int g) const {
    const int hw = H * W, b = r / hw, rem = r - b * hw;
    const int m = rem / W, n = rem - m * W;
    const size_t oy = 2 * m + (g >> 1), ox = 2 * n + (g & 1);
    return ((static_cast<size_t>(b) * (2 * H) + oy) * (2 * W) + ox) * N;
  }
  __device__ float mul(int co) const { return scale[co]; }
  __device__ float add(int, int co) const { return shift[co]; }

  // A by TMA where row tiles are whole image rows: tap (th, tw) is the
  // tile's box shifted by (th-1, tw-1)
  static constexpr bool kGrouped = true;
  static constexpr bool kImageA = true;
  bool a_boxes(int bm) const { return igemm90::image_boxes(H, W, bm); }
  cudaError_t a_map(CUtensorMap* map, int bm) const {
    return igemm90::make_image_map(map, a, M / (H * W), H, W, Cin, bm);
  }
  __device__ int3 a_box(int row0, int g, int tap) const {
    const int ntw = 2 + (g & 1), th = tap / ntw, tw = tap - th * ntw;
    return igemm90::image_box(row0, H, W, th - 1, tw - 1);
  }
};

enum Path { kTile = 0, kPipelined = 1, kDirect = 2, kWgmma = 3, kThin = 4 };

Params make_params(const void* x, const void* w, const void* scale,
                   const void* shift, void* y, int B, int H, int W, int Cin,
                   int Co, int act, int bf16) {
  const int vec = bf16 ? 8 : 4;
  return Params{x, w, static_cast<const float*>(scale),
                static_cast<const float*>(shift), y, B, H, W, Cin, Co, act,
                Cin % vec == 0 && aligned16(x), Co % vec == 0 && aligned16(w),
                Co % vec == 0 && aligned16(y)};
}

Deconv make_deconv(const Params& q) {
  Deconv p;
  p.a = q.x;
  p.w = q.w;
  p.y = q.y;
  p.M = q.B * q.H * q.W;
  p.N = q.Co;
  p.Cin = q.Cin;
  p.taps = 9;          // the longest parity; group_taps gives each one's
  p.act = q.act;
  p.vec_a = q.vec_x;
  p.vec_w = q.vec_w;
  p.vec_y = q.vec_y;
  p.groups = 4;
  p.scale = q.scale;
  p.shift = q.shift;
  p.H = q.H;
  p.W = q.W;
  return p;
}

// The path a call takes: from shapes, types and alignment only.
int deconv_path(const Params& q, bool bf16) {
  if (q.Co <= 4 && 25 * q.Cin * static_cast<int>(sizeof(float4)) <= D_MAX_SMEM)
    return bf16 && q.Cin % 16 == 0 && aligned16(q.x) && aligned16(q.w) &&
                   aligned16(q.y)
               ? kThin
               : kDirect;
  if (bf16 && igemm90::applies(make_deconv(q))) return kWgmma;
  return bf16 && q.vec_x && q.vec_w && q.vec_y ? kPipelined : kTile;
}

}  // namespace

// The path t2i_deconv5x5_s2 takes for these pointers and shapes: 0 the
// simple tile, 1 the pipelined tile, 2 the direct kernel, 3 wgmma, 4 thin.
extern "C" int t2i_deconv5x5_s2_path(const void* x, const void* w,
                                     const void* y, int Cin, int Co,
                                     int bf16) {
  return deconv_path(make_params(x, w, nullptr, nullptr, const_cast<void*>(y),
                                 1, 1, 1, Cin, Co, 0, bf16),
                     bf16 != 0);
}

// Launches on `stream` and returns the CUDA error code (0 when launched).
// `tile` (igemm90::TileId) and the parts of K of parities 0-3 (p0..p3, whole
// taps each) are read on the wgmma path only; a part count above 1 needs
// `ws`, f32 scratch of one B*H*W x Co plane per part of every split parity.
// No path gives way to another: a refused launch is returned.
extern "C" int t2i_deconv5x5_s2(const void* x, const void* w,
                                const void* scale, const void* shift, void* y,
                                void* ws, int B, int H, int W, int Cin, int Co,
                                int act, int bf16, int tile, int p0, int p1,
                                int p2, int p3, void* stream) {
  const Params p =
      make_params(x, w, scale, shift, y, B, H, W, Cin, Co, act, bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(B) * H * W;
  switch (deconv_path(p, bf16 != 0)) {
    case kWgmma: {
      const int parts[4] = {p0, p1, p2, p3};
      return static_cast<int>(igemm90::launch(
          make_deconv(p), tile, parts, static_cast<float*>(ws), s));
    }
    case kThin:
      return static_cast<int>(p.Cin % 64 == 0   ? thin::launch<64>(p, s)
                              : p.Cin % 32 == 0 ? thin::launch<32>(p, s)
                                                : thin::launch<16>(p, s));
    case kDirect:
      return static_cast<int>(bf16 ? launch_direct_co<true>(p, s)
                                   : launch_direct_co<false>(p, s));
    case kPipelined: {
      cudaError_t err = cudaFuncSetAttribute(
          deconv5x5_s2_pipelined_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid(static_cast<unsigned>((M + P_BM - 1) / P_BM),
                      static_cast<unsigned>((Co + P_BN - 1) / P_BN), 4);
      deconv5x5_s2_pipelined_kernel<<<grid, THREADS, P_SMEM, s>>>(p);
      return static_cast<int>(cudaGetLastError());
    }
    default: {
      const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                      static_cast<unsigned>((Co + BN - 1) / BN), 4);
      if (bf16)
        deconv5x5_s2_kernel<true><<<grid, THREADS, 0, s>>>(p);
      else
        deconv5x5_s2_kernel<false><<<grid, THREADS, 0, s>>>(p);
      return static_cast<int>(cudaGetLastError());
    }
  }
}
