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
// HBM-staged twin _deconv_kernel (via _deconv_pallas).
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
// Design (first version: simple and right).  One block computes one
// output-parity plane x a 128-row x 64-channel tile.  K is walked tap by
// tap in 32-deep slices staged through shared memory; the next slice's
// global loads go into registers before the current slice's math (a
// one-deep software pipeline).  bf16 runs on the tensor cores through WMMA
// (mma.sync 16x16x16, f32 accumulate), f32 on FMA with an 8x4 register
// tile.  The epilogue act(acc*scale + shift) runs in f32 and each output is
// stored once, straight into the interleaved NHWC image.  Ragged Co (the RGB
// layer's 3), ragged Cin and the image edges are masked, so every shape is
// taken.  Left for later: wgmma + TMA with a deeper shared-memory ring, and
// a narrow tile for Co=3, where the 64-wide tile wastes 61/64 of its MMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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
// Narrow Co (the RGB layer, Co=3): a GEMM tile would waste almost all of its
// MMA columns, so one thread takes one input pixel and computes the 2x2
// output pixels it feeds (its 3x3 neighbourhood through the 25 taps), in f32
// FMA.  All 25*Cin weight rows sit in shared memory as float4 (Co padded to
// 4), read as warp-wide broadcasts.
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

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 when launched).
// Path, chosen from the shapes: Co <= 4 -> the direct kernel; bf16 with
// channels that allow 16-byte copies -> the pipelined tile kernel; anything
// else (f32, ragged channels) -> the simple tile kernel.
extern "C" int t2i_deconv5x5_s2(const void* x, const void* w,
                                const void* scale, const void* shift, void* y,
                                int B, int H, int W, int Cin, int Co, int act,
                                int bf16, void* stream) {
  const int vec = bf16 ? 8 : 4;
  Params p{x, w, static_cast<const float*>(scale),
           static_cast<const float*>(shift), y, B, H, W, Cin, Co, act,
           Cin % vec == 0 && aligned16(x), Co % vec == 0 && aligned16(w),
           Co % vec == 0 && aligned16(y)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(B) * H * W;
  if (Co <= 4 && 25 * Cin * static_cast<int>(sizeof(float4)) <= D_MAX_SMEM) {
    return static_cast<int>(bf16 ? launch_direct_co<true>(p, s)
                                 : launch_direct_co<false>(p, s));
  }
  if (bf16 && p.vec_x && p.vec_w && p.vec_y) {
    cudaError_t err = cudaFuncSetAttribute(
        deconv5x5_s2_pipelined_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((M + P_BM - 1) / P_BM),
                    static_cast<unsigned>((Co + P_BN - 1) / P_BN), 4);
    deconv5x5_s2_pipelined_kernel<<<grid, THREADS, P_SMEM, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((Co + BN - 1) / BN), 4);
  if (bf16)
    deconv5x5_s2_kernel<true><<<grid, THREADS, 0, s>>>(p);
  else
    deconv5x5_s2_kernel<false><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
