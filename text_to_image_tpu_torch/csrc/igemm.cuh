// Implicit-GEMM tiles for Hopper (sm_90a) on mma.sync and f32 FMA: what
// conv5x5_s2.cu and upconv3x3.cu launch for the shapes their wgmma paths do
// not take (f32, channels that are not multiples of 64).
// igemm_sm90.cuh holds the wgmma form of the same problem and reuses the
// problem type, the activations and store_out from here.
//
//   Y[r, co] = act(sum_k A[r, k] * Wt[k, co] * mul(co) + add(r, co)),
//   r < M, co < N
//
// K is walked as `taps` taps of Cin channels: tap t reads B rows
// Wt[t*Cin .. t*Cin+Cin) (weights [taps][Cin][N], row-major) and A row r's
// channels from wherever the problem's gather puts them (a_off), or zeros
// where the gather returns -1.  Y is row-major [M, N] unless the problem
// places its rows elsewhere.  A problem type P supplies the gather and the
// epilogue's additive term:
//
//   struct P : igemm::Common {
//     struct Row {...};                                 // decoded once
//     __device__ Row row(int r) const;                  // any r, even >= M
//     __device__ long long a_off(const Row&, int tap, int ci) const;
//     __device__ float add(int r, int co) const;
//   };
//
// and may hide Common's defaults: `mul` (per-channel scale, 1), `y_row`
// (element offset of output row r, r*N) and `w_tap` (which [Cin][N] block of
// the weights tap t reads, t).  With `groups` = G > 1 the launch runs G
// GEMMs over the same M x N extent, the group index the fastest part of
// blockIdx.x (`group()`), so that the G blocks that gather the same A rows
// run together and share them in L2; the problem reads `group()` in its
// gather, `w_tap` and `y_row`.
//
// What bounds these kernels on the card: mma.sync reaches about an eighth of
// the bf16 tensor-core peak (124-128 TFLOP/s on the 256 px discriminator),
// and K slices of 32 put a barrier after every 16 products of a warp; that
// is why the deep bf16 convolutions moved to igemm_sm90.cuh.
//
// Two kernels, the same machinery as csrc/deconv5x5_s2.cu:
//  * tile_kernel<P, BF16>: 128x64 tiles, K slices of 32 staged through
//    shared memory with a one-deep register pipeline; bf16 on WMMA
//    (mma.sync 16x16x16, f32 accumulate), f32 on FMA with an 8x4 register
//    tile.  Ragged Cin, N and M are masked: it takes every shape.
//  * pipelined_kernel<P>: bf16 with Cin % 8 == 0, N % 8 == 0 and 16-byte
//    aligned pointers; 128x128 tiles, 8 warps of 64x32, K slices copied
//    global -> shared with cp.async (zero-filled where the gather gives -1)
//    in a 3-stage ring.
// The epilogue runs in f32 and stores each output once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace igemm {

constexpr int THREADS = 256;
constexpr int PAD = 8;  // shared-memory row padding (elements)

enum Act { kNone = 0, kRelu = 1, kLrelu = 2, kTanh = 3 };

struct Common {
  const void* a;   // A's base (the gather's offsets are in elements)
  const void* w;   // [taps][Cin][N]
  void* y;         // [M][N]
  int M, N, Cin, taps, act;
  int vec_a, vec_w, vec_y;  // 16-byte accesses are legal for A / W / Y
  int groups = 1;           // GEMMs per launch (see above)

  __device__ int group() const { return blockIdx.x % groups; }
  __device__ int w_tap(int tap) const { return tap; }
  __device__ size_t y_row(int r) const { return static_cast<size_t>(r) * N; }
  __device__ float mul(int) const { return 1.f; }
  // igemm_sm90.cuh hands the group to its hooks instead of decoding it:
  // taps of group g, row r of group g's output, rows of the one weight
  // matrix its TMA map covers
  __host__ __device__ int group_taps(int) const { return taps; }
  __device__ size_t y_row(int r, int) const {
    return static_cast<size_t>(r) * N;
  }
  __host__ __device__ long long weight_rows() const {
    return static_cast<long long>(taps) * Cin;
  }
  // whether its rows are image pixels whose A slices it can describe as
  // TMA boxes (a_boxes, a_map, a_box: see igemm_sm90.cuh)
  static constexpr bool kImageA = false;
  // whether it may run more than one group (igemm_sm90.cuh decodes the
  // group and reads the per-group split only then: read by a runtime group
  // index they made the one-group conv up to 15 % slower on the H100)
  static constexpr bool kGrouped = false;
};

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kLrelu: return v >= 0.f ? v : 0.2f * v;
    case kTanh: return tanhf(v);
    default: return v;
  }
}

__device__ __forceinline__ float to_float(uint16_t bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ float to_float(float v) { return v; }

inline bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// Stores n <= VEC outputs of row r from column co: act(v*mul + add) in f32.
template <class P, bool BF16>
__device__ __forceinline__ void store_out(const P& p, int r, int co,
                                          const float* v, int n) {
  using S = typename std::conditional<BF16, uint16_t, float>::type;
  constexpr int VEC = 16 / sizeof(S);
  union {
    uint4 u;
    S e[VEC];
  } o;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = e < n ? co + e : co;
    const float f = apply_act(fmaf(v[e], p.mul(c), p.add(r, c)), p.act);
    if constexpr (BF16)
      o.e[e] = __bfloat16_as_ushort(__float2bfloat16(f));
    else
      o.e[e] = f;
  }
  S* y = static_cast<S*>(p.y) + p.y_row(r) + co;
  if (n == VEC && p.vec_y) {
    *reinterpret_cast<uint4*>(y) = o.u;
  } else {
    for (int e = 0; e < n; ++e) y[e] = o.e[e];
  }
}

// ---------------------------------------------------------------------------
constexpr int BM = 128, BN = 64, BK = 32;

template <class P, bool BF16>
__global__ void __launch_bounds__(THREADS) tile_kernel(P p) {
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
  const int row0 = (blockIdx.x / p.groups) * BM, co0 = blockIdx.y * BN;
  const S* a = static_cast<const S*>(p.a);
  const S* w = static_cast<const S*>(p.w);

  typename P::Row rows[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i)
    rows[i] = p.row(row0 + (tid + i * THREADS) / A_VPR);

  const int nk = (p.Cin + BK - 1) / BK;      // K slices per tap
  const int n_iter = p.taps * nk;

  uint4 a_reg[A_LOADS], b_reg[B_LOADS];
  auto load_slice = [&](int it) {
    const int tap = it / nk, wt = p.w_tap(tap);
    const int ci0 = (it - tap * nk) * BK;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int ci = ci0 + ((tid + i * THREADS) % A_VPR) * VEC;
      Vec v;
      v.u = make_uint4(0, 0, 0, 0);
      const long long off = ci < p.Cin ? p.a_off(rows[i], tap, ci) : -1;
      if (off >= 0) {
        const S* src = a + off;
        if (p.vec_a) {
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
      if (ci < p.Cin && co < p.N) {
        const S* src = w + (static_cast<size_t>(wt) * p.Cin + ci) *
                               static_cast<size_t>(p.N) + co;
        if (p.vec_w) {
          v.u = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v.e[e] = co + e < p.N ? src[e] : S(0);
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
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[ty * 8 + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_fma[i][j] = fmaf(av[i], bv[j], acc_fma[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (BF16) {
    // Each warp stages one 16x16 accumulator at a time through its own
    // 1 KB of the (now idle) A tile; lane l then owns row l/2, 8 columns.
    float* stage = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
    const int rr = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(stage, acc_mma[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = row0 + wm * 32 + i * 16 + rr;
        const int co = co0 + wn * 32 + j * 16 + cc;
        if (r < p.M && co < p.N)
          store_out<P, true>(p, r, co, stage + rr * 16 + cc,
                             p.N - co < 8 ? p.N - co : 8);
        __syncwarp();
      }
    }
  } else {
    const int co = co0 + tx * 4;
    if (co < p.N) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + ty * 8 + i;
        if (r >= p.M) break;
        store_out<P, false>(p, r, co, acc_fma[i], p.N - co < 4 ? p.N - co : 4);
      }
    }
  }
}

// ---------------------------------------------------------------------------
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

template <class P>
__global__ void __launch_bounds__(THREADS) pipelined_kernel(P p) {
  constexpr int B_CPR = P_BN / 8;                // 16-byte chunks per B row
  constexpr int B_LOADS = P_BK * B_CPR / THREADS;
  constexpr int WARPS_N = P_BN / 32;             // 2 x 4 warps of 64 x 32
  constexpr int FM = 4;                          // 16-row fragments per warp
  extern __shared__ __align__(128) uint16_t smem[];
  uint16_t* As = smem;                           // [STAGES][BM][LDA]
  uint16_t* Bs = smem + P_STAGES * P_A_STAGE;    // [STAGES][BK][LDB]

  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / p.groups) * P_BM, co0 = blockIdx.y * P_BN;
  const uint16_t* a = static_cast<const uint16_t*>(p.a);
  const uint16_t* w = static_cast<const uint16_t*>(p.w);

  // A tile: 128 rows x 4 chunks of 8 channels; each thread copies 2.
  typename P::Row rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = p.row(row0 + ((tid + i * THREADS) >> 2));
  const int nk = (p.Cin + P_BK - 1) / P_BK;
  const int n_iter = p.taps * nk;

  auto issue = [&](int it, int stage) {
    const int tap = it / nk, wt = p.w_tap(tap);
    const int ci0 = (it - tap * nk) * P_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 2, c8 = (idx & 3) * 8, ci = ci0 + c8;
      const long long off = ci < p.Cin ? p.a_off(rows[i], tap, ci) : -1;
      cp_async16(As + stage * P_A_STAGE + row * P_LDA + c8,
                 off >= 0 ? a + off : a, off >= 0);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kr = idx / B_CPR, c8 = (idx % B_CPR) * 8;
      const int ci = ci0 + kr, co = co0 + c8;
      const bool valid = ci < p.Cin && co < p.N;
      const uint16_t* src =
          valid ? w + (static_cast<size_t>(wt) * p.Cin + ci) *
                          static_cast<size_t>(p.N) + co
                : w;
      cp_async16(Bs + stage * P_B_STAGE + kr * P_LDB + c8, src, valid);
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
        Bs + (it % P_STAGES) * P_B_STAGE);
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
        wmma::load_matrix_sync(fb[j], b_s + kk * P_LDB + wn * 32 + j * 16,
                               P_LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_all;\n");
  __syncthreads();

  // Each warp stages one 16x16 accumulator at a time through 1 KB of the
  // idle ring; lane l owns row l/2, 8 columns (N % 8 == 0 on this path).
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int rr = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = row0 + wm * FM * 16 + i * 16 + rr;
      const int co = co0 + wn * 32 + j * 16 + cc;
      if (r < p.M && co < p.N) store_out<P, true>(p, r, co, stage + rr * 16 + cc, 8);
      __syncwarp();
    }
  }
}

// Launches the GEMM on `s`: the pipelined kernel where it applies, else the
// tile kernel.  Returns the CUDA error of the launch.
template <class P>
cudaError_t launch(const P& p, bool bf16, cudaStream_t s) {
  if (bf16 && p.vec_a && p.vec_w && p.vec_y) {
    cudaError_t err = cudaFuncSetAttribute(
        pipelined_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.M + P_BM - 1) / P_BM * p.groups,
                    (p.N + P_BN - 1) / P_BN);
    pipelined_kernel<P><<<grid, THREADS, P_SMEM, s>>>(p);
    return cudaGetLastError();
  }
  const dim3 grid((p.M + BM - 1) / BM * p.groups, (p.N + BN - 1) / BN);
  if (bf16)
    tile_kernel<P, true><<<grid, THREADS, 0, s>>>(p);
  else
    tile_kernel<P, false><<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace igemm
