// Fused matching-aware text join for Hopper (sm_90a).
//
//   y = act(x . wx + t . wt + bias)  =  act(conv1x1(concat(x, tile(t))))
//
// x NHWC [B,H,W,Cx], t [B,E], wx [Cx,Co], wt [E,Co] (the split of the 1x1
// conv kernel over the [image; text] channels), bias f32 [Co], y NHWC
// [B,H,W,Co]; bf16 or f32 in and out, f32 accumulation and epilogue.  The
// [B,H,W,Cx+E] concat and the tiled text never exist in device memory.
//
// Replaces text_to_image_tpu/ops/pallas/fused.py conditioning_join (Pallas
// body _join_kernel via _join_core).  The TPU kernel runs a grid of one
// example per step, each a 16-row matmul over Wx plus a 1-row matmul over
// Wt; that shape suits a sequential grid with a large VMEM and wastes
// Hopper's tensor cores, so it is not carried over.
//
// Bound on the H100 SXM, the discriminators' join at B = 192 (three streams
// of 64), bf16: x 3.1 MB + y 3.1 MB + weights 0.6 MB = 6.8 MB, about 2 us at
// 3.35 TB/s, against 1.6 GFLOP (1.6 us at 989 TFLOP/s): bound by bytes, and
// at this size really by latency: the chain of dependent trips to memory
// sets the time, not the work.
//
// Design: one launch.  The text term is folded into the GEMM's K: row r of A
// is [x[r, :Cx] ; t[r / HW, :E]] and B is [wx ; wt], each read from its own
// pointer, so K = Cx + E (640 on the main path) and neither the scratch row
// t . wt nor a second launch exists.
//  * wgmma (bf16; Cx, E, Co multiples of 64): the kernel of igemm_sm90.cuh
//    with two taps, the image channels and the text channels, whose gather
//    gives each row two offsets; 128x64 tiles (24 x 8 = 192 blocks at
//    B = 192, 64 at B = 64, two to an SM) fed through a 4-stage cp.async
//    ring, bias and activation in the epilogue.  A 64x64 tile that held its
//    whole K panel in shared memory (160 KB, every copy issued up front,
//    one trip to memory) was measured too: as fast at B = 64, but its 384
//    blocks at B = 192 run one to an SM in three waves and re-read 60 MB of
//    panels through L2, 1.7x slower than the ring.  wgmma rather than
//    mma.sync: the product is not the limit at 1.6 GFLOP, but the main loop
//    and its swizzled layout are the convolution's, so there is one to keep.
//  * join_simple_kernel (f32, ragged channels): a 64x64 tile of f32 FMA over
//    K slices of 16 with the same two-source reads, masked at every edge;
//    also one launch.

#include "igemm_sm90.cuh"

namespace {

using igemm::Common;

struct Join : Common {
  const void* t;      // [B, E]
  const void* wt;     // [E, N]
  const float* bias;  // [N]
  int hw, E;          // Cin holds Cx, `a` x and `w` wx
  long long t_from_x; // t's first element as an element offset from x

  __device__ float add(int, int co) const { return bias[co]; }

  // igemm_sm90.cuh: two taps, the image channels of row r and the text
  // channels of its example
  __device__ igemm90::Gather gather(int r, int) const {
    if (r >= M) return igemm90::Gather{0, 0, 0u};
    return igemm90::Gather{static_cast<long long>(r) * Cin,
                           t_from_x + static_cast<long long>(r / hw) * E, 3u};
  }
  __device__ long long row_off(const igemm90::Gather& g, int tap) const {
    return tap ? g.base2 : g.base;
  }
  __device__ long long tap_off(int, int) const { return 0; }
  __device__ int slices(int tap) const { return (tap ? E : Cin) / 64; }
  static constexpr bool kOneWeightMatrix = false;  // wx and wt
  __device__ const uint16_t* w_rows(int tap) const {
    return static_cast<const uint16_t*>(tap ? wt : w);
  }
};

// ---------------------------------------------------------------------------
constexpr int S_BM = 64, S_BN = 64, S_BK = 16;

template <bool BF16>
__global__ void __launch_bounds__(256) join_simple_kernel(Join p) {
  using S = typename std::conditional<BF16, uint16_t, float>::type;
  __shared__ float As[S_BK][S_BM + 1];
  __shared__ float Bs[S_BK][S_BN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * S_BM, co0 = blockIdx.y * S_BN;
  const S* x = static_cast<const S*>(p.a);
  const S* t = static_cast<const S*>(p.t);
  const S* wx = static_cast<const S*>(p.w);
  const S* wt = static_cast<const S*>(p.wt);
  const int K = p.Cin + p.E;
  const int ty = tid / 16, tx = tid % 16;   // 16 x 16 threads of 4 x 4

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += S_BK) {
    // A: 64 rows x 16 k, consecutive threads along k
    for (int q = tid; q < S_BM * S_BK; q += 256) {
      const int rl = q / S_BK, kk = q % S_BK;
      const int r = row0 + rl, k = k0 + kk;
      float v = 0.f;
      if (r < p.M && k < K)
        v = igemm::to_float(
            k < p.Cin ? x[static_cast<size_t>(r) * p.Cin + k]
                      : t[static_cast<size_t>(r / p.hw) * p.E + k - p.Cin]);
      As[kk][rl] = v;
    }
    // B: 16 k x 64 columns, consecutive threads along co
    for (int q = tid; q < S_BK * S_BN; q += 256) {
      const int kk = q / S_BN, cl = q % S_BN;
      const int k = k0 + kk, co = co0 + cl;
      float v = 0.f;
      if (k < K && co < p.N)
        v = igemm::to_float(
            k < p.Cin ? wx[static_cast<size_t>(k) * p.N + co]
                      : wt[static_cast<size_t>(k - p.Cin) * p.N + co]);
      Bs[kk][cl] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < S_BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  S* y = static_cast<S*>(p.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= p.M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co >= p.N) break;
      const float f = igemm::apply_act(acc[i][j] + p.bias[co], p.act);
      if constexpr (BF16)
        y[static_cast<size_t>(r) * p.N + co] =
            __bfloat16_as_ushort(__float2bfloat16(f));
      else
        y[static_cast<size_t>(r) * p.N + co] = f;
    }
  }
}

enum Path { kSimple = 0, kWgmma = 1 };

int join_path(const Join& p, bool bf16) {
  const bool aligned = igemm::aligned16(p.a) && igemm::aligned16(p.t) &&
                       igemm::aligned16(p.w) && igemm::aligned16(p.wt) &&
                       igemm::aligned16(p.y);
  return bf16 && aligned && p.Cin % 64 == 0 && p.E % 64 == 0 &&
                 p.N % 64 == 0 && p.Cin > 0 && p.E > 0
             ? kWgmma
             : kSimple;
}

Join make_join(const void* x, const void* t, const void* wx, const void* wt,
               const void* bias, void* y, int B, int HW, int Cx, int E,
               int Co, int act) {
  Join p;
  p.a = x;
  p.w = wx;
  p.y = y;
  p.M = B * HW;
  p.N = Co;
  p.Cin = Cx;
  p.taps = 2;                        // image channels, text channels
  p.act = act;
  p.vec_a = p.vec_w = p.vec_y = 1;   // join_path holds the alignment
  p.t_from_x = (reinterpret_cast<intptr_t>(t) - reinterpret_cast<intptr_t>(x)) /
               static_cast<intptr_t>(sizeof(uint16_t));
  p.t = t;
  p.wt = wt;
  p.bias = static_cast<const float*>(bias);
  p.hw = HW;
  p.E = E;
  return p;
}

}  // namespace

// The path t2i_conditioning_join takes: 0 the simple tile, 1 wgmma.
extern "C" int t2i_conditioning_join_path(const void* x, const void* t,
                                          const void* wx, const void* wt,
                                          const void* y, int Cx, int E, int Co,
                                          int bf16) {
  return join_path(make_join(x, t, wx, wt, nullptr, const_cast<void*>(y), 1, 1,
                             Cx, E, Co, 0),
                   bf16 != 0);
}

// Launches one kernel on `stream` and returns the CUDA error code (0 when
// launched).
extern "C" int t2i_conditioning_join(const void* x, const void* t,
                                     const void* wx, const void* wt,
                                     const void* bias, void* y, int B, int HW,
                                     int Cx, int E, int Co, int act, int bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Join p = make_join(x, t, wx, wt, bias, y, B, HW, Cx, E, Co, act);
  if (join_path(p, bf16 != 0) == kWgmma) {
    const int one_part = 1;
    return static_cast<int>(
        igemm90::launch(p, igemm90::k128x64, &one_part, nullptr, s));
  }
  const dim3 grid((p.M + S_BM - 1) / S_BM, (Co + S_BN - 1) / S_BN);
  if (bf16)
    join_simple_kernel<true><<<grid, 256, 0, s>>>(p);
  else
    join_simple_kernel<false><<<grid, 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
