// Fused matching-aware text join for Hopper (sm_90a).
//
//   y = act(x . wx + t . wt + bias)  =  act(conv1x1(concat(x, tile(t))))
//
// x NHWC [B,H,W,Cx], t [B,E], wx [Cx,Co], wt [E,Co] (the split of the 1x1
// conv kernel over the [image; text] channels), bias f32 [Co], y NHWC
// [B,H,W,Co]; bf16 or f32 in and out, f32 accumulation and epilogue.  The
// [B,H,W,Cx+E] concat and the tiled text never exist.
//
// Replaces text_to_image_tpu/ops/pallas/fused.py conditioning_join (Pallas
// body _join_kernel via _join_core).  The TPU kernel runs a grid of one
// example per step, each a 16-row matmul over Wx plus a 1-row matmul over
// Wt; that shape suits a sequential grid with a large VMEM and wastes
// Hopper's tensor cores, so it is not carried over.
//
// Decomposition: the text term is one row per example, u[b] = t[b] . wt +
// bias, an f32 [B,Co] product computed first (join_text_kernel, FMA: B*E*Co
// = 12.6 M MACs at B = 192).  The image term is one GEMM with M = B*H*W,
// N = Co, K = Cx over contiguous x rows, whose epilogue adds u[r / HW].
//
// Bound on the H100 SXM, GAN-CLS 64 px discriminator at B = 192 (three
// streams of 64), bf16: x 3.1 MB + y 3.1 MB + weights 0.6 MB = 6.8 MB, about
// 2 us at 3.35 TB/s, against 1.6 GFLOP (1.6 us at 989 TFLOP/s): bound by
// bytes.  At this size two launches of a few microseconds each set its time.
//
// Design: the GEMM tiles of igemm.cuh (a single tap of Cx channels): 128x128
// WMMA tiles with a 3-stage cp.async ring for aligned bf16, the simple
// 128x64 tile otherwise.  u is written to a scratch buffer the caller
// allocates, on the same stream, before the GEMM reads it.

#include "igemm.cuh"

namespace {

using igemm::Common;

struct Join : Common {
  const float* u;  // [B, N]: t . wt + bias
  int hw;

  struct Row {
    int r;  // < 0: past the last row
  };

  __device__ Row row(int r) const { return Row{r < M ? r : -1}; }

  __device__ long long a_off(const Row& q, int, int ci) const {
    return q.r < 0 ? -1 : static_cast<long long>(q.r) * Cin + ci;
  }

  __device__ float add(int r, int co) const {
    return u[static_cast<size_t>(r / hw) * N + co];
  }
};

template <bool BF16>
__global__ void join_text_kernel(const void* t_, const void* wt_,
                                 const float* bias, float* u, int E, int Co) {
  using S = typename std::conditional<BF16, uint16_t, float>::type;
  const S* t = static_cast<const S*>(t_) + static_cast<size_t>(blockIdx.y) * E;
  const S* wt = static_cast<const S*>(wt_);
  const int co = blockIdx.x * blockDim.x + threadIdx.x;
  if (co >= Co) return;
  float acc = 0.f;
  for (int e = 0; e < E; ++e)
    acc = fmaf(igemm::to_float(t[e]),
               igemm::to_float(wt[static_cast<size_t>(e) * Co + co]), acc);
  u[static_cast<size_t>(blockIdx.y) * Co + co] = acc + bias[co];
}

}  // namespace

// Launches both kernels on `stream` and returns the CUDA error code (0 when
// launched).  u is f32 scratch of B*Co elements.
extern "C" int t2i_conditioning_join(const void* x, const void* t,
                                     const void* wx, const void* wt,
                                     const void* bias, void* u, void* y,
                                     int B, int HW, int Cx, int E, int Co,
                                     int act, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid((Co + 127) / 128, B);
  if (bf16)
    join_text_kernel<true><<<tgrid, 128, 0, s>>>(
        t, wt, static_cast<const float*>(bias), static_cast<float*>(u), E, Co);
  else
    join_text_kernel<false><<<tgrid, 128, 0, s>>>(
        t, wt, static_cast<const float*>(bias), static_cast<float*>(u), E, Co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int vec = bf16 ? 8 : 4;
  Join p;
  p.a = x;
  p.w = wx;
  p.y = y;
  p.M = B * HW;
  p.N = Co;
  p.Cin = Cx;
  p.taps = 1;
  p.act = act;
  p.vec_a = Cx % vec == 0 && igemm::aligned16(x);
  p.vec_w = Co % vec == 0 && igemm::aligned16(wx);
  p.vec_y = Co % vec == 0 && igemm::aligned16(y);
  p.u = static_cast<const float*>(u);
  p.hw = HW;
  return static_cast<int>(igemm::launch(p, bf16 != 0, s));
}
