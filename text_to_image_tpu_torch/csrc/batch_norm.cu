// Train-mode batch norm with a fused activation for Hopper (sm_90a): the
// statistics, the apply pass, and the two-pass backward.
//
//   forward   y  = act(x . a_s + b_s),  a_s = gamma . rstd_s,
//             b_s = beta - mean_s . a_s,  rstd_s = 1 / sqrt(var_s + eps)
//   state     new = mean over s of (momentum . old + (1 - momentum) . batch_s)
//   backward  dx = gamma . rstd_s . (ga - sum(ga)/R - xhat . sum(ga . xhat)/R)
//             ga = g . act'(y),  xhat = (x - mean_s) . rstd_s
//             dgamma = sum over s of sum(ga . xhat),  dbeta = sum of sum(ga)
//
// x is NHWC seen as [S.R, C]: S contiguous streams of R rows each (the
// discriminator's real / fake / wrong streams each take their own batch
// statistics, as the JAX package's vmap over stacked streams gives them).
// bf16 or f32 in and out; every sum in f32; biased variance.
//
// Replaces text_to_image_tpu/ops/pallas/fused.py bn_act (Pallas body
// _bn_act_kernel via _bn_act_core, and its _bn_act_bwd) together with the
// statistics around it that the JAX package leaves to XLA
// (text_to_image_tpu/ops/layers.py batch_norm / batch_norm_act).  The TPU
// kernel is an elementwise pass over row tiles with a and b computed outside
// it; here a train-mode BN call is two launches forward (statistics, apply)
// and two backward (reduce, apply), and the exact gradient through the
// statistics comes out of them.
//
// Bound on the H100 SXM: a few FLOPs an element and no tensor-core work, so
// bytes.  Forward: x read twice and y written once, 6 bytes an element in
// bf16; backward: g, y and x read twice and dx written, 14 bytes.  The
// largest call of the port (64x256x256x64 bf16, 268 M elements) moves
// 1.6 GB forward and 3.8 GB backward: 0.48 and 1.12 ms at 3.35 TB/s.
//
// Design.
//  * Plan (t2i_bn_plan; ops/kernels/fused.py bn_plan is its mirror).  A
//    thread owns 8 adjacent channels: one 16-byte vector of bf16, two of f32
//    (the vector path: C % 8 == 0 and 16-byte aligned pointers), or 8
//    element loads masked at C (the scalar path: any C).  A CTA of 256
//    threads covers a slice of at most 64 channels (`tpr` threads a row) and
//    256 / tpr row lanes, over one band of rows inside one stream.  The grid
//    is chunks x (S . bands), with bands chosen to give about two CTAs an SM
//    and each lane at least 4 rows.  Each lane keeps 4 rows of loads in
//    flight.
//  * bn_stats: Welford (n, mean, M2) per thread in registers, one division
//    a row shared by its 8 channels; the lanes merge through shared memory
//    in a fixed tree order and each CTA writes one partial to the
//    workspace.  The last CTA of each channel slice (a ticket counter after
//    __threadfence(); it resets the counter for the next call) merges the
//    slice's partials by Chan's formula in a fixed order and writes mean,
//    rstd, a and b per stream and the running state.  No float atomics and
//    no E[x^2] - E[x]^2: the results are bit-identical between runs.  One
//    merging CTA per slice, not one for the grid: a single CTA would read
//    every partial of every channel (about 264 x C x 8 bytes, 2 MB at
//    C = 1024) and take longer than the statistics themselves.
//  * bn_act: y = act(x . a_s + b_s) with a_s, b_s in registers across the
//    band's rows; the same kernel is the public fused.bn_act (S = 1, a and b
//    given: eval-mode BN and the folded stem).
//  * bn_bwd_reduce: per (stream, channel) sum(ga) and sum(ga . xhat), with
//    act' recovered from the saved output as _act_grad_from_output does, on
//    the same grid with the same fixed-order merge; the last CTA of a slice
//    also writes dgamma and dbeta, summed over streams in stream order.
//  * bn_bwd_apply: dx from g, y, x and the per-stream sums, cast to x's type.
//  * The per-channel values a pass needs (a and b, mean and rstd, the sums)
//    are loaded after the first rows' loads are in flight, so their trip to
//    memory overlaps that of x.
//  * Workspace (owned by the caller, allocated once per device): a ticket
//    counter per channel slice, then the partials.  The launches of one
//    stream run in order, so every call reuses it.
//  * Data parallel (the global batch cut over the D ranks of a batch group,
//    whose statistics the JAX package takes over the global batch):
//    bn_partials is bn_stats stopping at each stream's merged (n, mean, M2)
//    [3, S, C]; the caller all-gathers them to [D, 3, S, C]; bn_finish (one
//    thread a channel) merges the D partials by Chan's formula in rank
//    order and writes bn_stats' out, so every rank holds the same bits.
//    bn_finish reads and writes a few kB: its bound is launch latency.  The
//    backward all-reduces bn_bwd_reduce's sums and gives bn_bwd_apply the
//    global row count of a stream (`count`).
//  * Tried and not kept: statistics and apply as one cooperative launch for
//    x up to 16 MiB (every CTA waiting for its slice's a and b, the second
//    read of x from L2); 4-12 % slower than the two launches at every
//    GAN-CLS shape on the H100 (PERF.md, PR 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;             // channels a thread owns
constexpr int kTpr = 8;             // most threads a row: 64 channels a CTA
constexpr int kUnroll = 4;          // rows in flight a lane (the plan's unit)
constexpr int kCtasPerSm = 2;
constexpr int kMaxChunks = 4096;    // ticket counters: C up to 262144
constexpr int kSlot = 1 + 2 * kTpr * kVec;   // floats of one CTA's partial

enum Act { kNone = 0, kRelu = 1, kLrelu = 2, kTanh = 3 };

struct Plan {
  int vec;               // 1: 16-byte vectors, 0: element loads
  int groups;            // groups of 8 channels: ceil(C / 8)
  int tpr;               // groups a CTA covers (threads a row)
  int chunks;            // channel slices: ceil(groups / tpr)
  int lanes;             // row lanes: kThreads / tpr
  int bands;             // CTAs per stream and slice
  long long band_rows;   // rows of a band (the last may hold fewer)
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

Plan make_plan(long long R, int S, int C, bool vec_ok, int sms) {
  Plan p;
  p.vec = (C % kVec == 0 && vec_ok) ? 1 : 0;
  p.groups = static_cast<int>(ceil_div(C, kVec));
  p.tpr = p.groups < kTpr ? p.groups : kTpr;
  p.chunks = static_cast<int>(ceil_div(p.groups, p.tpr));
  p.lanes = kThreads / p.tpr;
  const long long fill = (static_cast<long long>(kCtasPerSm) * sms) /
                         (static_cast<long long>(p.chunks) * S);
  const long long most = ceil_div(R, static_cast<long long>(p.lanes) * kUnroll);
  long long bands = fill < most ? fill : most;
  if (bands < 1) bands = 1;
  p.band_rows = ceil_div(R, bands);
  p.bands = static_cast<int>(ceil_div(R, p.band_rows));
  return p;
}

long long ws_bytes_needed(const Plan& p, int S) {
  return 4LL * kMaxChunks +
         4LL * kSlot * p.chunks * static_cast<long long>(S) * p.bands;
}

struct Args {
  const void* x;
  const void* g;         // backward: the cotangent of y
  const void* y;         // backward: the saved output (unused for act none)
  void* out_t;           // bn_act: y; bn_bwd_apply: dx
  const float* gamma;
  const float* beta;
  const float* run_mean;
  const float* run_var;
  const float* a;        // bn_act: [S, C]
  const float* b;
  const float* mean;     // backward: bn_stats' mean [S, C] and rstd [S, C]
  const float* rstd;
  const float* sga;      // bn_bwd_apply: sum(ga) [S, C], sum(ga.xhat) [S, C]
  const float* sgx;
  float* out;            // bn_stats, bn_partials, bn_bwd_reduce: the results
  unsigned* tickets;     // [kMaxChunks]
  float* part;           // [chunks][S][bands][kSlot]
  long long R;
  long long count;       // bn_bwd_apply: the rows a stream's sums are over
  int S, C;
  float mom, omm, eps;   // momentum, 1 - momentum, eps
  Plan p;
};

// --- element access -----------------------------------------------------

__device__ __forceinline__ float bf16_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint16_t float_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float v[8]);

template <>
__device__ __forceinline__ void load8<float>(const float* p, float v[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

template <>
__device__ __forceinline__ void load8<uint16_t>(const uint16_t* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_float(w[i] & 0xffffu);
    v[2 * i + 1] = bf16_float(w[i] >> 16);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float v[8]);

template <>
__device__ __forceinline__ void store8<float>(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <>
__device__ __forceinline__ void store8<uint16_t>(uint16_t* p, const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(float_bf16(v[2 * i])) |
           (static_cast<uint32_t>(float_bf16(v[2 * i + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float get1(const float* p) { return *p; }
__device__ __forceinline__ float get1(const uint16_t* p) { return bf16_float(*p); }
__device__ __forceinline__ void put1(float* p, float v) { *p = v; }
__device__ __forceinline__ void put1(uint16_t* p, float v) { *p = float_bf16(v); }

// The thread's 8 channels of row `row` (0 where masked).
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* base, long long row, int C,
                                         int c0, bool ok, float v[8]) {
  const T* p = base + row * C + c0;
  if (VEC) {
    if (ok) {
      load8<T>(p, v);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = (ok && c0 + j < C) ? get1(p + j) : 0.f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_row(T* base, long long row, int C, int c0,
                                          const float v[8]) {
  T* p = base + row * C + c0;
  if (VEC) {
    store8<T>(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (c0 + j < C) put1(p + j, v[j]);
  }
}

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == kRelu) return v > 0.f ? v : 0.f;
  if (ACT == kLrelu) return v >= 0.f ? v : 0.2f * v;
  if (ACT == kTanh) return tanhf(v);
  return v;
}

// d act(p)/dp from y = act(p): every activation here is monotone with
// sign(y) = sign(p) (the JAX package's _act_grad_from_output).
template <int ACT>
__device__ __forceinline__ float act_grad(float y) {
  if (ACT == kRelu) return y > 0.f ? 1.f : 0.f;
  if (ACT == kLrelu) return y >= 0.f ? 1.f : 0.2f;
  if (ACT == kTanh) return 1.f - y * y;
  return 1.f;
}

// --- the thread's place in the grid --------------------------------------

struct Geo {
  int lane;            // row lane
  int gl;              // group inside the slice
  int g;               // channel group
  int c0;              // first channel
  bool lane_ok;        // lane < lanes (256 % tpr threads sit idle)
  bool live;           // lane_ok and g < groups
  int s, band;
  long long r0, r1;    // the band's rows, as rows of x
};

__device__ __forceinline__ Geo geo(const Args& a) {
  const Plan& p = a.p;
  Geo t;
  t.lane = threadIdx.x / p.tpr;
  t.gl = threadIdx.x % p.tpr;
  t.g = blockIdx.x * p.tpr + t.gl;
  t.c0 = t.g * kVec;
  t.lane_ok = t.lane < p.lanes;
  t.live = t.lane_ok && t.g < p.groups;
  t.s = blockIdx.y / p.bands;
  t.band = blockIdx.y % p.bands;
  const long long lo = t.band * p.band_rows;
  const long long hi = lo + p.band_rows < a.R ? lo + p.band_rows : a.R;
  t.r0 = t.s * a.R + lo;
  t.r1 = t.s * a.R + hi;
  return t;
}

// Per-channel values of the thread's stream: v[j] = src[s * C + c0 + j].
__device__ __forceinline__ void channel_vals(const float* src, const Geo& t,
                                             int C, float v[8]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    v[j] = (t.live && t.c0 + j < C)
               ? src[static_cast<long long>(t.s) * C + t.c0 + j]
               : 0.f;
}

// --- merges in a fixed order ---------------------------------------------

// Chan's formula: (n, mean, m2) <- (n, mean, m2) + (nb, mb, m2b).  With
// WELFORD false the pair is two plain sums and n is unused.
template <bool WELFORD>
__device__ __forceinline__ void merge(float& n, float u[8], float w[8],
                                      float nb, const float ub[8],
                                      const float wb[8]) {
  if (!WELFORD) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      u[j] += ub[j];
      w[j] += wb[j];
    }
    return;
  }
  if (nb == 0.f) return;
  const float nt = n + nb;
  const float fb = nb / nt;
  const float cross = n * fb;    // n . nb / nt
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float d = ub[j] - u[j];
    u[j] += d * fb;
    w[j] += wb[j] + d * d * cross;
  }
  n = nt;
}

struct Smem {
  float n[kThreads];
  float u[kThreads * kVec];
  float w[kThreads * kVec];
  int last;
};

// Merges the row lanes' states into lane 0, pairwise in a fixed tree order.
// Every thread of the CTA calls it.
template <bool WELFORD>
__device__ __forceinline__ void merge_lanes(float& n, float u[8], float w[8],
                                            const Geo& t, const Plan& p,
                                            Smem& sh) {
  const int i = threadIdx.x;
  for (int step = 1; step < p.lanes; step <<= 1) {
    if (t.lane_ok && (t.lane & (2 * step - 1)) == step) {
      sh.n[i] = n;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sh.u[i * kVec + j] = u[j];
        sh.w[i * kVec + j] = w[j];
      }
    }
    __syncthreads();
    if (t.lane_ok && (t.lane & (2 * step - 1)) == 0 && t.lane + step < p.lanes) {
      const int k = i + step * p.tpr;
      float ub[kVec], wb[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ub[j] = sh.u[k * kVec + j];
        wb[j] = sh.w[k * kVec + j];
      }
      merge<WELFORD>(n, u, w, sh.n[k], ub, wb);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float* slot(const Args& a, int s, int band) {
  return a.part + ((static_cast<long long>(blockIdx.x) * a.S + s) * a.p.bands +
                   band) * kSlot;
}

// Writes this CTA's partial (held by lane 0) and takes a ticket; true in the
// last CTA of the channel slice, which then sees every partial of it.
template <bool WELFORD>
__device__ __forceinline__ bool publish(const Args& a, const Geo& t, float n,
                                       const float u[8], const float w[8],
                                       Smem& sh) {
  if (t.lane == 0) {
    float* q = slot(a, t.s, t.band);
    if (WELFORD && t.gl == 0) q[0] = n;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      q[1 + t.gl * kVec + j] = u[j];
      q[1 + kTpr * kVec + t.gl * kVec + j] = w[j];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned total = static_cast<unsigned>(a.S * a.p.bands);
    const unsigned ticket = atomicAdd(a.tickets + blockIdx.x, 1u);
    sh.last = ticket == total - 1;
    if (sh.last) atomicExch(a.tickets + blockIdx.x, 0u);   // for the next call
  }
  __syncthreads();
  if (!sh.last) return false;
  __threadfence();
  return true;
}

// In the last CTA: stream s's partials merged into lane 0, bands taken by
// the lanes in turn (lane l: bands l, l + lanes, ...) and the lanes merged in
// the fixed tree order.
template <bool WELFORD>
__device__ __forceinline__ void gather_stream(const Args& a, const Geo& t,
                                              int s, Smem& sh, float& n,
                                              float u[8], float w[8]) {
  n = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) u[j] = w[j] = 0.f;
  if (t.lane_ok) {
    for (int band = t.lane; band < a.p.bands; band += a.p.lanes) {
      const float* q = slot(a, s, band);
      float ub[kVec], wb[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ub[j] = __ldcg(q + 1 + t.gl * kVec + j);
        wb[j] = __ldcg(q + 1 + kTpr * kVec + t.gl * kVec + j);
      }
      // from n = 0 the merge takes the band as it is
      merge<WELFORD>(n, u, w, WELFORD ? __ldcg(q) : 0.f, ub, wb);
    }
  }
  merge_lanes<WELFORD>(n, u, w, t, a.p, sh);
}

// --- kernels ---------------------------------------------------------------

// The last CTA of a slice: the streams' statistics from the partials; out
// = mean [S, C], rstd [S, C], a [S, C], b [S, C], then the new running mean
// [C] and var [C].
__device__ __forceinline__ void finish_stats(const Args& a, const Geo& t,
                                             Smem& sh) {
  const int C = a.C;
  const long long SC = static_cast<long long>(a.S) * C;
  float n, u[kVec], w[kVec];
  float acc_m[kVec], acc_v[kVec], gam[kVec], bet[kVec], rm[kVec], rv[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = t.c0 + j;
    const bool ok = t.live && c < C;
    acc_m[j] = acc_v[j] = 0.f;
    gam[j] = ok ? a.gamma[c] : 0.f;
    bet[j] = ok ? a.beta[c] : 0.f;
    rm[j] = ok ? a.run_mean[c] : 0.f;
    rv[j] = ok ? a.run_var[c] : 0.f;
  }
  for (int s = 0; s < a.S; ++s) {
    gather_stream<true>(a, t, s, sh, n, u, w);
    if (t.lane == 0 && t.live) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = t.c0 + j;
        if (c >= C) continue;
        const float var = w[j] / n;
        const float rstd = 1.f / sqrtf(var + a.eps);
        const float sa = rstd * gam[j];
        const long long i = static_cast<long long>(s) * C + c;
        a.out[i] = u[j];
        a.out[SC + i] = rstd;
        a.out[2 * SC + i] = sa;
        a.out[3 * SC + i] = bet[j] - u[j] * sa;
        acc_m[j] += a.mom * rm[j] + a.omm * u[j];
        acc_v[j] += a.mom * rv[j] + a.omm * var;
      }
    }
  }
  if (t.lane == 0 && t.live) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = t.c0 + j;
      if (c >= C) continue;
      a.out[4 * SC + c] = acc_m[j] / a.S;
      a.out[4 * SC + C + c] = acc_v[j] / a.S;
    }
  }
}

// The last CTA of a slice, in bn_partials: each stream's Welford state
// merged over its bands; out = n [S, C], mean [S, C], M2 [S, C] (n is the
// stream's row count, repeated over its channels).
__device__ __forceinline__ void write_partials(const Args& a, const Geo& t,
                                               Smem& sh) {
  const int C = a.C;
  const long long SC = static_cast<long long>(a.S) * C;
  float n, u[kVec], w[kVec];
  for (int s = 0; s < a.S; ++s) {
    gather_stream<true>(a, t, s, sh, n, u, w);
    if (t.lane == 0 && t.live) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = t.c0 + j;
        if (c >= C) continue;
        const long long i = static_cast<long long>(s) * C + c;
        a.out[i] = n;
        a.out[SC + i] = u[j];
        a.out[2 * SC + i] = w[j];
      }
    }
  }
}

// Statistics: out = mean [S, C], rstd [S, C], a [S, C], b [S, C], then the
// new running mean [C] and var [C] (finish_stats); with PARTIAL, each
// stream's (n, mean, M2) [3, S, C] instead (write_partials), for bn_finish
// to merge with the other ranks' after an all-gather.
template <typename T, bool VEC, bool PARTIAL>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) bn_stats_kernel(Args a) {
  __shared__ Smem sh;
  const Geo t = geo(a);
  const T* x = static_cast<const T*>(a.x);
  const int C = a.C;
  const long long step = a.p.lanes;
  float n = 0.f, u[kVec], w[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) u[j] = w[j] = 0.f;
  if (t.lane_ok) {
    for (long long r = t.r0 + t.lane; r < t.r1; r += step * kUnroll) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        load_row<T, VEC>(x, r + k * step, C, t.c0,
                         t.live && r + k * step < t.r1, v[k]);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (r + k * step < t.r1) {
          n += 1.f;
          const float inv = 1.f / n;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float d = v[k][j] - u[j];
            u[j] += d * inv;
            w[j] += d * (v[k][j] - u[j]);
          }
        }
      }
    }
  }
  merge_lanes<true>(n, u, w, t, a.p, sh);
  if (publish<true>(a, t, n, u, w, sh)) {
    if (PARTIAL)
      write_partials(a, t, sh);
    else
      finish_stats(a, t, sh);
  }
}

// bn_finish: thread c of the grid merges channel c's D partials [D][3][S][C]
// (bn_partials' out of every rank, in rank order) by Chan's formula, as
// merge<true> does, then writes bn_stats' out for them.  The order is fixed,
// so every rank computes bit-identical statistics; with D = 1 the merge
// takes the partial as it is (n = 0 before it), and out is bn_stats' bit for
// bit.
__global__ void __launch_bounds__(128) bn_finish_kernel(
    const float* __restrict__ parts, int D, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ run_mean,
    const float* __restrict__ run_var, float* __restrict__ out, int S, int C,
    float mom, float omm, float eps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long SC = static_cast<long long>(S) * C;
  const float gam = gamma[c], bet = beta[c];
  const float rm = run_mean[c], rv = run_var[c];
  float acc_m = 0.f, acc_v = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long i = static_cast<long long>(s) * C + c;
    float n = 0.f, u = 0.f, w = 0.f;
    for (int d = 0; d < D; ++d) {
      const float* q = parts + 3 * SC * d;
      const float nb = q[i];
      if (nb == 0.f) continue;
      const float nt = n + nb;
      const float fb = nb / nt;
      const float cross = n * fb;
      const float dl = q[SC + i] - u;
      u += dl * fb;
      w += q[2 * SC + i] + dl * dl * cross;
      n = nt;
    }
    const float var = w / n;
    const float rstd = 1.f / sqrtf(var + eps);
    const float sa = rstd * gam;
    out[i] = u;
    out[SC + i] = rstd;
    out[2 * SC + i] = sa;
    out[3 * SC + i] = bet - u * sa;
    acc_m += mom * rm + omm * u;
    acc_v += mom * rv + omm * var;
  }
  out[4 * SC + c] = acc_m / S;
  out[4 * SC + C + c] = acc_v / S;
}

// Apply: y = act(x . a_s + b_s), a_s and b_s in registers across the band.
template <typename T, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) bn_apply_kernel(Args a) {
  const Geo t = geo(a);
  if (!t.live) return;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.out_t);
  const int C = a.C;
  const long long step = a.p.lanes;
  float ka[kVec], kb[kVec];
  bool first = true;
  for (long long r = t.r0 + t.lane; r < t.r1; r += step * kUnroll) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      load_row<T, VEC>(x, r + k * step, C, t.c0, r + k * step < t.r1, v[k]);
    if (first) {   // behind the first rows' loads
      channel_vals(a.a, t, C, ka);
      channel_vals(a.b, t, C, kb);
      first = false;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (r + k * step >= t.r1) continue;
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[k][j] = act_fn<ACT>(fmaf(v[k][j], ka[j], kb[j]));
      store_row<T, VEC>(y, r + k * step, C, t.c0, v[k]);
    }
  }
}

constexpr int kBwdUnroll = 2;    // three tensors in flight a row

// The thread's 8 channels of g, x and (but for act none) y in row r.
template <typename T, bool VEC, int ACT>
__device__ __forceinline__ void load_grad_row(const Args& a, const Geo& t,
                                              long long r, bool ok, float g[8],
                                              float x[8], float y[8]) {
  load_row<T, VEC>(static_cast<const T*>(a.g), r, a.C, t.c0, ok, g);
  load_row<T, VEC>(static_cast<const T*>(a.x), r, a.C, t.c0, ok, x);
  if (ACT != kNone)
    load_row<T, VEC>(static_cast<const T*>(a.y), r, a.C, t.c0, ok, y);
}

// In place: g <- ga = g . act'(y), x <- xhat = (x - mean) . rstd.
template <int ACT>
__device__ __forceinline__ void grad_xhat(float g[8], float x[8],
                                          const float y[8], const float mu[8],
                                          const float rs[8]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (ACT != kNone) g[j] *= act_grad<ACT>(y[j]);
    x[j] = (x[j] - mu[j]) * rs[j];
  }
}

// Backward reduce: out = sum(ga) [S, C], sum(ga . xhat) [S, C], then
// dgamma [C] and dbeta [C].
template <typename T, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) bn_reduce_kernel(Args a) {
  __shared__ Smem sh;
  const Geo t = geo(a);
  const int C = a.C;
  const long long SC = static_cast<long long>(a.S) * C;
  float mu[kVec], rs[kVec];
  float n = 0.f, u[kVec], w[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) u[j] = w[j] = 0.f;
  const long long step = a.p.lanes;
  if (t.lane_ok) {
    bool first = true;
    for (long long r = t.r0 + t.lane; r < t.r1; r += step * kBwdUnroll) {
      float ga[kBwdUnroll][kVec], xh[kBwdUnroll][kVec], yv[kBwdUnroll][kVec];
#pragma unroll
      for (int k = 0; k < kBwdUnroll; ++k)
        load_grad_row<T, VEC, ACT>(a, t, r + k * step,
                                   t.live && r + k * step < t.r1, ga[k], xh[k],
                                   yv[k]);
      if (first) {   // behind the first rows' loads
        channel_vals(a.mean, t, C, mu);
        channel_vals(a.rstd, t, C, rs);
        first = false;
      }
#pragma unroll
      for (int k = 0; k < kBwdUnroll; ++k) {
        grad_xhat<ACT>(ga[k], xh[k], yv[k], mu, rs);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {   // masked rows hold zeros
          u[j] += ga[k][j];
          w[j] += ga[k][j] * xh[k][j];
        }
      }
    }
  }
  merge_lanes<false>(n, u, w, t, a.p, sh);
  if (!publish<false>(a, t, n, u, w, sh)) return;

  float dg[kVec], db[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) dg[j] = db[j] = 0.f;
  for (int s = 0; s < a.S; ++s) {
    gather_stream<false>(a, t, s, sh, n, u, w);
    if (t.lane == 0 && t.live) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = t.c0 + j;
        if (c >= C) continue;
        const long long i = static_cast<long long>(s) * C + c;
        a.out[i] = u[j];
        a.out[SC + i] = w[j];
        db[j] += u[j];
        dg[j] += w[j];
      }
    }
  }
  if (t.lane == 0 && t.live) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = t.c0 + j;
      if (c >= C) continue;
      a.out[2 * SC + c] = dg[j];
      a.out[2 * SC + C + c] = db[j];
    }
  }
}

// Backward apply: dx = gamma . rstd_s . (ga - sum(ga)/R - xhat . sum(ga . xhat)/R).
template <typename T, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) bn_dx_kernel(Args a) {
  const Geo t = geo(a);
  if (!t.live) return;
  const int C = a.C;
  float mu[kVec], rs[kVec], k1[kVec], k2[kVec], k3[kVec];
  T* dx = static_cast<T*>(a.out_t);
  const long long step = a.p.lanes;
  bool first = true;
  for (long long r = t.r0 + t.lane; r < t.r1; r += step * kBwdUnroll) {
    float ga[kBwdUnroll][kVec], xh[kBwdUnroll][kVec], yv[kBwdUnroll][kVec];
#pragma unroll
    for (int k = 0; k < kBwdUnroll; ++k)
      load_grad_row<T, VEC, ACT>(a, t, r + k * step, r + k * step < t.r1,
                                 ga[k], xh[k], yv[k]);
    if (first) {   // behind the first rows' loads
      channel_vals(a.mean, t, C, mu);
      channel_vals(a.rstd, t, C, rs);
      channel_vals(a.sga, t, C, k2);
      channel_vals(a.sgx, t, C, k3);
      const float inv_r = 1.f / static_cast<float>(a.count);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = t.c0 + j;
        k1[j] = (c < C ? a.gamma[c] : 0.f) * rs[j];
        k2[j] *= inv_r;
        k3[j] *= inv_r;
      }
      first = false;
    }
#pragma unroll
    for (int k = 0; k < kBwdUnroll; ++k) {
      if (r + k * step >= t.r1) continue;
      grad_xhat<ACT>(ga[k], xh[k], yv[k], mu, rs);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        ga[k][j] = k1[j] * (ga[k][j] - k2[j] - xh[k][j] * k3[j]);
      store_row<T, VEC>(dx, r + k * step, C, t.c0, ga[k]);
    }
  }
}

// --- launch ------------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<element type>, vector path, activation) for the call's types.
template <typename F>
cudaError_t dispatch(bool bf16, bool vec, int act, F&& f) {
  auto types = [&](auto k) -> cudaError_t {
    if (bf16)
      return vec ? f(Tag<uint16_t>{}, std::true_type{}, k)
                 : f(Tag<uint16_t>{}, std::false_type{}, k);
    return vec ? f(Tag<float>{}, std::true_type{}, k)
               : f(Tag<float>{}, std::false_type{}, k);
  };
  switch (act) {
    case kRelu: return types(std::integral_constant<int, kRelu>{});
    case kLrelu: return types(std::integral_constant<int, kLrelu>{});
    case kTanh: return types(std::integral_constant<int, kTanh>{});
    default: return types(std::integral_constant<int, kNone>{});
  }
}

dim3 grid_of(const Plan& p, int S) {
  return dim3(static_cast<unsigned>(p.chunks),
              static_cast<unsigned>(S * p.bands));
}

// The common checks and the plan of a call over x ([S.R, C]) whose other
// full-size tensors are `p1`, `p2`, `p3` (nullptr where absent).
bool setup(Args& a, const void* x, const void* p1, const void* p2,
           const void* p3, long long rows, int S, int C, int sms) {
  if (S < 1 || C < 1 || rows < S || rows % S != 0 || sms < 1) return false;
  if (ceil_div(ceil_div(C, kVec), kTpr) > kMaxChunks) return false;
  const bool vec_ok = aligned16(x) && (!p1 || aligned16(p1)) &&
                      (!p2 || aligned16(p2)) && (!p3 || aligned16(p3));
  a.R = rows / S;
  a.S = S;
  a.C = C;
  a.p = make_plan(a.R, S, C, vec_ok, sms);
  return a.p.bands <= 65535 / S;
}

bool set_ws(Args& a, void* ws, long long ws_bytes) {
  if (ws_bytes < ws_bytes_needed(a.p, a.S) || !aligned16(ws)) return false;
  a.tickets = static_cast<unsigned*>(ws);
  a.part = reinterpret_cast<float*>(static_cast<char*>(ws) + 4LL * kMaxChunks);
  return true;
}

}  // namespace

// The plan of a call: out = {vec, groups, tpr, chunks, lanes, bands,
// band_rows, workspace bytes}.  x, p1, p2, p3 are the call's full-size
// tensors (nullptr where absent); returns 0, or 1 for arguments no launch
// takes.
extern "C" int t2i_bn_plan(const void* x, const void* p1, const void* p2,
                           const void* p3, long long rows, int S, int C,
                           int sms, long long* out) {
  Args a{};
  if (!setup(a, x, p1, p2, p3, rows, S, C, sms)) return 1;
  const long long v[8] = {a.p.vec, a.p.groups, a.p.tpr, a.p.chunks, a.p.lanes,
                          a.p.bands, a.p.band_rows, ws_bytes_needed(a.p, S)};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// Each entry point below launches one kernel on `stream` and returns the
// CUDA error code (0 when launched; cudaErrorInvalidValue for arguments the
// kernel does not take).

// out: mean [S, C], rstd [S, C], a [S, C], b [S, C], new mean [C], new var
// [C].
extern "C" int t2i_bn_stats(const void* x, const float* gamma,
                            const float* beta, const float* run_mean,
                            const float* run_var, float* out, void* ws,
                            long long ws_bytes, long long rows, int S, int C,
                            int bf16, float momentum, float one_minus_momentum,
                            float eps, int sms, void* stream) {
  Args a{};
  if (!setup(a, x, nullptr, nullptr, nullptr, rows, S, C, sms) ||
      !set_ws(a, ws, ws_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.gamma = gamma;
  a.beta = beta;
  a.run_mean = run_mean;
  a.run_var = run_var;
  a.out = out;
  a.mom = momentum;
  a.omm = one_minus_momentum;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.p, S);
  return static_cast<int>(dispatch(bf16 != 0, a.p.vec != 0, kNone,
                                   [&](auto t, auto v, auto) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_stats_kernel<T, decltype(v)::value, false><<<grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }));
}

// out: n [S, C], mean [S, C], M2 [S, C]: each stream's Welford state, for
// bn_finish to merge with other ranks' partials.
extern "C" int t2i_bn_partials(const void* x, float* out, void* ws,
                               long long ws_bytes, long long rows, int S,
                               int C, int bf16, int sms, void* stream) {
  Args a{};
  if (!setup(a, x, nullptr, nullptr, nullptr, rows, S, C, sms) ||
      !set_ws(a, ws, ws_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.p, S);
  return static_cast<int>(dispatch(bf16 != 0, a.p.vec != 0, kNone,
                                   [&](auto t, auto v, auto) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_stats_kernel<T, decltype(v)::value, true><<<grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }));
}

// out as bn_stats' from parts [D][3][S][C], D partials of bn_partials.
extern "C" int t2i_bn_finish(const float* parts, int D, const float* gamma,
                             const float* beta, const float* run_mean,
                             const float* run_var, float* out, int S, int C,
                             float momentum, float one_minus_momentum,
                             float eps, void* stream) {
  if (D < 1 || S < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(ceil_div(C, 128));
  bn_finish_kernel<<<blocks, 128, 0, st>>>(parts, D, gamma, beta, run_mean,
                                           run_var, out, S, C, momentum,
                                           one_minus_momentum, eps);
  return static_cast<int>(cudaGetLastError());
}

// y = act(x . a_s + b_s) with a, b f32 [S, C].
extern "C" int t2i_bn_act(const void* x, const float* sa, const float* sb,
                          void* y, long long rows, int S, int C, int act,
                          int bf16, int sms, void* stream) {
  Args a{};
  if (!setup(a, x, y, nullptr, nullptr, rows, S, C, sms))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.a = sa;
  a.b = sb;
  a.out_t = y;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.p, S);
  return static_cast<int>(dispatch(bf16 != 0, a.p.vec != 0, act,
                                   [&](auto t, auto v, auto k) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_apply_kernel<T, decltype(v)::value, decltype(k)::value>
        <<<grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }));
}

// out: sum(ga) [S, C], sum(ga . xhat) [S, C], dgamma [C], dbeta [C]; mean
// and rstd [S, C] are bn_stats'.  y may be nullptr for act none.
extern "C" int t2i_bn_bwd_reduce(const void* g, const void* y, const void* x,
                                 const float* mean, const float* rstd,
                                 float* out, void* ws,
                                 long long ws_bytes, long long rows, int S,
                                 int C, int act, int bf16, int sms,
                                 void* stream) {
  Args a{};
  if ((act != kNone && !y) ||
      !setup(a, x, g, act != kNone ? y : nullptr, nullptr, rows, S, C, sms) ||
      !set_ws(a, ws, ws_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.g = g;
  a.y = y;
  a.mean = mean;
  a.rstd = rstd;
  a.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.p, S);
  return static_cast<int>(dispatch(bf16 != 0, a.p.vec != 0, act,
                                   [&](auto t, auto v, auto k) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_reduce_kernel<T, decltype(v)::value, decltype(k)::value>
        <<<grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }));
}

// dx from g, y, x, gamma, bn_stats' mean and rstd, and bn_bwd_reduce's sums,
// which are over `count` rows a stream: rows / S on one device, the global
// rows of a stream when the sums were all-reduced over a batch group.
extern "C" int t2i_bn_bwd_apply(const void* g, const void* y, const void* x,
                                const float* mean, const float* rstd,
                                const float* gamma, const float* sga,
                                const float* sgx, void* dx, long long rows,
                                long long count, int S, int C, int act,
                                int bf16, int sms, void* stream) {
  Args a{};
  if ((act != kNone && !y) || count < 1 ||
      !setup(a, x, g, act != kNone ? y : nullptr, dx, rows, S, C, sms))
    return static_cast<int>(cudaErrorInvalidValue);
  a.count = count;
  a.x = x;
  a.g = g;
  a.y = y;
  a.mean = mean;
  a.rstd = rstd;
  a.gamma = gamma;
  a.sga = sga;
  a.sgx = sgx;
  a.out_t = dx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.p, S);
  return static_cast<int>(dispatch(bf16 != 0, a.p.vec != 0, act,
                                   [&](auto t, auto v, auto k) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_dx_kernel<T, decltype(v)::value, decltype(k)::value>
        <<<grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }));
}
