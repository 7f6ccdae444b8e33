// The 3x3 stride-1 SAME convolution on Hopper (sm_90a): its forward with
// bias and activation fused, its input gradient on the same kernel, and its
// weight gradient (ops/kernels/conv.py conv3x3_act, conv3x3_dx,
// conv3x3_dw).
//
// Replaces no Pallas kernel: the JAX package leaves these convolutions to
// lax.conv_general_dilated (text_to_image_tpu/ops/layers.py conv2d, C-PGGAN's
// blocks and head, StackGAN's residual blocks, join, encoder and RGB
// layers), and the port sent them to cuDNN through a permute, a pad copy, a
// separate bias add and a separate activation, three launches more a call,
// and the gradient penalty's double backward through the library twice.
//
//   y[b,i,j,n] = act(sum_{kh,kw,c} x[b, i+kh-1, j+kw-1, c] * w[kh,kw,c,n]
//                    + bias[n])
//
// Bound on the H100 SXM (bf16): 2*9*B*H*W*Cin*Co operations against the
// bytes of x, w and y.  The C-PGGAN 256 px critic's deep layers (16^2 to
// 4^2 maps at 512 channels) are bound by operations; its 256^2 and 128^2
// layers at 32-128 channels by bytes (x and y at 96 x 256^2 x 32 are 403 MB
// each, 0.12 ms of operations against 0.24 ms of bytes).
//
// taps_kernel (the forward and dx): one implicit GEMM, M = B*H*W pixels, N
// = output channels, K = 9 taps x the input's channels.  A tile is 128
// pixels (a part of one image row, whole rows or whole images: the maps
// whose tile is one TMA box); its A slice of tap (kh, kw) is one zero-filled
// box of x shifted by (kh-1, kw-1), so the SAME pads are the box's edges
// and no padded copy is made.  B is w as it lies, by TMA, for both: the
// forward reads HWIO [3][3][K][N] N-major (panels of 64 or 32 output
// channels x a K slice, `FWD`); dx reads the same [3][3][Cin][Co] K-major
// as [9][N][K] (dx = the conv of the cotangent with w flipped in (kh, kw)
// and its channels swapped, the flip read in the tap index).
// K slices of 64 channels (128-byte rows, 128-byte swizzle) or 32 where the
// input's channels are not a multiple of 64 (64-byte rows and swizzle).  A
// producer warp keeps a ring of stages full by TMA, each freed by an
// "empty" mbarrier that the two consumer warpgroups arrive on once their
// wgmma group of that stage is done (one group stays in flight); the
// parts of K of a tile run as one thread-block cluster (the tiny maps) and
// are added in rank order through distributed shared memory.  The epilogue
// adds the f32 bias, applies the activation in f32 and writes bf16 NHWC
// once.  Tiles 128 x BN, BN = 32, 64, 128, 256 (the Python plan,
// conv3x3_plan, picks BN and the parts).
//
// wt_kernel (dw): dw[9*Cin x Co] = sum over pixels of the tap-shifted x
// against g, row m = tap*Cin + ci (HWIO's own layout), in 64-pixel slices.
// A is M-major: each 32- or 64-channel panel of a tile's rows is one box of
// x shifted by that panel's tap (so a tile of 128 rows spans four taps at
// Cin 32), B is N-major panels of g; both by TMA, one producer warp.  The
// parts of K of a tile are summed in a cluster on chip (the wgrad.cuh
// engine's scheme: FastDiv-free per-slice pixels, cluster ranks added in
// order); a plan with more parts than a cluster holds (the 256^2 and 128^2
// maps, K up to 6.3 M pixels, at most a few hundred rows of dw) writes each
// cluster's f32 sum to a workspace that wt_sum_kernel adds in the order
// 0..groups-1.  No atomics: the same bits every launch.
//
// The kernels' names (namespace k3s1) match none of the kernel families
// that a trace's readers group by name.

#include "upconv_dx.cuh"

namespace k3s1 {

constexpr int BM = 128;                     // rows of a tile
constexpr int CONSUMERS = 256;              // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;     // + the producer warp
constexpr int MAX_PARTS = 8;                // the portable cluster size
constexpr int SLICE = 64;                   // dw: pixels of a K slice

// D[64 x 32] += A[64 x 16] * B[16 x 32]: TA / TB 1 where that operand is
// MN-major in shared memory
template <int TA, int TB>
struct Mma32 {
  __device__ static __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

// one k16 step of a warpgroup: TA / TB 1 where A / B is MN-major (A
// K-major and B N-major: the forward; both K-major: dx; both MN-major: dw)
template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 32)
    Mma32<TA, TB>::mma(d, a, b);
  else if constexpr (TB == 1)
    igemm90::Wgmma<BN, TA>::mma(d, a, b);
  else
    dx90::Mma<BN>::mma(d, a, b);
}

// a descriptor of 8-row groups of RB-byte rows in the RB-byte swizzle,
// `lbo` bytes between the MN-major operand's panels
template <int RB>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  if constexpr (RB == 128)
    return igemm90::make_desc(addr, lbo, 1024);
  else
    return (igemm90::make_desc(addr, lbo, 512) & ~(3ull << 62)) |
           (2ull << 62);
}

// B of a forward stage: N-major panels of PB output channels (64, or 32
// where the tile is 32 wide) x BK rows of K, panel bytes BK * PB * 2
template <int BN>
__host__ __device__ constexpr int b_panel() {
  return BN < 64 ? BN : 64;
}

// the descriptor of B's k16 step k: the forward's N-major panels (LBO the
// panel's bytes, the swizzle of PB-channel rows) or dx's K-major rows
template <int BN, int BK, bool FWD>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int k) {
  if constexpr (FWD) {
    constexpr int PB = b_panel<BN>();
    return desc<PB * 2>(addr + k * 16 * PB * 2, BK * PB * 2);
  } else {
    return desc<BK * 2>(addr, 16) + 2 * k;   // +32 bytes a k16 step
  }
}

__device__ __forceinline__ void store4(uint16_t* out, float4 s) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  *reinterpret_cast<uint2*>(out) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// The four f32 columns at `off` of this CTA's staged tile summed over the
// cluster's `csize` CTAs in rank order (every rank's loaded before the adds)
__device__ __forceinline__ float4 cluster_sum4(uint32_t base, const float* stg,
                                               int off, int csize) {
  if (csize == 1) return *reinterpret_cast<const float4*>(stg + off);
  float4 v[MAX_PARTS];
#pragma unroll
  for (int q = 0; q < MAX_PARTS; ++q)
    if (q < csize)
      v[q] = wgrad::ld_cluster4(base + off * 4, static_cast<uint32_t>(q));
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < MAX_PARTS; ++q)
    if (q < csize) {
      s.x += v[q].x;
      s.y += v[q].y;
      s.z += v[q].z;
      s.w += v[q].w;
    }
  return s;
}

// a warpgroup's 64 x BN accumulators into the staged f32 tile (rows of LD)
template <int BN>
__device__ __forceinline__ void stage_acc(float* stg, const float* acc) {
  constexpr int LD = BN + 4;
  const int tid = threadIdx.x;
  if (tid < CONSUMERS) {
    const int wg = tid >> 7, tid128 = tid & 127;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2)
      *reinterpret_cast<float2*>(
          stg + (wg * 64 + igemm90::acc_row(tid128, i)) * LD +
          igemm90::acc_col(tid128, i)) = make_float2(acc[i], acc[i + 1]);
  }
}

// ------------------------------------------------------------------ taps --
struct Params {
  const float* bias;   // [N] f32, or null
  void* y;             // [M][N] bf16
  int H, W, HW, M, N;
  int K;               // the input's channels
  int S;               // K slices of a tap
  int parts;           // parts of K, one cluster of them
  int n_col;           // column tiles
  int blocks;          // tiles x column tiles
  int act;
};

template <int BN, int BK>
struct Ring {
  static constexpr int RB = BK * 2;                  // bytes of a K row
  static constexpr int A_STAGE = BM * RB, B_STAGE = BN * RB;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int BLOCKS = BN == 256 ? 1 : 2;   // an SM holds
  static constexpr int BUDGET = BLOCKS == 1 ? 192 * 1024 : 96 * 1024;
  static constexpr int STAGES = BUDGET / STAGE < 8 ? BUDGET / STAGE : 8;
  static constexpr int LD = BN + 4;                  // staged f32 rows
  static constexpr int STAGED = BM * LD * 4;
  static constexpr int RING =
      STAGES * STAGE > STAGED ? STAGES * STAGE : STAGED;
  static constexpr int SMEM = RING + 1024;           // + hand alignment
  static_assert(STAGES >= 2, "two stages fit");
};

// A block computes the 128 x BN tile blockIdx.z * gridDim.y + blockIdx.y
// over part blockIdx.x of its 9 * S (tap, slice) items, in clusters of the
// tile's parts along x.  FWD: the forward (w N-major, tap t), else dx (w
// K-major, tap 8 - t).
template <int BN, int BK, bool FWD>
__global__ void __launch_bounds__(THREADS, Ring<BN, BK>::BLOCKS)
    taps_kernel(const Params p, const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap) {
  using R = Ring<BN, BK>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[R::STAGES];
  __shared__ __align__(8) unsigned long long empty[R::STAGES];
  const int u = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  if (u >= p.blocks) return;   // a whole cluster leaves together
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int row0 = u / p.n_col * BM, n0 = (u % p.n_col) * BN;
  const int b0 = row0 / p.HW, rem = row0 - b0 * p.HW, i0 = rem / p.W;
  const int j0 = rem - i0 * p.W;
  const int2 span = wgrad::part(blockIdx.x, p.parts, 9 * p.S);
  const int n_iter = span.y - span.x;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7, tid128 = tid & 127;

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % R::STAGES;
        if (it >= R::STAGES)
          igemm90::mbar_wait(igemm90::smem_u32(&empty[s]),
                             ((it / R::STAGES) + 1) & 1);
        const uint32_t st = ring + s * R::STAGE;
        const uint32_t bar = igemm90::smem_u32(&full[s]);
        const int item = span.x + it, tap = item / p.S;
        const int k0 = (item - tap * p.S) * BK, kh = tap / 3;
        igemm90::mbar_expect_tx(bar, R::STAGE);
        igemm90::tma_load_4d(st, &xmap, k0, j0 + tap - 3 * kh - 1,
                             i0 + kh - 1, b0, bar);
        if constexpr (FWD) {
          constexpr int PB = b_panel<BN>();
#pragma unroll
          for (int q = 0; q < BN / PB; ++q)
            igemm90::tma_load_2d(st + R::A_STAGE + q * BK * PB * 2, &wmap,
                                 n0 + q * PB, tap * p.K + k0, bar);
        } else {
          igemm90::tma_load_2d(st + R::A_STAGE, &wmap, k0,
                               (8 - tap) * p.N + n0, bar);
        }
      }
    }
  } else {
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % R::STAGES;
      igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (it / R::STAGES) & 1);
      const uint32_t st = ring + s * R::STAGE;
      const uint64_t ad = desc<R::RB>(st + wg * 64 * R::RB, 16);
      igemm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)   // A: +32 bytes a k16 step
        mma<BN, 0, FWD ? 1 : 0>(acc, ad + 2 * k,
                                b_desc<BN, BK, FWD>(st + R::A_STAGE, k));
      igemm90::wgmma_commit();
      // the group of item it-1 is done: its stage is free
      igemm90::wgmma_wait<1>();
      if (it > 0 && tid128 == 0)
        wgrad::mbar_arrive(igemm90::smem_u32(&empty[(it - 1) % R::STAGES]));
    }
    igemm90::wgmma_wait<0>();
  }
  __syncthreads();   // every stage consumed: the ring is free

  // the epilogue: the cluster's tiles added in rank order, + bias, act in
  // f32, one bf16 store of four columns a thread
  float* stg = reinterpret_cast<float*>(smem_raw + (ring - raw));
  stage_acc<BN>(stg, acc);
  __syncthreads();
  const int csize = p.parts;
  if (csize > 1) wgrad::cluster_sync();
  constexpr int LD = BN + 4, C4 = BN / 4;
  const int rank = csize > 1 ? static_cast<int>(blockIdx.x) : 0;
  const int r_lo = rank * BM / csize, r_hi = (rank + 1) * BM / csize;
  uint16_t* y = static_cast<uint16_t*>(p.y);
  for (int e = tid; e < (r_hi - r_lo) * C4; e += THREADS) {
    const int r = r_lo + e / C4, c = (e % C4) * 4;
    if (row0 + r >= p.M) continue;
    float4 s = cluster_sum4(ring, stg, r * LD + c, csize);
    if (p.bias != nullptr) {
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(p.bias + n0 + c));
      s.x += b4.x;
      s.y += b4.y;
      s.z += b4.z;
      s.w += b4.w;
    }
    s = make_float4(igemm::apply_act(s.x, p.act), igemm::apply_act(s.y, p.act),
                    igemm::apply_act(s.z, p.act), igemm::apply_act(s.w, p.act));
    store4(y + static_cast<long long>(row0 + r) * p.N + n0 + c, s);
  }
  // no CTA leaves while another still reads its shared memory
  if (csize > 1) wgrad::cluster_sync();
}

// x [B][H][W][C] with boxes of BK channels x `box` (pixels, rows, images)
inline cudaError_t image_map(CUtensorMap* map, const void* x, int B, int H,
                             int W, int C, int BK, const cuuint32_t* box) {
  const cuuint64_t d[4] = {static_cast<cuuint64_t>(C),
                           static_cast<cuuint64_t>(W),
                           static_cast<cuuint64_t>(H),
                           static_cast<cuuint64_t>(B)};
  const cuuint64_t s[3] = {d[0] * 2, d[0] * d[1] * 2, d[0] * d[1] * d[2] * 2};
  const cuuint32_t b[4] = {static_cast<cuuint32_t>(BK), box[0], box[1],
                           box[2]};
  return igemm90::encode_tiled(map, 4, x, d, s, b,
                               BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_64B);
}

// the weights of the forward, w [9 * K][N] N-major, in boxes of PB channels
// x BK rows; dx's, w [9 * N][K] K-major, in boxes of BK x BN rows
template <int BN, int BK, bool FWD>
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int K,
                              int N) {
  if constexpr (FWD) {
    constexpr int PB = b_panel<BN>();
    const cuuint64_t d[2] = {static_cast<cuuint64_t>(N),
                             static_cast<cuuint64_t>(9) * K};
    const cuuint64_t st[1] = {d[0] * 2};
    const cuuint32_t b[2] = {static_cast<cuuint32_t>(PB),
                             static_cast<cuuint32_t>(BK)};
    return igemm90::encode_tiled(map, 2, w, d, st, b,
                                 PB == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                          : CU_TENSOR_MAP_SWIZZLE_64B);
  } else {
    return dx90::w_map(map, w, N, K, BK, BN, 9);
  }
}

// (pixels, rows, images) of a box of `px` pixels of an H x W map: a part of
// one row, whole rows of one image, or whole images
inline void box_of(int H, int W, int px, cuuint32_t* box) {
  const int hw = H * W;
  box[0] = static_cast<cuuint32_t>(W < px ? W : px);
  box[1] = static_cast<cuuint32_t>(W >= px ? 1 : (px / W < H ? px / W : H));
  box[2] = static_cast<cuuint32_t>(hw < px ? px / hw : 1);
}

template <int BN, int BK, bool FWD>
cudaError_t launch_taps(const void* x, const void* w, const float* bias,
                        void* y, int B, int H, int W, int K, int N, int act,
                        int parts, cudaStream_t s) {
  using R = Ring<BN, BK>;
  auto kernel = taps_kernel<BN, BK, FWD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  Params p;
  p.bias = bias;
  p.y = y;
  p.H = H;
  p.W = W;
  p.HW = H * W;
  p.M = B * H * W;
  p.N = N;
  p.K = K;
  p.S = K / BK;
  p.parts = parts;
  p.n_col = N / BN;
  p.blocks = (p.M + BM - 1) / BM * p.n_col;
  p.act = act;
  if (parts > 9 * p.S) return cudaErrorInvalidValue;
  cuuint32_t box[3];
  box_of(H, W, BM, box);
  CUtensorMap xmap = {}, wmap = {};
  if ((err = image_map(&xmap, x, B, H, W, K, BK, box)) != cudaSuccess ||
      (err = weight_map<BN, BK, FWD>(&wmap, w, K, N)) != cudaSuccess)
    return err;
  const unsigned gy = p.blocks < 65535 ? p.blocks : 65535;
  const unsigned gz = (p.blocks + gy - 1) / gy;
  return launch_clustered(kernel, dim3(parts, gy, gz), THREADS, R::SMEM,
                          parts, s, p, xmap, wmap);
}

// ------------------------------------------------------------------ rows --
// The maps bound by bytes (W a multiple of 128, H even; N = 32 or 64: the
// C-PGGAN 256^2 and 128^2 layers), whose tiles hold too few items for the
// taps kernel to hide its loads and its epilogue: one persistent block an
// SM walks tiles of two image rows of a 128-pixel segment (256 pixels,
// warpgroup w row i0 + w), its producer warp running on into the next
// tile's loads while the consumers finish this one.  An item is one kernel
// row kh of one K slice: a patch of x, two rows of 130 pixels from (i0 + kh
// - 1, j0 - 1), and the weights of that row's three taps; tap kw of a
// warpgroup's 64-pixel half reads the patch from pixel kw on through a
// descriptor whose start is shifted by whole rows (the swizzle follows the
// address bits in both TMA and wgmma, as in upconv_dx.cuh's transposed
// kernel).  x crosses L2 -> SM 3 x 260 / 256 times a slice where the taps
// kernel took it 9 times.  The epilogue goes from the registers: + bias,
// act, two bf16 columns a store.
template <int BN, int BK>
struct Rows {
  static constexpr int RB = BK * 2;
  static constexpr int A_BOX = 2 * 130 * RB;
  static constexpr int A_STAGE = (A_BOX + 1023) / 1024 * 1024;
  static constexpr int B_TAP = BN * RB;
  static constexpr int STAGE = A_STAGE + 3 * B_TAP;
  static constexpr int BUDGET = 220 * 1024;
  static constexpr int STAGES = BUDGET / STAGE < 8 ? BUDGET / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static_assert(STAGES >= 2, "two stages fit");
};

template <int BN, int BK, bool FWD>
__global__ void __launch_bounds__(THREADS, 1)
    rows_kernel(const Params p, const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap) {
  using R = Rows<BN, BK>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[R::STAGES];
  __shared__ __align__(8) unsigned long long empty[R::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int segs = p.W / 128, pairs = p.H / 2, per = 3 * p.S;
  // tile t: (b, row pair, segment)
  auto origin = [&](int t) {
    const int b = t / (pairs * segs), rem = t - b * pairs * segs;
    return make_int3(rem % segs * 128, rem / segs * 2, b);
  };
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      int g = 0;   // items issued by this block
      for (int t = blockIdx.x; t < p.blocks; t += gridDim.x) {
        const int3 q = origin(t);
        for (int it = 0; it < per; ++it, ++g) {
          const int s = g % R::STAGES;
          if (g >= R::STAGES)
            igemm90::mbar_wait(igemm90::smem_u32(&empty[s]),
                               ((g / R::STAGES) + 1) & 1);
          const uint32_t st = ring + s * R::STAGE;
          const uint32_t bar = igemm90::smem_u32(&full[s]);
          const int kh = it / p.S, k0 = (it - kh * p.S) * BK;
          igemm90::mbar_expect_tx(bar, R::A_BOX + 3 * R::B_TAP);
          igemm90::tma_load_4d(st, &xmap, k0, q.x - 1, q.y + kh - 1, q.z,
                               bar);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const int tap = kh * 3 + kw;
            if constexpr (FWD)   // one panel: BN = N = PB
              igemm90::tma_load_2d(st + R::A_STAGE + kw * R::B_TAP, &wmap,
                                   0, tap * p.K + k0, bar);
            else
              igemm90::tma_load_2d(st + R::A_STAGE + kw * R::B_TAP, &wmap,
                                   k0, (8 - tap) * p.N, bar);
          }
        }
      }
    }
    return;
  }
  const int wg = tid >> 7, tid128 = tid & 127;
  uint16_t* y = static_cast<uint16_t*>(p.y);
  float acc[2][BN / 2];
  int g = 0;
  for (int t = blockIdx.x; t < p.blocks; t += gridDim.x) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
    for (int it = 0; it < per; ++it, ++g) {
      const int s = g % R::STAGES;
      igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (g / R::STAGES) & 1);
      const uint32_t st = ring + s * R::STAGE;
      igemm90::wgmma_fence();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t ad =
              desc<R::RB>(st + (wg * 130 + h * 64 + kw) * R::RB, 16);
#pragma unroll
          for (int k = 0; k < BK / 16; ++k)
            mma<BN, 0, FWD ? 1 : 0>(
                acc[h], ad + 2 * k,
                b_desc<BN, BK, FWD>(st + R::A_STAGE + kw * R::B_TAP, k));
        }
      }
      igemm90::wgmma_commit();
      igemm90::wgmma_wait<1>();
      // the previous item's stage is free, unless it ended the last tile
      // (freed there)
      if (it > 0 && tid128 == 0)
        wgrad::mbar_arrive(igemm90::smem_u32(&empty[(g - 1) % R::STAGES]));
    }
    igemm90::wgmma_wait<0>();
    if (tid128 == 0)
      wgrad::mbar_arrive(igemm90::smem_u32(&empty[(g - 1) % R::STAGES]));
    // the warpgroup's row, 128 pixels x BN from the registers
    const int3 q = origin(t);
    const long long row0 =
        (static_cast<long long>(q.z) * p.H + q.y + wg) * p.W + q.x;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int r = h * 64 + igemm90::acc_row(tid128, i);
        const int c = igemm90::acc_col(tid128, i);
        float v0 = acc[h][i], v1 = acc[h][i + 1];
        if (p.bias != nullptr) {
          v0 += __ldg(p.bias + c);
          v1 += __ldg(p.bias + c + 1);
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(
            igemm::apply_act(v0, p.act), igemm::apply_act(v1, p.act));
        *reinterpret_cast<__nv_bfloat162*>(y + (row0 + r) * p.N + c) = o;
      }
  }
}

// the maps the rows kernel takes: rows of 128-pixel segments, in pairs
inline bool row_pairs(int H, int W) { return W % 128 == 0 && H % 2 == 0; }

template <int BN, int BK, bool FWD>
cudaError_t launch_rows(const void* x, const void* w, const float* bias,
                        void* y, int B, int H, int W, int K, int N, int act,
                        cudaStream_t s) {
  using R = Rows<BN, BK>;
  auto kernel = rows_kernel<BN, BK, FWD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  if (!row_pairs(H, W)) return cudaErrorInvalidValue;
  Params p;
  p.bias = bias;
  p.y = y;
  p.H = H;
  p.W = W;
  p.HW = H * W;
  p.M = B * H * W;
  p.N = N;
  p.K = K;
  p.S = K / BK;
  p.parts = 1;
  p.n_col = 1;
  p.blocks = p.M / (2 * BM);   // tiles
  p.act = act;
  const cuuint32_t box[3] = {130, 2, 1};
  CUtensorMap xmap = {}, wmap = {};
  if ((err = image_map(&xmap, x, B, H, W, K, BK, box)) != cudaSuccess ||
      (err = weight_map<BN, BK, FWD>(&wmap, w, K, N)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int grid = p.blocks < sms ? p.blocks : sms;
  kernel<<<grid, THREADS, R::SMEM, s>>>(p, xmap, wmap);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- dw --
struct WtParams {
  void* dw;            // [9*Cin][Co] bf16 (HWIO)
  float* ws;           // [groups][9*Cin][Co] f32 where groups > 1
  int H, W, HW, Cin, Co, M;
  int slices;          // K slices of 64 pixels
  int parts, cluster;  // parts of K; of them `cluster` in one cluster
  int n_col;
};

template <int BN, int PA, int PB>
struct WtRing {
  static constexpr int A_STAGE = SLICE * BM * 2, B_STAGE = SLICE * BN * 2;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int BUDGET = 96 * 1024;           // two blocks an SM
  static constexpr int STAGES = BUDGET / STAGE < 8 ? BUDGET / STAGE : 8;
  static constexpr int LD = BN + 4;
  static constexpr int STAGED = BM * LD * 4;
  static constexpr int RING =
      STAGES * STAGE > STAGED ? STAGES * STAGE : STAGED;
  static constexpr int SMEM = RING + 1024;
  static constexpr int A_PANEL = SLICE * PA * 2, B_PANEL = SLICE * PB * 2;
  static_assert(STAGES >= 2, "two stages fit");
};

// A block computes the 128 x BN tile blockIdx.y of dw's [9*Cin x Co] over
// part blockIdx.z * cluster + blockIdx.x of the slices, the cluster's
// parts along x.
template <int BN, int PA, int PB>
__global__ void __launch_bounds__(THREADS, 2)
    wt_kernel(const WtParams p, const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap gmap) {
  using R = WtRing<BN, PA, PB>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[R::STAGES];
  __shared__ __align__(8) unsigned long long empty[R::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int m0 = static_cast<int>(blockIdx.y) / p.n_col * BM;
  const int n0 = (static_cast<int>(blockIdx.y) % p.n_col) * BN;
  const int part = static_cast<int>(blockIdx.z) * p.cluster +
                   static_cast<int>(blockIdx.x);
  const int2 span = wgrad::part(part, p.parts, p.slices);
  const int n_iter = span.y - span.x;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7, tid128 = tid & 127;

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      // each A panel's tap and first channel (rows past dw read the last
      // panel again; the epilogue drops them)
      int pdh[BM / PA], pdw[BM / PA], pci[BM / PA];
#pragma unroll
      for (int q = 0; q < BM / PA; ++q) {
        const int m = min(m0 + q * PA, p.M - PA), tap = m / p.Cin;
        pdh[q] = tap / 3 - 1;
        pdw[q] = tap % 3 - 1;
        pci[q] = m - tap * p.Cin;
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % R::STAGES;
        if (it >= R::STAGES)
          igemm90::mbar_wait(igemm90::smem_u32(&empty[s]),
                             ((it / R::STAGES) + 1) & 1);
        const uint32_t st = ring + s * R::STAGE;
        const uint32_t bar = igemm90::smem_u32(&full[s]);
        const int k = (span.x + it) * SLICE;
        const int b = k / p.HW, rem = k - b * p.HW, i = rem / p.W;
        const int j = rem - i * p.W;
        igemm90::mbar_expect_tx(bar, R::STAGE);
#pragma unroll
        for (int q = 0; q < BM / PA; ++q)
          igemm90::tma_load_4d(st + q * R::A_PANEL, &xmap, pci[q],
                               j + pdw[q], i + pdh[q], b, bar);
#pragma unroll
        for (int q = 0; q < BN / PB; ++q)
          igemm90::tma_load_4d(st + R::A_STAGE + q * R::B_PANEL, &gmap,
                               n0 + q * PB, j, i, b, bar);
      }
    }
  } else {
    // the warpgroup's 64 rows: 64 / PA panels from byte 64 * 128 * wg
    constexpr int STEP = 16 * PA * 2, BSTEP = 16 * PB * 2;   // a k16 step
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % R::STAGES;
      igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (it / R::STAGES) & 1);
      const uint32_t st = ring + s * R::STAGE;
      igemm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < SLICE / 16; ++k)
        mma<BN, 1, 1>(
            acc, desc<PA * 2>(st + wg * 64 * 128 + k * STEP, R::A_PANEL),
            desc<PB * 2>(st + R::A_STAGE + k * BSTEP, R::B_PANEL));
      igemm90::wgmma_commit();
      igemm90::wgmma_wait<1>();
      if (it > 0 && tid128 == 0)
        wgrad::mbar_arrive(igemm90::smem_u32(&empty[(it - 1) % R::STAGES]));
    }
    igemm90::wgmma_wait<0>();
  }
  __syncthreads();

  float* stg = reinterpret_cast<float*>(smem_raw + (ring - raw));
  stage_acc<BN>(stg, acc);
  __syncthreads();
  const int csize = p.cluster;
  if (csize > 1) wgrad::cluster_sync();
  constexpr int LD = BN + 4, C4 = BN / 4;
  const int rank = csize > 1 ? static_cast<int>(blockIdx.x) : 0;
  const int r_lo = rank * BM / csize, r_hi = (rank + 1) * BM / csize;
  const bool direct = p.parts == p.cluster;
  for (int e = tid; e < (r_hi - r_lo) * C4; e += THREADS) {
    const int r = r_lo + e / C4, c = (e % C4) * 4;
    if (m0 + r >= p.M) continue;
    const float4 s = cluster_sum4(ring, stg, r * LD + c, csize);
    const long long at = static_cast<long long>(m0 + r) * p.Co + n0 + c;
    if (direct)
      store4(static_cast<uint16_t*>(p.dw) + at, s);
    else
      *reinterpret_cast<float4*>(
          p.ws + static_cast<long long>(blockIdx.z) * p.M * p.Co + at) = s;
  }
  if (csize > 1) wgrad::cluster_sync();
}

// dw = the groups' f32 sums added in the order 0..groups-1, rounded once
__global__ void __launch_bounds__(256)
    wt_sum_kernel(const float* ws, uint16_t* dw, int groups, long long n) {
  const long long e = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (e >= n) return;
  float4 s = *reinterpret_cast<const float4*>(ws + e);
  for (int g = 1; g < groups; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(ws + g * n + e);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  store4(dw + e, s);
}

template <int BN, int PA, int PB>
cudaError_t launch_wt(const void* x, const void* g, void* dw, float* ws,
                      int B, int H, int W, int Cin, int Co, int cluster,
                      int groups, cudaStream_t s) {
  using R = WtRing<BN, PA, PB>;
  auto kernel = wt_kernel<BN, PA, PB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  WtParams p;
  p.dw = dw;
  p.ws = ws;
  p.H = H;
  p.W = W;
  p.HW = H * W;
  p.Cin = Cin;
  p.Co = Co;
  p.M = 9 * Cin;
  p.slices = static_cast<int>((static_cast<long long>(B) * H * W + SLICE - 1) /
                              SLICE);
  p.parts = cluster * groups;
  p.cluster = cluster;
  p.n_col = Co / BN;
  if (p.parts > p.slices) return cudaErrorInvalidValue;
  cuuint32_t box[3];
  box_of(H, W, SLICE, box);
  CUtensorMap xmap = {}, gmap = {};
  if ((err = image_map(&xmap, x, B, H, W, Cin, PA, box)) != cudaSuccess ||
      (err = image_map(&gmap, g, B, H, W, Co, PB, box)) != cudaSuccess)
    return err;
  const unsigned tiles = (p.M + BM - 1) / BM * p.n_col;
  err = launch_clustered(kernel, dim3(cluster, tiles, groups), THREADS,
                         R::SMEM, cluster, s, p, xmap, gmap);
  if (err != cudaSuccess || groups == 1) return err;
  const long long n = static_cast<long long>(p.M) * Co;
  wt_sum_kernel<<<static_cast<unsigned>((n / 4 + 255) / 256), 256, 0, s>>>(
      ws, static_cast<uint16_t*>(dw), groups, n);
  return cudaGetLastError();
}

// The dw of the maps of 64-pixel row segments at Cin and Co multiples of
// 64 (the C-PGGAN 128^2 and 64^2 layers), where wt_kernel's 128 x BN tiles
// read 64 bytes from L2 a product pair: a block's tile is one kernel row
// kh of a 64-channel chunk of x, its three taps' 192 rows of dw (warpgroup
// kw the tap's 64), against BN columns.  A slice's A is one patch of x,
// 66 pixels (j - 1 .. j + 64) of row i + kh - 1, that the three
// warpgroups read from pixel kw on (a start shifted by whole rows, the
// swizzle by address bits); its B the slice of g.  L2 -> SM bytes a
// product pair fall to 33 (BN 128).  One block an SM.
constexpr int WROW_THREADS = 3 * 128 + 32;

template <int BN>
struct WRow {
  static constexpr int A_BOX = 66 * 128;
  static constexpr int A_STAGE = (A_BOX + 1023) / 1024 * 1024;
  static constexpr int B_PANEL = SLICE * 128, B_STAGE = SLICE * BN * 2;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int BUDGET = 200 * 1024;
  static constexpr int STAGES = BUDGET / STAGE < 8 ? BUDGET / STAGE : 8;
  static constexpr int LD = BN + 4;
  static constexpr int STAGED = 192 * LD * 4;
  static constexpr int RING =
      STAGES * STAGE > STAGED ? STAGES * STAGE : STAGED;
  static constexpr int SMEM = RING + 1024;
  static_assert(STAGES >= 2, "two stages fit");
};

template <int BN>
__global__ void __launch_bounds__(WROW_THREADS, 1)
    wrow_kernel(const WtParams p, const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap gmap) {
  using R = WRow<BN>;
  constexpr int CONS = 3 * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[R::STAGES];
  __shared__ __align__(8) unsigned long long empty[R::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int u = static_cast<int>(blockIdx.y), chunks = p.Cin / 64;
  const int n0 = (u % p.n_col) * BN, c0 = (u / p.n_col) % chunks * 64;
  const int kh = u / (p.n_col * chunks);
  const int part = static_cast<int>(blockIdx.z) * p.cluster +
                   static_cast<int>(blockIdx.x);
  const int2 span = wgrad::part(part, p.parts, p.slices);
  const int n_iter = span.y - span.x;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), 3);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7, tid128 = tid & 127;

  if (tid >= CONS) {
    if (tid == CONS) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % R::STAGES;
        if (it >= R::STAGES)
          igemm90::mbar_wait(igemm90::smem_u32(&empty[s]),
                             ((it / R::STAGES) + 1) & 1);
        const uint32_t st = ring + s * R::STAGE;
        const uint32_t bar = igemm90::smem_u32(&full[s]);
        const int k = (span.x + it) * SLICE;
        const int b = k / p.HW, rem = k - b * p.HW, i = rem / p.W;
        const int j = rem - i * p.W;
        igemm90::mbar_expect_tx(bar, R::A_BOX + R::B_STAGE);
        igemm90::tma_load_4d(st, &xmap, c0, j - 1, i + kh - 1, b, bar);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          igemm90::tma_load_4d(st + R::A_STAGE + q * R::B_PANEL, &gmap,
                               n0 + q * 64, j, i, b, bar);
      }
    }
  } else {
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % R::STAGES;
      igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (it / R::STAGES) & 1);
      const uint32_t st = ring + s * R::STAGE;
      igemm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < SLICE / 16; ++k)
        mma<BN, 1, 1>(acc, desc<128>(st + (wg + 16 * k) * 128, R::B_PANEL),
                      desc<128>(st + R::A_STAGE + k * 2048, R::B_PANEL));
      igemm90::wgmma_commit();
      igemm90::wgmma_wait<1>();
      if (it > 0 && tid128 == 0)
        wgrad::mbar_arrive(igemm90::smem_u32(&empty[(it - 1) % R::STAGES]));
    }
    igemm90::wgmma_wait<0>();
  }
  __syncthreads();

  // 192 rows staged: row wg * 64 + r is tap (kh, wg), channel c0 + r
  constexpr int LD = BN + 4, C4 = BN / 4;
  float* stg = reinterpret_cast<float*>(smem_raw + (ring - raw));
  if (tid < CONS) {
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2)
      *reinterpret_cast<float2*>(
          stg + (wg * 64 + igemm90::acc_row(tid128, i)) * LD +
          igemm90::acc_col(tid128, i)) = make_float2(acc[i], acc[i + 1]);
  }
  __syncthreads();
  const int csize = p.cluster;
  if (csize > 1) wgrad::cluster_sync();
  const int rank = csize > 1 ? static_cast<int>(blockIdx.x) : 0;
  const int r_lo = rank * 192 / csize, r_hi = (rank + 1) * 192 / csize;
  const bool direct = p.parts == p.cluster;
  for (int e = tid; e < (r_hi - r_lo) * C4; e += WROW_THREADS) {
    const int r = r_lo + e / C4, c = (e % C4) * 4;
    const float4 sum = cluster_sum4(ring, stg, r * LD + c, csize);
    const int m = (kh * 3 + r / 64) * p.Cin + c0 + r % 64;
    const long long at = static_cast<long long>(m) * p.Co + n0 + c;
    if (direct)
      store4(static_cast<uint16_t*>(p.dw) + at, sum);
    else
      *reinterpret_cast<float4*>(
          p.ws + static_cast<long long>(blockIdx.z) * p.M * p.Co + at) = sum;
  }
  if (csize > 1) wgrad::cluster_sync();
}

template <int BN>
cudaError_t launch_wrow(const void* x, const void* g, void* dw, float* ws,
                        int B, int H, int W, int Cin, int Co, int cluster,
                        int groups, cudaStream_t s) {
  using R = WRow<BN>;
  auto kernel = wrow_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  if (W % SLICE || Cin % 64 || Co % BN) return cudaErrorInvalidValue;
  WtParams p;
  p.dw = dw;
  p.ws = ws;
  p.H = H;
  p.W = W;
  p.HW = H * W;
  p.Cin = Cin;
  p.Co = Co;
  p.M = 9 * Cin;
  p.slices = static_cast<int>(static_cast<long long>(B) * H * W / SLICE);
  p.parts = cluster * groups;
  p.cluster = cluster;
  p.n_col = Co / BN;
  if (p.parts > p.slices) return cudaErrorInvalidValue;
  const cuuint32_t xbox[3] = {66, 1, 1};
  cuuint32_t gbox[3];
  box_of(H, W, SLICE, gbox);
  CUtensorMap xmap = {}, gmap = {};
  if ((err = image_map(&xmap, x, B, H, W, Cin, 64, xbox)) != cudaSuccess ||
      (err = image_map(&gmap, g, B, H, W, Co, 64, gbox)) != cudaSuccess)
    return err;
  const unsigned tiles = 3 * (Cin / 64) * p.n_col;
  err = launch_clustered(kernel, dim3(cluster, tiles, groups), WROW_THREADS,
                         R::SMEM, cluster, s, p, xmap, gmap);
  if (err != cudaSuccess || groups == 1) return err;
  const long long n = static_cast<long long>(p.M) * Co;
  wt_sum_kernel<<<static_cast<unsigned>((n / 4 + 255) / 256), 256, 0, s>>>(
      ws, static_cast<uint16_t*>(dw), groups, n);
  return cudaGetLastError();
}

// ----------------------------------------------------------- act grad --
// The cotangent of the conv's pre-activation and the bias gradient, from
// the output y = act(p) and its cotangent g (bf16 [M][C], C a multiple of
// 8): gc = bf16((g + add) * act'(y)) and partial[blk][c] = the f32 sum of
// those products over the block's rows, which the launch's last block (the
// one that takes `count` to gridDim.x) adds over the blocks in a fixed
// order into db, then sets `count` back to 0: one launch, the same bits
// whichever block ends last.  One pass over g and y where the composition
// took four (the comparison, the slope, the select, the sum).  `add` (f32
// [C], or null) is the broadcast bias cotangent of the double backward;
// `partial` null skips the sums.  act' is 1 or 0.2 (lrelu, y >= 0 or not)
// or 1 or 0 (relu, y > 0 or not).
constexpr int AG_THREADS = 256;

template <int ACT>
__device__ __forceinline__ float act_slope(float y) {
  if constexpr (ACT == igemm::kLrelu)
    return y >= 0.f ? 1.f : 0.2f;
  else
    return y > 0.f ? 1.f : 0.f;
}

template <int ACT>
__global__ void __launch_bounds__(AG_THREADS)
    act_grad_kernel(const uint16_t* g, const uint16_t* y, const float* add,
                    uint16_t* gc, float* partial, float* db, unsigned* count,
                    long long M, int C, long long rows_per_block) {
  __shared__ __align__(16) float red[AG_THREADS * 8];
  __shared__ bool last;
  const int V = C / 8, step = AG_THREADS / V, tid = threadIdx.x;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (tid < step * V) {
    const int v = tid % V;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (add != nullptr)
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = add[v * 8 + i];
    const long long r0 = blockIdx.x * rows_per_block;
    const long long r1 = r0 + rows_per_block < M ? r0 + rows_per_block : M;
    for (long long r = r0 + tid / V; r < r1; r += step) {
      const long long o = r * C + v * 8;
      const uint4 gv = *reinterpret_cast<const uint4*>(g + o);
      const uint4 yv = *reinterpret_cast<const uint4*>(y + o);
      const uint16_t* ge = reinterpret_cast<const uint16_t*>(&gv);
      const uint16_t* ye = reinterpret_cast<const uint16_t*>(&yv);
      uint4 out;
      uint16_t* oe = reinterpret_cast<uint16_t*>(&out);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float f = (igemm::to_float(ge[i]) + a[i]) *
                        act_slope<ACT>(igemm::to_float(ye[i]));
        s[i] += f;
        oe[i] = __bfloat16_as_ushort(__float2bfloat16(f));
      }
      *reinterpret_cast<uint4*>(gc + o) = out;
    }
  }
  if (partial == nullptr) return;
  // the block's sums: thread k*V + v holds rows k, k + step, ... of vector
  // v; added in the order k = 0..step-1
#pragma unroll
  for (int i = 0; i < 8; ++i) red[tid * 8 + i] = s[i];
  __syncthreads();
  for (int c = tid; c < C; c += AG_THREADS) {
    float t = 0.f;
    for (int k = 0; k < step; ++k) t += red[(k * V + c / 8) * 8 + c % 8];
    partial[static_cast<long long>(blockIdx.x) * C + c] = t;
  }
  __threadfence();   // the partials reach L2 before the count says so
  __syncthreads();
  if (tid == 0) last = atomicAdd(count, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: db = the n blocks' partials, four channels a column;
  // each column's blocks in G groups of consecutive blocks (every thread
  // busy), each group added in order, then the groups in order
  const int n = static_cast<int>(gridDim.x), V4 = C / 4;
  const int G = V4 < AG_THREADS ? AG_THREADS / V4 : 1;
  for (int e = tid; e < G * V4; e += AG_THREADS) {
    const int v = e % V4, k = e / V4;
    const int b0 = static_cast<int>(static_cast<long long>(k) * n / G);
    const int b1 = static_cast<int>(static_cast<long long>(k + 1) * n / G);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int b = b0; b < b1; ++b) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(
                                  partial + static_cast<long long>(b) * C) +
                              v);
      t.x += q.x;
      t.y += q.y;
      t.z += q.z;
      t.w += q.w;
    }
    *reinterpret_cast<float4*>(G == 1 ? db + 4 * v : red + 4 * e) = t;
  }
  if (G > 1) {
    __syncthreads();
    for (int c = tid; c < C; c += AG_THREADS) {
      float t = 0.f;
      for (int k = 0; k < G; ++k) t += red[4 * k * V4 + c];
      db[c] = t;
    }
  }
  if (tid == 0) *count = 0u;   // ready for the stream's next launch
}

// ---------------------------------------------------------------- route --
// a tile of 128 pixels and a dw slice of 64 are each one TMA box
inline bool maps(int H, int W) {
  return H > 0 && W > 0 && dx90::boxes(H, W) && wgrad::boxes(H, W);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace k3s1

// The route of conv3x3_act for these pointers and shapes: 1 the kernels
// (bf16, Cin and Co multiples of 32, a map whose tiles are TMA boxes,
// 16-byte-aligned tensors, int32 extents), 0 the caller's library route.
extern "C" int t2i_conv3x3_path(const void* x, const void* w, const void* y,
                                int B, int H, int W, int Cin, int Co,
                                int bf16) {
  const long long m = static_cast<long long>(B) * H * W;
  return bf16 && Cin % 32 == 0 && Co % 32 == 0 && Cin > 0 && Co > 0 &&
                 k3s1::maps(H, W) && m * (Cin > Co ? Cin : Co) < (1ll << 31) &&
                 k3s1::aligned16(x) && k3s1::aligned16(w) &&
                 k3s1::aligned16(y)
             ? 1
             : 0;
}

// y [B][H][W][N] = act(conv3x3(x, .) + bias) for x [B][H][W][K] (bf16) and
// the weights as they lie (bf16): where `flip` is 0 the forward's w
// [3][3][K][N], else dx's, w [3][3][N][K] flipped in (kh, kw) and read
// with its channels swapped; bias f32 [N] or null, on `stream`: `kernel` 0
// the taps kernel, tiles of 128 pixels x
// `tile_n` (32, 64, 128, 256; dividing N) and `parts` (1..8) parts of K in
// one cluster; 1 the rows kernel (W a multiple of 128, H even, tile_n = N
// = 32 or 64, one part).  Returns the CUDA error code (0 when launched).
extern "C" int t2i_conv3x3(const void* x, const void* wk, const float* bias,
                           void* y, int B, int H, int W, int K, int N,
                           int act, int flip, int tile_n, int parts,
                           int kernel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!t2i_conv3x3_path(x, wk, y, B, H, W, K, N, 1) || B < 1 ||
      (bias != nullptr && !k3s1::aligned16(bias)) || parts < 1 ||
      parts > k3s1::MAX_PARTS || tile_n < 32 || N % tile_n)
    return cudaErrorInvalidValue;
  const bool k64 = K % 64 == 0;
  if (kernel == 1) {
    if (parts != 1 || tile_n != N || (N != 32 && N != 64) ||
        !k3s1::row_pairs(H, W))
      return cudaErrorInvalidValue;
#define K3_ROWS_BK(BN, BK)                                                 \
  (flip ? k3s1::launch_rows<BN, BK, false>(x, wk, bias, y, B, H, W, K, N,   \
                                           act, s)                         \
        : k3s1::launch_rows<BN, BK, true>(x, wk, bias, y, B, H, W, K, N,    \
                                          act, s))
#define K3_ROWS(BN) \
  return static_cast<int>(k64 ? K3_ROWS_BK(BN, 64) : K3_ROWS_BK(BN, 32))
    if (N == 32) K3_ROWS(32);
    K3_ROWS(64);
#undef K3_ROWS
#undef K3_ROWS_BK
  }
  if (kernel != 0) return cudaErrorInvalidValue;
#define K3_TAPS_BK(BN, BK)                                                 \
  (flip ? k3s1::launch_taps<BN, BK, false>(x, wk, bias, y, B, H, W, K, N,   \
                                           act, parts, s)                  \
        : k3s1::launch_taps<BN, BK, true>(x, wk, bias, y, B, H, W, K, N,    \
                                          act, parts, s))
#define K3_TAPS(BN) \
  return static_cast<int>(k64 ? K3_TAPS_BK(BN, 64) : K3_TAPS_BK(BN, 32))
  switch (tile_n) {
    case 32: K3_TAPS(32);
    case 64: K3_TAPS(64);
    case 128: K3_TAPS(128);
    case 256: K3_TAPS(256);
    default: return cudaErrorInvalidValue;
  }
#undef K3_TAPS
#undef K3_TAPS_BK
}

// dw [3][3][Cin][Co] (bf16) of conv3x3 over x [B][H][W][Cin] for the
// cotangent g [B][H][W][Co] (bf16), on `stream`: `kernel` 0 wt_kernel,
// tiles of 128 rows of dw x `tile_n` (32, 64, 128; dividing Co) columns;
// 1 wrow_kernel (W, Cin and Co multiples of 64; tile_n 64 or 128), tiles
// of a kernel row's 192 rows; `cluster` (1, 2, 4, 8) parts of K summed on
// chip times `groups` such clusters summed through the workspace ws (f32,
// groups x 9*Cin x Co; null where groups is 1).
extern "C" int t2i_conv3x3_dw(const void* x, const void* g, void* dw,
                              float* ws, int B, int H, int W, int Cin,
                              int Co, int tile_n, int cluster, int groups,
                              int kernel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!t2i_conv3x3_path(x, dw, g, B, H, W, Cin, Co, 1) || B < 1 ||
      cluster < 1 || cluster > k3s1::MAX_PARTS || groups < 1 ||
      (groups > 1 && ws == nullptr) || Co % tile_n ||
      (tile_n == 32) != (Co % 64 != 0))
    return cudaErrorInvalidValue;
  if (kernel == 1) {
    if (tile_n == 64)
      return static_cast<int>(k3s1::launch_wrow<64>(
          x, g, dw, ws, B, H, W, Cin, Co, cluster, groups, s));
    if (tile_n == 128)
      return static_cast<int>(k3s1::launch_wrow<128>(
          x, g, dw, ws, B, H, W, Cin, Co, cluster, groups, s));
    return cudaErrorInvalidValue;
  }
  if (kernel != 0) return cudaErrorInvalidValue;
  const bool a64 = Cin % 64 == 0;
  switch (tile_n) {
    case 32:
      return static_cast<int>(
          a64 ? k3s1::launch_wt<32, 64, 32>(x, g, dw, ws, B, H, W, Cin, Co,
                                            cluster, groups, s)
              : k3s1::launch_wt<32, 32, 32>(x, g, dw, ws, B, H, W, Cin, Co,
                                            cluster, groups, s));
    case 64:
      return static_cast<int>(
          a64 ? k3s1::launch_wt<64, 64, 64>(x, g, dw, ws, B, H, W, Cin, Co,
                                            cluster, groups, s)
              : k3s1::launch_wt<64, 32, 64>(x, g, dw, ws, B, H, W, Cin, Co,
                                            cluster, groups, s));
    case 128:
      return static_cast<int>(
          a64 ? k3s1::launch_wt<128, 64, 64>(x, g, dw, ws, B, H, W, Cin, Co,
                                             cluster, groups, s)
              : k3s1::launch_wt<128, 32, 64>(x, g, dw, ws, B, H, W, Cin, Co,
                                             cluster, groups, s));
    default:
      return cudaErrorInvalidValue;
  }
}

// gc [M][C] = bf16((g + add) * act'(y)) (bf16 g, y, gc; add f32 [C] or
// null) for act lrelu or relu, and, where db is not null, db[C] = the f32
// sum of those products over the rows (partial: f32 [blocks][C] scratch,
// blocks = ceil(M / rows); count: one unsigned int, 0 between launches, of
// this stream alone), on `stream`, in one launch; `rows` a block (a
// multiple of 2048 / C, conv.py act_grad_rows).  C a multiple of 8 up to
// 2048, 16-byte-aligned g, y and gc.
extern "C" int t2i_act_grad(const void* g, const void* y, const float* add,
                            void* gc, float* partial, float* db,
                            unsigned* count, long long M, int C,
                            long long rows, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 || C < 8 || C > 2048 || M < 1 || !k3s1::aligned16(g) ||
      !k3s1::aligned16(y) || !k3s1::aligned16(gc) ||
      (db != nullptr && (partial == nullptr || count == nullptr)) ||
      rows < 1 || rows % (k3s1::AG_THREADS / (C / 8)) ||
      (act != igemm::kLrelu && act != igemm::kRelu))
    return cudaErrorInvalidValue;
  const long long n_blocks = (M + rows - 1) / rows;
  if (n_blocks > 2147483647ll) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(n_blocks);
  float* part = db != nullptr ? partial : nullptr;
  const uint16_t* gp = static_cast<const uint16_t*>(g);
  const uint16_t* yp = static_cast<const uint16_t*>(y);
  uint16_t* op = static_cast<uint16_t*>(gc);
  if (act == igemm::kLrelu)
    k3s1::act_grad_kernel<igemm::kLrelu><<<blocks, k3s1::AG_THREADS, 0, s>>>(
        gp, yp, add, op, part, db, count, M, C, rows);
  else
    k3s1::act_grad_kernel<igemm::kRelu><<<blocks, k3s1::AG_THREADS, 0, s>>>(
        gp, yp, add, op, part, db, count, M, C, rows);
  return static_cast<int>(cudaGetLastError());
}
