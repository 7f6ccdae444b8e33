// upconv3x3's forward on Hopper (sm_90a) where Co is a multiple of 32 but
// not of 64, included by upconv3x3.cu: C-PGGAN 256 px's last up-block,
// x [32,128,128,64] -> y [32,256,256,32] with lrelu, and any bf16 call with
// Cin 64, Co % 64 == 32 on maps of 128-pixel row segments.
//
//   y[b, 2m+py, 2n+px, :] = act(scale * sum_{a,c} x~[b, m+py+a-1,
//                               n+px+c-1, :] . wc[py,px,a,c] + shift)
//
// Replaces the mma.sync tile of igemm.cuh that this call ran on before (the
// `pipelined` path: igemm90's wgmma GEMM takes N % 64 == 0 only), and with
// it text_to_image_tpu/ops/pallas/conv.py _upconv_halo_pallas, whose thin
// channels the TPU padded to the lane width.
//
// Bound on the H100 SXM (bf16, B 32, 128^2 x 64 -> 32): x 67.1 MB + y
// 134.2 MB + wc 65.5 KB at 3.35 TB/s, 0.0601 ms, against 34.4 GFLOP at 989
// TFLOP/s, 0.0348 ms: bound by bytes, mostly by writing y.  What held the
// mma.sync tile at 18x that bound: each parity's four taps gathered from x
// by cp.async (A across L2 -> SM about 16 times a pass), 64-byte pixel
// halves stored at every second pixel of y (no block wrote whole lines),
// warp tiles that lost half their N at Co 32.
//
// Design:
//  * A tile is one input row of a 128-pixel segment: the 16 (parity, tap)
//    products of its 128 pixels x 32 channels of y's four parities.  Two
//    consumer warpgroups take 64 pixels each; a producer warp keeps a ring
//    of SLOTS staged rows full by TMA: input row r, pixels j0-1 .. j0+128
//    (130 x 64 channels, 128-byte swizzle; the map's zero fill gives the
//    rows and columns that fall off it).  A block walks consecutive rows of
//    a segment, so tile i reads rows i-1, i, i+1 and loads only row i+1:
//    A crosses L2 -> SM about 130/128 times a pass (three rows where a
//    block's run of rows starts), not 16.  Each warpgroup frees row i-1
//    once its products are done (all three at the end of a run).
//  * Product (parity (py, px), tap (a, c)) reads its 64 pixels from staged
//    row i+py+a-1 at column 64w+px+c on: a descriptor start shifted by
//    whole 128-byte rows (the swizzle follows the address bits in TMA and
//    wgmma alike, as in upconv_dx.cuh's transposed kernel).
//  * The weights resident: the block's 32-channel column of wc [16][64][Co]
//    as it lies, N-major (Co contiguous), one TMA box of 64 ci x 32 co a
//    product in the 64-byte swizzle (64 KB), loaded once for the block's
//    life.  Staged in shift-major order: the products that read the same
//    shift (dy, dx) = (py+a-1, px+c-1) of x lie side by side, 4 KB apart.
//  * One m64n32k16 a product: 16 a k16 step, each into its parity's own
//    16 accumulators.  Shift (0, 0), which every parity reads, goes
//    first, and its products start the tile's sums (scale-d 0): no other
//    instruction writes the accumulators between tiles.  Where they did
//    (the epilogue zeroing them), ptxas serialized every wgmma of the
//    kernel (C7520); one wgmma a shift over its parities' weights as the
//    N panels (m64n128k16 for shift (0, 0), m64n64k16 for the pairs, A
//    read 9 times a step and not 16) names overlapping runs of the
//    accumulators, and ptxas serialized that too (C7511) at every register
//    order tried: 0.1405 against 0.0993 ms on the H100 (run 19l).
//    tools/wgmma_probe.py measures what each instruction shape costs.
//    The transposed form (y^T with the weights as the 64-row operand, as
//    upconv_dx.cuh's dx) would stack two parities' 32 channels in its 64
//    rows: their taps share only some shifts, so 1.5x the products, and
//    its epilogue would transpose.
//  * The two warpgroups issue their products at once (taking turns, so
//    that one's epilogue ran beside the other's products, was 2-5 % slower
//    at every shape on the H100, run 19n).  The epilogue: scale, shift and
//    act in f32 from the registers (relu, lrelu and none branch-free, tanh
//    a kernel of its own: a branch on the activation around the
//    accumulators' reads would serialize the wgmmas), each parity's
//    outputs placed at pixel 2m+px of output row 2i+py of the warpgroup's
//    staging tile (2 rows x 128 pixels x 64 bytes, 64-byte swizzle), then
//    one TMA store a row: 128 output pixels x 32 channels, whole 128-byte
//    lines at Co 32.  The staging tile is rewritten once the last tile's
//    stores have read it.  Each output once, no workspace, no atomics: the
//    same bits every run.
//  * One block an SM, each walking a contiguous run of the (b, segment,
//    row) tiles of its column (Co / 32 columns).
//
// Shapes (the caller's rule, upconv3x3.cu upconv_path, and its Python
// mirror): bf16, Cin 64 (one K slice: the column's weights stay resident
// beside the ring; a deeper Cin would have to stream them and keeps the
// mma.sync tile), Co % 32 == 0 with Co % 64 != 0, W % 128 == 0 (any H, any
// B), 16-byte-aligned x, wc and y.  Other maps keep `pipelined`: the kernel
// masks nothing.

#pragma once

#include <utility>

#include "wgrad.cuh"

namespace up32 {

constexpr int SEG = 128;                       // input pixels of a tile
constexpr int ROW = (SEG + 2) * 128;           // a staged row (16,640 B)
constexpr int W_TILE = 64 * 64;                // 64 ci x 32 co, bf16
constexpr int W_BYTES = 16 * W_TILE;           // the column's 16 products
constexpr int Y_WG = 2 * 128 * 64;             // a warpgroup's staging
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int THREADS = CONSUMERS + 32;        // + the producer warp

constexpr int SLOTS = 4;                       // staged rows in the ring
constexpr int SMEM = 1024 + W_BYTES + 2 * Y_WG + SLOTS * ROW;
static_assert(SMEM + 256 <= 227 * 1024, "fits one SM");

// ---- the products in shift-major order: shift s = (dy+1)*3 + (dx+1),
// then its parities (py-major); product k of shift s is parity (py, px)
// with tap (a, c) = (dy-py+1, dx-px+1)
__host__ __device__ constexpr int lo(int d) { return d > 0 ? d : 0; }
__host__ __device__ constexpr int hi(int d) { return d + 1 < 1 ? d + 1 : 1; }
__host__ __device__ constexpr int count(int s) {
  return (hi(s / 3 - 1) - lo(s / 3 - 1) + 1) *
         (hi(s % 3 - 1) - lo(s % 3 - 1) + 1);
}
__host__ __device__ constexpr int first(int s) {
  return s == 0 ? 0 : first(s - 1) + count(s - 1);
}
__host__ __device__ constexpr int parity(int s, int k) {
  return (lo(s / 3 - 1) + k / (hi(s % 3 - 1) - lo(s % 3 - 1) + 1)) * 2 +
         lo(s % 3 - 1) + k % (hi(s % 3 - 1) - lo(s % 3 - 1) + 1);
}
// the combined tap (py, px, a, c) -> its row block of wc [16][Cin][Co]
__host__ __device__ constexpr int wc_tap(int s, int k) {
  return parity(s, k) * 4 + (s / 3 - 1 - (parity(s, k) >> 1) + 1) * 2 +
         (s % 3 - 1 - (parity(s, k) & 1) + 1);
}
static_assert(first(8) + count(8) == 16, "16 products");

// ---- D[64 x 32] (+)= A[64 x 16] . B[16 x 32]: A K-major (128-byte
// swizzle), B N-major (64-byte swizzle); `acc` 0 overwrites D (a tile's
// first product of each parity), so that no other instruction writes the
// accumulators between tiles (ptxas serializes every wgmma of a kernel
// whose accumulators are written on another path)
__device__ __forceinline__ void mma32(float* d, uint64_t a, uint64_t b,
                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// K-major A in the 128-byte swizzle: 8 rows of 128 bytes 1024 bytes apart
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return igemm90::make_desc(addr, 16, 1024);
}

// N-major B in the 64-byte swizzle: 8 k-rows of 64 bytes 512 bytes apart
// (one panel of 32 columns)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (igemm90::make_desc(addr, W_TILE, 512) & ~(3ull << 62)) |
         (2ull << 62);
}

// the staging tile's TMA store (one commit group a store), and the waits
// for the stores' reads of shared memory and for the stores themselves (as
// upconv_dx.cuh's, whose launchers would build its kernels here too)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct Params {
  const float* scale;
  const float* shift;
  int H, W;
  int tiles;       // B * H * (W / SEG): (b, segment, row), row fastest
  int n_col;       // Co / 32
  int act;
};

// one k16 step of the products of shift S = (dy+1)*3 + (dx+1) for this
// warpgroup: rows[d] is the shared address of staged row i+d-1 at the
// warpgroup's first pixel; the shift's pixels start at column dx+1 (column
// 0 is pixel j0-1).  Shift (0, 0), which every parity reads, goes first
// and starts the tile's sums at k = 0.
template <int S>
__device__ __forceinline__ void shift_products(float* acc,
                                               const uint32_t* rows,
                                               uint32_t w_res, int k) {
  const uint64_t a = a_desc(rows[S / 3] + (S % 3) * 128) + 2 * k;
  const uint32_t w = w_res + first(S) * W_TILE + k * 1024;
#pragma unroll
  for (int q = 0; q < count(S); ++q)
    mma32(acc + 16 * parity(S, q), a, b_desc(w + q * W_TILE),
          S != 4 || k > 0);
}

template <int... S>
__device__ __forceinline__ void products(float* acc, const uint32_t* rows,
                                         uint32_t w_res, int k,
                                         std::integer_sequence<int, S...>) {
  (shift_products<S>(acc, rows, w_res, k), ...);
}
using ShiftOrder = std::integer_sequence<int, 4, 0, 1, 2, 3, 5, 6, 7, 8>;

// (row i, first pixel j0, image b) of tile t: (b, segment, row), row
// fastest
__device__ __forceinline__ int3 origin(const Params& p, int t) {
  const int i = t % p.H, rest = t / p.H, segs = p.W / SEG;
  return make_int3(i, rest % segs * SEG, rest / segs);
}

template <bool TANH>
__global__ void __launch_bounds__(THREADS, 1)
    up32_kernel(const Params p, const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap ymap) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[SLOTS];
  __shared__ __align__(8) unsigned long long empty[SLOTS];
  __shared__ __align__(8) unsigned long long w_full;
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t w_res = (raw + 1023u) & ~1023u;
  const uint32_t y_stage = w_res + W_BYTES;
  const uint32_t ring = y_stage + 2 * Y_WG;

  const int tid = threadIdx.x;
  const int n0 = static_cast<int>(blockIdx.x % p.n_col) * 32;
  const int per_col = gridDim.x / p.n_col, k_blk = blockIdx.x / p.n_col;
  // this block's run of tiles [t0, t1)
  const int t0 = static_cast<int>(static_cast<long long>(p.tiles) * k_blk /
                                  per_col);
  const int t1 = static_cast<int>(static_cast<long long>(p.tiles) *
                                  (k_blk + 1) / per_col);
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), 2);   // both wgs
    }
    igemm90::mbar_init(igemm90::smem_u32(&w_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      const uint32_t wbar = igemm90::smem_u32(&w_full);
      igemm90::mbar_expect_tx(wbar, W_BYTES);
#pragma unroll
      for (int s = 0; s < 9; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < count(s))
            igemm90::tma_load_2d(w_res + (first(s) + q) * W_TILE, &wmap, n0,
                                 wc_tap(s, q) * 64, wbar);
      int n = 0;   // rows loaded
      for (int t = t0; t < t1; ++t) {
        const int3 o = origin(p, t);
        const bool restart = t == t0 || o.x == 0;
        for (int r = restart ? o.x - 1 : o.x + 1; r <= o.x + 1; ++r, ++n) {
          const int s = n % SLOTS;
          if (n >= SLOTS)
            igemm90::mbar_wait(igemm90::smem_u32(&empty[s]),
                               ((n / SLOTS) + 1) & 1);
          const uint32_t bar = igemm90::smem_u32(&full[s]);
          igemm90::mbar_expect_tx(bar, ROW);
          igemm90::tma_load_4d(ring + s * ROW, &xmap, 0, o.y - 1, r, o.z,
                               bar);
        }
      }
    }
    return;
  }

  // Warpgroup wg takes pixels 64wg .. 64wg+63 of every tile
  const int wg = tid >> 7, tid128 = tid & 127;
  // scale and shift of the thread's 8 channels: acc_col of registers
  // 0..15 of a 32-column panel, 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)
  float mul[8], add[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = n0 + (j >> 1) * 8 + (tid128 & 3) * 2 + (j & 1);
    mul[j] = p.scale[co];
    add[j] = p.shift[co];
  }
  // act(v) = v >= 0 ? v : slope * v for none / relu / lrelu; tanh its
  // own kernel (a branch on it around the accumulators' reads would
  // serialize the wgmmas)
  const float slope = p.act == igemm::kRelu    ? 0.f
                      : p.act == igemm::kLrelu ? 0.2f
                                               : 1.f;
  // staging row r = py*128 + 2m + px (64 bytes) for the warpgroup's pixel
  // m = wrow + 8 * ((i >> 1) & 1) (acc_row); its chunk q sits at
  // q ^ ((r >> 1) & 3) = q ^ (wrow & 3)
  const int wrow = (tid128 >> 5) * 16 + ((tid128 & 31) >> 2);
  const uint32_t y_mine = y_stage + wg * Y_WG;
  uint8_t* y_ptr = smem_raw + (y_mine - raw) + 128 * wrow + (tid128 & 3) * 4;
  uint32_t chunk[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) chunk[q] = (q ^ (wrow & 3)) << 4;

  float acc[64];   // [parity][16]
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  igemm90::mbar_wait(igemm90::smem_u32(&w_full), 0);

  int n = 0;   // rows consumed (the producer's count)
  for (int t = t0; t < t1; ++t) {
    const int3 o = origin(p, t);
    const bool restart = t == t0 || o.x == 0;
    n += restart ? 3 : 1;
    // rows i-1, i, i+1 are loads n-3, n-2, n-1 (a row waited for before
    // is still in its slot: this warpgroup has not freed it); this
    // warpgroup's pixels
    uint32_t rows[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      igemm90::mbar_wait(igemm90::smem_u32(&full[(n - 3 + d) % SLOTS]),
                         ((n - 3 + d) / SLOTS) & 1);
      rows[d] = ring + ((n - 3 + d) % SLOTS) * ROW + wg * 64 * 128;
    }
    igemm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      products(acc, rows, w_res, k, ShiftOrder());
    igemm90::wgmma_commit();
    igemm90::wgmma_wait<0>();
    // free row i-1 (all three where the next tile starts a run)
    if (tid128 == 0) {
      const bool last = t + 1 == t1 || o.x + 1 == p.H;
      for (int d = 0; d < (last ? 3 : 1); ++d)
        wgrad::mbar_arrive(igemm90::smem_u32(&empty[(n - 3 + d) % SLOTS]));
      bulk_wait_read();   // this wg's last stores have read it
    }
    // the epilogue: parity (py, px)'s pixel m to staging row py*128 + 2m + px
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
    for (int par = 0; par < 4; ++par)
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        float* a = acc + 16 * par + i;
        const int j = (i >> 2) * 2;
        float v0 = fmaf(a[0], mul[j], add[j]);
        float v1 = fmaf(a[1], mul[j + 1], add[j + 1]);
        if constexpr (TANH) {
          v0 = tanhf(v0);
          v1 = tanhf(v1);
        } else {
          v0 = v0 >= 0.f ? v0 : slope * v0;
          v1 = v1 >= 0.f ? v1 : slope * v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(
            y_ptr + (par >> 1) * 8192 + (par & 1) * 64 +
            1024 * ((i >> 1) & 1) + chunk[i >> 2]) =
            __floats2bfloat162_rn(v0, v1);
      }
    igemm90::fence_async_proxy();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    if (tid128 == 0) {
      // output rows 2i and 2i+1, 128 pixels from 2*j0 + 128*wg
      const int pix =
          (o.z * 2 * p.H + 2 * o.x) * 2 * p.W + 2 * o.y + 128 * wg;
      tma_store_2d(&ymap, y_mine, n0, pix);
      tma_store_2d(&ymap, y_mine + Y_WG / 2, n0, pix + 2 * p.W);
    }
  }
  if (tid128 == 0) bulk_wait();
}

// x [B][H][W][64] in boxes of one row of 130 pixels; wc [16*64][Co] in
// boxes of 64 ci x 32 co; y [B*2H*2W][Co] in boxes of 128 pixels x 32 co
inline bool applies(int Cin, int Co, int W) {
  return Cin == 64 && Co % 32 == 0 && Co % 64 != 0 && W % SEG == 0;
}

// Launches on `s` (x, wc and y 16-byte aligned, scale and shift f32 [Co]);
// returns the CUDA error code, cudaErrorInvalidValue for a shape the kernel
// does not take.
inline cudaError_t launch(const void* x, const void* wc, const float* scale,
                          const float* shift, void* y, int B, int H, int W,
                          int Cin, int Co, int act, cudaStream_t s) {
  if (!applies(Cin, Co, W) || 4ll * B * H * W >= (1ll << 31))
    return cudaErrorInvalidValue;
  auto kernel = act == igemm::kTanh ? up32_kernel<true> : up32_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap = {}, wmap = {}, ymap = {};
  const cuuint64_t xd[4] = {64, static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t xs[3] = {xd[0] * 2, xd[0] * xd[1] * 2,
                            xd[0] * xd[1] * xd[2] * 2};
  const cuuint32_t xb[4] = {64, SEG + 2, 1, 1};
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(Co), 16 * 64};
  const cuuint64_t ws[1] = {wd[0] * 2};
  const cuuint32_t wb[2] = {32, 64};
  const cuuint64_t yd[2] = {static_cast<cuuint64_t>(Co),
                            4ull * B * H * W};
  const cuuint64_t ys[1] = {yd[0] * 2};
  const cuuint32_t yb[2] = {32, 128};
  if ((err = igemm90::encode_tiled(&xmap, 4, x, xd, xs, xb)) !=
          cudaSuccess ||
      (err = igemm90::encode_tiled(&wmap, 2, wc, wd, ws, wb,
                                   CU_TENSOR_MAP_SWIZZLE_64B)) !=
          cudaSuccess ||
      (err = igemm90::encode_tiled(&ymap, 2, y, yd, ys, yb,
                                   CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  Params p;
  p.scale = scale;
  p.shift = shift;
  p.H = H;
  p.W = W;
  p.tiles = B * H * (W / SEG);
  p.n_col = Co / 32;
  p.act = act;
  const int slots = sms / p.n_col > 0 ? sms / p.n_col : 1;
  const int per_col = p.tiles < slots ? p.tiles : slots;
  kernel<<<per_col * p.n_col, THREADS, SMEM, s>>>(p, xmap, wmap, ymap);
  return cudaGetLastError();
}

}  // namespace up32
