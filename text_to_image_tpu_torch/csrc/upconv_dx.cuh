// upconv3x3_dx's main loops on Hopper (sm_90a), included by
// upconv3x3_bwd.cu; its ring loop also runs the conv's dx
// (conv5x5_s2_bwd.cu's policy CDxRing, see "ring" below): dx [B,H,W,Cin]
// of conv3x3(up2(x)) for the cotangent g
// [B,2H,2W,Co] as one implicit GEMM, M = B*H*W rows of dx, N = Cin, K = 16
// taps x Co, f32 sums rounded once to bf16.  They replace the forward's
// gather loop (igemm_sm90.cuh) that dx ran on before, whose A came by
// cp.async (~10 bytes a clock an SM), crossed L2 -> SM once a tap (4x
// g), never took Co 32 to wgmma and split K through an f32 workspace and a
// second launch.
//
// A by TMA from g's parity planes.  g is viewed as the 5-D tensor
// [B][H][2][W][2*Co] (dims innermost first: 2*Co, W, 2, H, B), the view the
// dw kernels read: plane (py, px) is the coordinate py and the channel
// offset px*Co.  Tap t = ((py*2+px)*2+a)*2+c of rows starting at pixel (b,
// i0, j0) reads one box at (px*Co + k0, j0+1-px-c, py, i0+1-py-a, b); the
// tensor map's zero fill gives the taps that fall off the map.  A tile of
// BM = 128 rows is a box where it is a part of one image row (W % 128 ==
// 0), whole rows of one image or whole images (`boxes`); other maps keep
// the cp.async loop (a path picked by shape, in C and in its Python
// mirror).
//
// The weights K-major: the combined weights wc [16][Cin][Co] are, tap by
// tap, [Cin][Co] with Co (K) contiguous, which wgmma reads as they are (no
// transposed copy, no extra launch).
//
// K slices: 64 channels (128-byte rows in the 128-byte swizzle, four k16
// steps), or 32 where Co is not a multiple of 64 (C-PGGAN's Co 32, Co 96:
// 64-byte rows in the 64-byte swizzle, two k16 steps).
//
// Two kernels, by shape (ops/kernels/conv.py dx_plan mirrors the choice,
// tools/conv_plan_sweep.py --ops dx measured it):
//  * ring_kernel (every map with a box): a block is a 128 x BN tile (BN 64,
//    128, 256) over a part of its (tap, slice) items; a producer warp keeps
//    a ring of stages full by TMA (A box + B box), each freed by an
//    "empty" mbarrier that the two consumer warpgroups arrive on once
//    their wgmma group of that stage is done (one group stays in flight).
//    The parts of K of a tile run as one thread-block cluster of up to 8
//    CTAs: each stages its f32 tile in its own shared memory, the CTAs
//    split the rows and add the cluster's tiles in rank order through
//    distributed shared memory, and round the sum into dx: no workspace,
//    no second launch, no atomics, the same bits every launch.
//  * transposed_kernel (Co 32 or 64 on maps of 128-pixel row segments and
//    an even number of rows: the 128^2 maps, bound by bytes, whose N = Cin
//    of 64 would leave the ring's m64n64k16 bound by shared-memory reads):
//    it computes dx^T = Wc^T A^T, m64n128k16 with the weights as the
//    64-row operand and 128 pixels as the columns.  A block's tile is two
//    image rows of 128 pixels; the four taps (a, c) of a plane share one
//    staged patch of g's plane (3 rows x 129 pixels around the two rows),
//    tap (a, c) reading its pixels from row (w+1-a), column (1-c) on
//    through a descriptor whose start is shifted by whole rows.  The
//    swizzle follows the address bits in both TMA and wgmma, so the
//    shifted start needs no base offset (setting that field to the row's
//    phase gave wrong sums on the H100) and stages need only 128-byte
//    alignment.  L2 -> SM bytes of A fall from 4x g to 1.5x g
//    (3 x 129 / 256).  The block walks tiles with the weights of each item
//    streamed beside its patch; the warpgroup's 128 x 64 tile goes out
//    transposed through a swizzled staging tile and one TMA store, which
//    overlaps the next tile's products.
//
// Bound on the H100 SXM (bf16, B 64): 2*16*M*Cin*Co operations; the 128^2
// maps (g 537 MB at Co 64) are bound by bytes, the others by operations
// (see upconv3x3_bwd.cu).

#pragma once

#include "wgrad.cuh"

namespace dx90 {

constexpr int BM = 128;                     // rows of a tile
constexpr int CONSUMERS = 256;              // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;     // + the producer warp
constexpr int MAX_PARTS = wgrad::MAX_CLUSTER;

// D[64 x N] += A[64 x 16] * B[16 x N], A and B both K-major in shared
// memory
template <int N>
struct Mma;

template <>
struct Mma<64> {
  __device__ static __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ static __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  __device__ static __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};


// K-major descriptor of rows of RB bytes in the RB-byte swizzle (128: type
// 1, 8-row groups 1024 bytes apart; 64: type 2, 512 bytes apart)
template <int RB>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  if constexpr (RB == 128)
    return igemm90::make_desc(addr, 16, 1024);
  else
    return (igemm90::make_desc(addr, 16, 512) & ~(3ull << 62)) | (2ull << 62);
}

// a tile of BM rows is one box: a part of one image row, whole rows of one
// image, or whole images
inline bool boxes(int H, int W) {
  const long long hw = static_cast<long long>(H) * W;
  return W % BM == 0 || (BM % W == 0 && (hw % BM == 0 || BM % hw == 0));
}

// ... and where the transposed kernel's tiles, two image rows of a
// 128-pixel segment, cover the map: the taps of a plane share one patch
inline bool patches(int H, int W) { return W % 128 == 0 && H % 2 == 0; }

struct Params {
  void* dx;
  int H, W, HW, Cin, Co, M;
  int S;           // K slices of a tap: Co / BK
  int parts;       // ring: parts of K, one cluster of them
  int n_col;       // column tiles
};

// (j, i, b) of GEMM row r
__device__ __forceinline__ int3 pixel(const Params& p, int r) {
  const int b = r / p.HW, rem = r - b * p.HW, i = rem / p.W;
  return make_int3(rem - i * p.W, i, b);
}

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

// ------------------------------------------------------------------ ring --
// The ring loop serves three ops through one template hook, a policy Pol
// that says what a tile is (`tile`: from blockIdx.y, with its number of
// (tap, slice) items), where item it's A and B boxes come from (`load`)
// and where row r of the tile goes in dx (`out`: the element offset of its
// channel 0, or -1 past the map): UpconvRing below (upconv3x3_dx, 16
// combined taps), conv5x5_s2_bwd.cu's CDxRing (the conv's dx, the 4 / 6 /
// 6 / 9 taps of a parity) and DDxRing (the transposed conv's dx, 25 taps).
// A policy's `kOneBlock` (ONE) asks for one block an SM at every width:
// DDxRing's small-M calls leave the card one block an SM anyway, and a
// deeper ring then hides the loads.
template <int BN, int BK, bool ONE = false>
struct Ring {
  static constexpr int RB = BK * 2;                  // bytes of a K row
  static constexpr int A_STAGE = BM * RB, B_STAGE = BN * RB;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int BLOCKS = BN == 256 || ONE ? 1 : 2;   // an SM holds
  static constexpr int BUDGET = BLOCKS == 1 ? 192 * 1024 : 96 * 1024;
  static constexpr int STAGES = BUDGET / STAGE < 8 ? BUDGET / STAGE : 8;
  static constexpr int LD = BN + 4;                  // staged f32 rows
  static constexpr int STAGED = BM * LD * 4;
  static constexpr int RING =
      STAGES * STAGE > STAGED ? STAGES * STAGE : STAGED;
  static constexpr int SMEM = RING + 1024;           // + hand alignment
};

// The cluster's f32 tiles (each CTA's in its own shared memory at `stg`,
// rows of BN + 4 floats) added in rank order and rounded into dx: CTA
// `rank` of `csize` takes rows [rank*BM/csize, (rank+1)*BM/csize), four
// columns a thread (every rank's four loaded before the adds).
template <int BN, class Pol>
__device__ __forceinline__ void sum_store(const typename Pol::P& p,
                                          const typename Pol::T& t,
                                          float* stg, const float* acc,
                                          int n0, int csize) {
  constexpr int LD = BN + 4, C4 = BN / 4;
  const int tid = threadIdx.x;
  if (tid < CONSUMERS) {
    const int wg = tid >> 7, tid128 = tid & 127;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2)
      *reinterpret_cast<float2*>(
          stg + (wg * 64 + igemm90::acc_row(tid128, i)) * LD +
          igemm90::acc_col(tid128, i)) = make_float2(acc[i], acc[i + 1]);
  }
  __syncthreads();
  if (csize > 1) wgrad::cluster_sync();
  const int rank = csize > 1 ? static_cast<int>(blockIdx.x) : 0;
  const int r_lo = rank * BM / csize, r_hi = (rank + 1) * BM / csize;
  const uint32_t base = igemm90::smem_u32(stg);
  uint16_t* dx = static_cast<uint16_t*>(p.dx);
  for (int e = tid; e < (r_hi - r_lo) * C4; e += THREADS) {
    const int r = r_lo + e / C4, c = (e % C4) * 4;
    const long long o = Pol::out(p, t, r);
    if (o < 0) continue;
    const int off = r * LD + c;
    float4 s;
    if (csize > 1) {
      float4 v[MAX_PARTS];
#pragma unroll
      for (int q = 0; q < MAX_PARTS; ++q)
        if (q < csize)
          v[q] = wgrad::ld_cluster4(base + off * 4, static_cast<uint32_t>(q));
      s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < MAX_PARTS; ++q)
        if (q < csize) {
          s.x += v[q].x;
          s.y += v[q].y;
          s.z += v[q].z;
          s.w += v[q].w;
        }
    } else {
      s = *reinterpret_cast<const float4*>(stg + off);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
    *reinterpret_cast<uint2*>(dx + o + n0 + c) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  }
  // no CTA leaves while another still reads its shared memory
  if (csize > 1) wgrad::cluster_sync();
}

// upconv3x3_dx's policy: a tile is BM rows of dx from row0, columns n0 on;
// its 16 * S items are (tap t, slice) in that order, tap t one box of g's
// parity plane (py, px) shifted by (1-py-a, 1-px-c)
struct UpconvRing {
  using P = Params;
  static constexpr bool kOneBlock = false;
  struct T {
    int row0, n0, items;
    int3 q;   // (j, i, b) of row0
  };
  __device__ static T tile(const P& p, int y, int bn) {
    T t;
    t.row0 = y / p.n_col * BM;
    t.n0 = (y % p.n_col) * bn;
    t.items = 16 * p.S;
    t.q = pixel(p, t.row0);
    return t;
  }
  template <int BK>
  __device__ static void load(const P& p, const T& t, int item, uint32_t a,
                              uint32_t b, const CUtensorMap* gmap,
                              const CUtensorMap* wmap, uint32_t bar) {
    const int tap = item / p.S, k0 = (item - tap * p.S) * BK;
    const int py = tap >> 3, px = (tap >> 2) & 1, ta = (tap >> 1) & 1,
              tc = tap & 1;
    wgrad::tma_load_5d(a, gmap, px * p.Co + k0, t.q.x + 1 - px - tc, py,
                       t.q.y + 1 - py - ta, t.q.z, bar);
    igemm90::tma_load_2d(b, wmap, k0, tap * p.Cin + t.n0, bar);
  }
  __device__ static long long out(const P& p, const T& t, int r) {
    return t.row0 + r < p.M ? static_cast<long long>(t.row0 + r) * p.Cin
                            : -1;
  }
};

// A block computes the BM x BN tile blockIdx.y over part blockIdx.x of
// its (tap, slice) items, in clusters of the tile's parts along x.
template <int BN, int BK, class Pol>
__global__ void __launch_bounds__(THREADS,
                                  Ring<BN, BK, Pol::kOneBlock>::BLOCKS)
    ring_kernel(const typename Pol::P p,
                const __grid_constant__ CUtensorMap gmap,
                const __grid_constant__ CUtensorMap wmap) {
  using R = Ring<BN, BK, Pol::kOneBlock>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[R::STAGES];
  __shared__ __align__(8) unsigned long long empty[R::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const typename Pol::T t = Pol::tile(p, blockIdx.y, BN);
  const int2 span = wgrad::part(blockIdx.x, p.parts, t.items);
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
        igemm90::mbar_expect_tx(bar, R::STAGE);
        Pol::template load<BK>(p, t, span.x + it, st, st + R::A_STAGE,
                               &gmap, &wmap, bar);
      }
    }
  } else {
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % R::STAGES;
      igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (it / R::STAGES) & 1);
      const uint32_t st = ring + s * R::STAGE;
      const uint64_t ad = desc<R::RB>(st + wg * 64 * R::RB);
      const uint64_t bd = desc<R::RB>(st + R::A_STAGE);
      igemm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)   // +32 bytes a k16 step
        Mma<BN>::mma(acc, ad + 2 * k, bd + 2 * k);
      igemm90::wgmma_commit();
      // the group of item it-1 is done: its stage is free
      igemm90::wgmma_wait<1>();
      if (it > 0 && tid128 == 0)
        wgrad::mbar_arrive(igemm90::smem_u32(&empty[(it - 1) % R::STAGES]));
    }
    igemm90::wgmma_wait<0>();
  }
  __syncthreads();   // every stage consumed: the ring is free
  sum_store<BN, Pol>(p, t, reinterpret_cast<float*>(smem_raw + (ring - raw)),
                     acc, t.n0, p.parts);
}

// ------------------------------------------------------------ transposed --
// dx^T: D[64 ci x 128 pixels] += Wc[t][ci][k] . A_t[pixel][k] per warpgroup,
// m64n128k16 with the weights as the 64-row operand and the pixels (a
// patch's rows, shifted per tap) as the 128-column one: 6 KB of shared
// memory a k16 step for 64 x 128 x 16 products.  A block's tile is two
// image rows of 128 pixels (warpgroup w row i0 + w).  An item is one
// parity plane, its four taps' weights (64 ci x BK each) and one patch of
// 3 rows x 129 pixels that both warpgroups read; at BK 64, where such an
// item leaves room for two stages only, half of one (HALF: the taps of one
// row a, a patch of 2 rows), so that four stages fit: the faster on the
// H100 at 128^2x64->64, while at BK 32 the whole plane, four stages deep,
// was the faster.
template <int BK>
struct TPatch {
  static constexpr bool HALF = BK == 64;
  static constexpr int RB = BK * 2;
  static constexpr int W_TILE = 64 * RB;               // a tap's weights
  static constexpr int TAPS = HALF ? 2 : 4;            // taps an item
  static constexpr int ROWS = HALF ? 2 : 3;            // patch rows
  static constexpr int PER_PLANE = HALF ? 2 : 1;       // items a plane
  static constexpr int PATCH = ROWS * 129 * RB;
  static constexpr int BYTES = TAPS * W_TILE + PATCH;
  // stages 128-byte aligned: TMA and wgmma swizzle by address bits
  static constexpr int STAGE = (BYTES + 127) / 128 * 128;
  static constexpr int Y_STAGE = 128 * 128;            // 128 px x 64 ci
  static constexpr int SMEM = 227 * 1024 - 256;
  static constexpr int FIT = (SMEM - 1024 - 2 * Y_STAGE) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static_assert(STAGES >= 2, "two stages fit");
};

template <int BK>
__global__ void __launch_bounds__(THREADS, 1)
    transposed_kernel(const Params p, const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap ymap) {
  using T = TPatch<BK>;
  constexpr bool HALF = T::HALF;
  constexpr int PER_TILE = 4 * T::PER_PLANE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) unsigned long long full[T::STAGES];
  __shared__ __align__(8) unsigned long long empty[T::STAGES];
  const uint32_t raw = igemm90::smem_u32(smem_raw);
  const uint32_t y_stage = (raw + 1023u) & ~1023u;
  const uint32_t ring = y_stage + 2 * T::Y_STAGE;

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % p.n_col) * 64;
  const int first = blockIdx.x / p.n_col, stride = gridDim.x / p.n_col;
  // tiles: (b, i0 = 2 * row pair, j0 = 128 * segment)
  const int segs = p.W / 128, pairs = p.H / 2;
  const int tiles = p.M / 256;
  const int my_tiles =
      first < tiles ? (tiles - first + stride - 1) / stride : 0;
  const int items = my_tiles * PER_TILE;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      igemm90::mbar_init(igemm90::smem_u32(&full[s]), 1);
      igemm90::mbar_init(igemm90::smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto origin = [&](int k) {   // (j0, i0, b) of this block's k-th tile
    const int t = first + k * stride;
    const int b = t / (pairs * segs), rem = t - b * pairs * segs;
    return make_int3(rem % segs * 128, rem / segs * 2, b);
  };

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      for (int it = 0; it < items; ++it) {
        const int sub = it % PER_TILE, pl = sub / T::PER_PLANE;
        const int a0 = HALF ? sub & 1 : 0, py = pl >> 1, px = pl & 1;
        const int3 q = origin(it / PER_TILE);
        const int s = it % T::STAGES;
        if (it >= T::STAGES)
          igemm90::mbar_wait(igemm90::smem_u32(&empty[s]),
                             ((it / T::STAGES) + 1) & 1);
        const uint32_t st = ring + s * T::STAGE;
        const uint32_t bar = igemm90::smem_u32(&full[s]);
        igemm90::mbar_expect_tx(bar, T::BYTES);
#pragma unroll
        for (int tap = 0; tap < T::TAPS; ++tap)
          igemm90::tma_load_2d(st + tap * T::W_TILE, &wmap, 0,
                               (pl * 4 + a0 * 2 + tap) * p.Cin + n0, bar);
        // rows i0-py (HALF: i0-py+1-a0) on, pixels j0-px .. j0-px+128 of
        // plane (py, px)
        wgrad::tma_load_5d(st + T::TAPS * T::W_TILE, &gmap, px * p.Co,
                           q.x - px, py, q.y - py + (HALF ? 1 - a0 : 0), q.z,
                           bar);
      }
    }
    return;
  }
  const int wg = tid >> 7, tid128 = tid & 127;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t y_mine = y_stage + wg * T::Y_STAGE;
  uint8_t* y_ptr = smem_raw + (y_mine - raw);
  for (int it = 0; it < items; ++it) {
    const int s = it % T::STAGES, sub = it % PER_TILE;
    igemm90::mbar_wait(igemm90::smem_u32(&full[s]), (it / T::STAGES) & 1);
    const uint32_t st = ring + s * T::STAGE;
    const uint32_t patch = st + T::TAPS * T::W_TILE;
    igemm90::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < T::TAPS; ++tap) {
      const int a = HALF ? 0 : tap >> 1, c = tap & 1;
      // tap (a, c) reads pixels from patch row wg + 1 - a (HALF: the box
      // starts at that row for wg 0), column 1 - c on: a start shifted by
      // whole rows of the swizzled layout
      const uint64_t ad = desc<T::RB>(st + tap * T::W_TILE);
      const uint64_t bd =
          desc<T::RB>(patch + ((wg + 1 - a - (HALF ? 1 : 0)) * 129 + 1 - c) *
                                  T::RB);
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)   // +32 bytes a k16 step
        Mma<128>::mma(acc, ad + 2 * k, bd + 2 * k);
    }
    igemm90::wgmma_commit();
    igemm90::wgmma_wait<1>();
    // item it-1's stage is free, unless it ended the last tile (freed there)
    if (sub != 0 && tid128 == 0)
      wgrad::mbar_arrive(igemm90::smem_u32(&empty[(it - 1) % T::STAGES]));
    if (sub == PER_TILE - 1) {
      igemm90::wgmma_wait<0>();
      if (tid128 == 0) wgrad::mbar_arrive(igemm90::smem_u32(&empty[s]));
      // the warpgroup's 128 pixels x 64 ci out, transposed into the
      // swizzled staging tile, then one TMA store of 128 rows of dx
      const int3 q = origin(it / PER_TILE);
      const int row0 = ((q.z * p.H + q.y + wg) * p.W) + q.x;
      if (tid128 == 0) bulk_wait_read();
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int ci = igemm90::acc_row(tid128, i);
        const int px = igemm90::acc_col(tid128, i);
        *reinterpret_cast<__nv_bfloat16*>(
            y_ptr + px * 128 + (((ci >> 3) ^ (px & 7)) << 4) + (ci & 7) * 2) =
            __float2bfloat16(acc[i]);
        acc[i] = 0.f;
      }
      igemm90::fence_async_proxy();
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      if (tid128 == 0) tma_store_2d(&ymap, y_mine, n0, row0);
    }
  }
  if (tid128 == 0) bulk_wait();
}

// ---------------------------------------------------------------- launch --
enum Kernel { kCpAsync = 0, kRing = 1, kTransposed = 2 };

// What a launch of t2i_upconv3x3_dx did, as bits (t2i_upconv3x3_dx_mode):
// A by TMA (either kernel, both with a producer warp), the taps of a plane
// from one shared patch (the transposed kernel), 64-byte K slices, the
// parts of K summed in a cluster, a workspace and its reduce launch, A
// gathered by cp.async
enum Mode {
  kTmaA = 1, kPatch = 2, kK32 = 4, kCluster = 8, kWorkspace = 16,
  kGather = 32
};

// g [B][2H][2W][Co] as [B][H][2][W][2*Co]; boxes of BK channels by `box`
// (innermost first: pixels, rows, images)
inline cudaError_t g_map(CUtensorMap* map, const void* g, int B, int H,
                         int W, int Co, int BK, const cuuint32_t* box) {
  const cuuint64_t d[5] = {2 * static_cast<cuuint64_t>(Co),
                           static_cast<cuuint64_t>(W), 2,
                           static_cast<cuuint64_t>(H),
                           static_cast<cuuint64_t>(B)};
  const cuuint64_t s[4] = {d[0] * 2, d[0] * d[1] * 2, d[0] * d[1] * 2 * 2,
                           d[0] * d[1] * 2 * d[3] * 2};
  const cuuint32_t b[5] = {static_cast<cuuint32_t>(BK), box[0], 1, box[1],
                           box[2]};
  return igemm90::encode_tiled(map, 5, g, d, s, b,
                               BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_64B);
}

// wc [taps][Cin][Co] as [taps*Cin][Co] (the combined weights: 16 taps;
// the conv's w: 25): boxes of BK channels x `rows` columns
inline cudaError_t w_map(CUtensorMap* map, const void* wc, int Cin, int Co,
                         int BK, int rows, int taps = 16) {
  const cuuint64_t d[2] = {static_cast<cuuint64_t>(Co),
                           static_cast<cuuint64_t>(taps) * Cin};
  const cuuint64_t s[1] = {d[0] * 2};
  const cuuint32_t b[2] = {static_cast<cuuint32_t>(BK),
                           static_cast<cuuint32_t>(rows)};
  return igemm90::encode_tiled(map, 2, wc, d, s, b,
                               BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_64B);
}

inline Params params(void* dx, int B, int H, int W, int Cin, int Co, int BK,
                     int BN, int parts) {
  Params p;
  p.dx = dx;
  p.H = H;
  p.W = W;
  p.HW = H * W;
  p.Cin = Cin;
  p.Co = Co;
  p.M = B * H * W;
  p.S = Co / BK;
  p.parts = parts;
  p.n_col = Cin / BN;
  return p;
}

template <int BN, int BK>
cudaError_t launch_ring(const void* g, const void* wc, void* dx, int B,
                        int H, int W, int Cin, int Co, int parts,
                        cudaStream_t s) {
  using R = Ring<BN, BK>;
  auto kernel = ring_kernel<BN, BK, UpconvRing>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  const Params p = params(dx, B, H, W, Cin, Co, BK, BN, parts);
  const int row_tiles = (p.M + BM - 1) / BM;
  if (static_cast<long long>(row_tiles) * p.n_col > 65535)
    return cudaErrorInvalidValue;   // the grid's y extent
  // a tile's box: pixels of one row, rows, images
  const cuuint32_t box[3] = {
      static_cast<cuuint32_t>(W < BM ? W : BM),
      static_cast<cuuint32_t>(W >= BM ? 1 : (BM / W < H ? BM / W : H)),
      static_cast<cuuint32_t>(p.HW < BM ? BM / p.HW : 1)};
  CUtensorMap gmap = {}, wmap = {};
  if ((err = g_map(&gmap, g, B, H, W, Co, BK, box)) != cudaSuccess ||
      (err = w_map(&wmap, wc, Cin, Co, BK, BN)) != cudaSuccess)
    return err;
  return launch_clustered(kernel, dim3(parts, row_tiles * p.n_col, 1),
                          THREADS, R::SMEM, parts, s, p, gmap, wmap);
}

template <int BK>
cudaError_t launch_transposed(const void* g, const void* wc, void* dx, int B,
                              int H, int W, int Cin, int Co, cudaStream_t s) {
  using T = TPatch<BK>;
  auto kernel = transposed_kernel<BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const Params p = params(dx, B, H, W, Cin, Co, BK, 64, 1);
  const cuuint32_t patch[3] = {129, T::ROWS, 1};
  CUtensorMap gmap = {}, wmap = {}, ymap = {};
  const cuuint64_t yd[2] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(p.M)};
  const cuuint64_t ys[1] = {yd[0] * 2};
  const cuuint32_t yb[2] = {64, 128};
  if ((err = g_map(&gmap, g, B, H, W, Co, BK, patch)) != cudaSuccess ||
      (err = w_map(&wmap, wc, Cin, Co, BK, 64)) != cudaSuccess ||
      (err = igemm90::encode_tiled(&ymap, 2, dx, yd, ys, yb)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int tiles = p.M / 256;
  const int slots = sms / p.n_col > 0 ? sms / p.n_col : 1;
  const int per_col = tiles < slots ? tiles : slots;
  kernel<<<per_col * p.n_col, THREADS, T::SMEM, s>>>(p, gmap, wmap, ymap);
  return cudaGetLastError();
}

// dx on the TMA kernels (bf16; Cin % 64 == 0, Co % 32 == 0, a map with
// `boxes`, 16-byte-aligned g, wc and dx): `kernel` kRing with `tile_n` (64,
// 128, 256; dividing Cin) and `parts` (1..8, at most the 16*Co/BK items)
// in one cluster, or kTransposed (Co 32 or 64 on a map with `patches`,
// `tile_n` 64, one part).  Returns the CUDA error code and the launch's
// Mode bits in *mode.
inline cudaError_t launch(const void* g, const void* wc, void* dx, int B,
                          int H, int W, int Cin, int Co, int kernel,
                          int tile_n, int parts, cudaStream_t s, int* mode) {
  const int bk = Co % 64 == 0 ? 64 : 32;
  if (Cin % 64 || Co % 32 || !boxes(H, W) ||
      static_cast<long long>(B) * H * W * Cin >= (1ll << 31))
    return cudaErrorInvalidValue;
  const int k32 = bk == 32 ? kK32 : 0;
  if (kernel == kTransposed) {
    if (tile_n != 64 || parts != 1 || (Co != 64 && Co != 32) ||
        !patches(H, W))
      return cudaErrorInvalidValue;
    *mode = kTmaA | kPatch | k32;
    return Co == 64
               ? launch_transposed<64>(g, wc, dx, B, H, W, Cin, Co, s)
               : launch_transposed<32>(g, wc, dx, B, H, W, Cin, Co, s);
  }
  if (kernel != kRing || (tile_n != 64 && tile_n != 128 && tile_n != 256) ||
      Cin % tile_n || parts < 1 || parts > MAX_PARTS ||
      parts > 16 * (Co / bk))
    return cudaErrorInvalidValue;
  *mode = kTmaA | k32 | (parts > 1 ? kCluster : 0);
  if (bk == 64) {
    switch (tile_n) {
      case 64: return launch_ring<64, 64>(g, wc, dx, B, H, W, Cin, Co, parts, s);
      case 128: return launch_ring<128, 64>(g, wc, dx, B, H, W, Cin, Co, parts, s);
      default: return launch_ring<256, 64>(g, wc, dx, B, H, W, Cin, Co, parts, s);
    }
  }
  switch (tile_n) {
    case 64: return launch_ring<64, 32>(g, wc, dx, B, H, W, Cin, Co, parts, s);
    case 128: return launch_ring<128, 32>(g, wc, dx, B, H, W, Cin, Co, parts, s);
    default: return launch_ring<256, 32>(g, wc, dx, B, H, W, Cin, Co, parts, s);
  }
}

}  // namespace dx90
