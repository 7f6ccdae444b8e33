// Implicit GEMM on Hopper's warpgroup matrix unit (wgmma, sm_90a): the
// aligned bf16 path of conv5x5_s2.cu, conditioning_join.cu,
// deconv5x5_s2.cu, upconv3x3.cu and the dx of upconv3x3_bwd.cu.  It replaces the tiles those kernels
// ran on mma.sync (igemm.cuh; the Pallas bodies in
// text_to_image_tpu/ops/pallas/conv.py _conv_kernel*, _deconv_kernel*,
// _upconv_kernel / _upconv_halo_kernel and fused.py _join_core, each a
// GEMM over taps that the TPU's grid walked in order).
//
//   Y_g[r, co] = act(sum_k A_g[r, k] * Wt[k, co] * mul(co) + add(r, co)),
//   r < M, co < N, g < groups
//
// `groups` = G GEMMs that share M and N run in one launch: the four output
// parities of the transposed conv and of the upsampling conv.  Group g walks
// K as group_taps(g) taps of Cin channels (bf16, Cin % 64 == 0, N % 64 == 0,
// at most 32 taps, 16-byte-aligned pointers).  A problem type P derives from
// igemm::Common (its `add`, `mul`, `groups`, `group_taps`, `weight_rows` and
// the grouped `y_row(r, g)` are read here) and adds the gather in hoisted
// form; every hook is handed the group, none decodes it from the block index:
//
//   struct P : igemm::Common {
//     // decoded once per row: element offsets from `a` of group g's row r
//     // at tap 0, channel 0 (it may lie outside the tensor) and bit t set
//     // where tap t reads inside it
//     __device__ igemm90::Gather gather(int r, int g) const;   // any r
//     // which of the row's offsets tap t starts from (Gather::base, or
//     // base2 for a problem whose taps read two tensors)
//     __device__ long long row_off(const Gather&, int tap) const;
//     // element offset of group g's tap t from there: the same for every row
//     __device__ long long tap_off(int g, int tap) const;
//     // 64-channel slices of tap t
//     __device__ int slices(int tap) const;
//     // the weights: one row-major matrix [weight_rows()][N] at `w`, of
//     // which group g's tap t reads from row w_row(g, t) -- then TMA brings
//     // them, one thread asking for whole swizzled panels -- or a pointer per
//     // tap, copied by cp.async (groups == 1 only)
//     static constexpr bool kOneWeightMatrix;
//     __device__ int w_row(int g, int tap) const;          // if it is one
//     __device__ const uint16_t* w_rows(int tap) const;    // if it is not
//   };
//
// so that inside the K loop a tap costs one table read, one bit test and a
// few adds per 16-byte copy, and no division.
//
// What bounds it: the deep layers are bound by tensor-core operations (see
// the callers' notes), and only wgmma reaches that rate.  On the H100 what
// holds this loop below it is the feed of A: gathered row by row with
// cp.async it arrives at about 10 bytes a clock per SM whatever the tile,
// which caps a 128x128 tile near 310 TFLOP/s, a 128x256 tile near 630 and
// the N = 64 tiles near 150 (one byte of A per 64 or 128 or 256 products).
// Design:
//  * K slices of 64 channels: one slice is a 128-byte row per A row, the
//    width of the 128-byte shared-memory swizzle, and never straddles a tap.
//  * A tile [BM][64] K-major, B tile [64][BN] N-major as the weights lie in
//    memory (the descriptor's transpose bit, no packing launch), both in the
//    128-byte-swizzled layout wgmma reads without bank conflicts: 16-byte
//    chunk c of 128-byte row r sits at chunk c ^ (r & 7); B is split in
//    panels of 64 output channels.
//  * A ring of stages in shared memory, one __syncthreads per slice of four
//    k16 wgmma steps.  A is gathered by cp.async, 16 bytes a thread,
//    zero-filled where the tap lies outside the image -- or, where the
//    problem's rows are the pixels of an image and a tile is whole image
//    rows (every deconv and upconv main-path call), A comes by TMA: the
//    slice of a tap is one 4-D box of the image shifted by the tap's offset,
//    zero-filled outside it (deconv 0.0709-0.0880 -> 0.0651-0.0752 ms, the
//    thin upconv 0.8757 -> 0.7408 ms on the H100).  The weights of a
//    problem that keeps them in one matrix come by TMA: one thread asks for
//    the slice's panels (cuTensorMapEncodeTiled with the 128-byte swizzle),
//    which complete on the stage's mbarrier.  That halves what goes through
//    the copy units of the SM, which is what limits this kernel: with both
//    operands on cp.async the large calls stood at 480-550 TFLOP/s, with
//    the weights on TMA at 480-630.
//  * One warpgroup per 64 rows: m64nBNk16, f32 accumulators in registers.
//    Tiles 128x128, 128x64, 64x128 (two blocks fit one SM, so one block's
//    barrier hides behind the other's products) and 128x256 (one block per
//    SM, 128 accumulator registers a thread; half the gathered bytes per
//    product, the fastest where N and the number of tiles allow whole
//    waves).  Block order: the group is the fastest part of blockIdx.x (as
//    igemm::Common::group() reads it), then the column tile, then the row
//    tile, so the blocks that run together are the G groups and the column
//    tiles of the same rows: they gather overlapping input rows, which come
//    from device memory once and from L2 after.  Tried and not kept: a
//    copy-only warpgroup handing stages over through mbarriers (slower: one
//    warpgroup of cp.async cannot feed two of wgmma), and one group of
//    products kept in flight over the barrier (no gain).
//  * Epilogue from the registers: mul/add/act in f32, bf16 through shared
//    memory, whole NHWC rows stored 16 bytes a thread through y_row(r, g).
//    Each output once.
//  * Split of K over whole taps (blockIdx.z = part) for calls with too few
//    tiles for 132 SMs, per group: group g runs in parts[g] parts, which
//    may differ between groups (the transposed conv's parities have 4, 6, 6
//    and 9 taps; splitting the long ones evens the blocks out).  f32
//    partial sums go to a workspace of one [M][N] plane per part of each
//    split group, and splitk_reduce_kernel adds them in the fixed order
//    0..parts-1 before the epilogue: no atomics, the same bits every run.
//  * Shallow K (resident_kernel): where a group's whole K is at most 4
//    slices and N = 64 (the upconv layer 128^2x64->64: 32768 blocks of 4
//    slices each on the ring above), a block keeps its group's B panels
//    (32 KB) in shared memory, walks many row tiles, and streams their
//    slices through one ring that never drains: the next tile's A is in
//    flight while this tile multiplies and stores.  Two blocks per SM, so
//    that one block's epilogue hides behind the other's products: 0.6495 ms
//    against 0.7408 on the ring.  One block per SM with an 8-deep ring and
//    up to 8 slices (64 KB of weights, the Cin = 128 layers) was slower
//    than the ring at every shape (0.3638 against 0.2689 ms at
//    64^2x128->64) and is not kept.

#pragma once

#include <cuda.h>

#include "igemm.cuh"

namespace igemm90 {

using igemm::apply_act;

constexpr int BK = 64;            // channels per K slice (128 bytes)
constexpr int MAX_TAPS = 32;      // the gather's mask is 32 bits
constexpr int MAX_SPLIT = 5;
constexpr int MAX_GROUPS = 4;

// How K is split: group g runs in parts[g] parts of whole taps; the f32
// partial sums of its part z go to workspace plane first[g] + z.
struct Split {
  int parts[MAX_GROUPS];
  int first[MAX_GROUPS];
};

struct Gather {
  long long base;   // element offset of (tap 0, channel 0)
  long long base2;  // a second one, for problems whose taps read two tensors
  unsigned taps;    // bit t: tap t lies inside the tensor
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..7) of 128-byte row r, 128B swizzle
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// 16-byte async copy to a shared address; zero-fill when !valid (the source
// must be a valid address all the same)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes the copies (generic proxy) visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; the tile base is
// 1024-byte aligned.  K-major A: sbo = 1024 (8 rows of 128 bytes), lbo
// unused.  N-major B: sbo = 1024 (8 k-rows), lbo = bytes between panels of
// 64 columns.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- TMA: one thread asks for a box of a 2-D tensor; the bytes land in the
// 128-byte-swizzled layout above and complete on an mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// spins until the barrier's phase of this parity is complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A bf16 tensor map with the 128-byte swizzle (or `swizzle`): `rank` (at
// most 5) dims, innermost first, byte strides of the outer ones, one box
// per request; elements outside the tensor arrive as zeros.  cuTensorMapEncodeTiled is reached
// through the runtime, so the library links against no driver stub.
inline cudaError_t encode_tiled(
    CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};   // up to rank 5
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The weights: a row-major matrix [rows][cols], boxes of 64 rows by 64
// columns (one swizzled panel).
inline cudaError_t make_weight_map(CUtensorMap* map, const void* w,
                                   uint64_t rows, uint64_t cols) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, 64};
  return encode_tiled(map, 2, w, dims, strides, box);
}

// A by TMA: where the GEMM rows are the pixels of an NHWC image x
// [B][H][W][C] in order and a tile of bm rows is whole image rows (bm/W of
// one image) or whole images (bm/(H*W)), the A slice of a tap is one box
// of the image shifted by the tap's offset: 64 channels of W x rows x
// images pixels, which lands in exactly the swizzled [bm][128 bytes] layout
// the cp.async gather builds, with zeros where it leaves the image.
inline bool image_boxes(int H, int W, int bm) {
  const long long hw = static_cast<long long>(H) * W;
  return W > 0 && bm % W == 0 && (hw % bm == 0 || bm % hw == 0);
}

inline cudaError_t make_image_map(CUtensorMap* map, const void* x, int B,
                                  int H, int W, int C, int bm) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const int rows = bm / W < H ? bm / W : H;
  const int images = H * W < bm ? bm / (H * W) : 1;
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(W),
                             static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(images)};
  return encode_tiled(map, 4, x, dims, strides, box);
}

// The box of the tile whose first GEMM row is row0, for a tap that reads
// the pixel (dy, dx) away from each row's own: {x, y, image}.
__device__ __forceinline__ int3 image_box(int row0, int H, int W, int dy,
                                          int dx) {
  const int hw = H * W, b = row0 / hw;
  return make_int3(dx, (row0 - b * hw) / W + dy, b);
}

// D[64 x BN] += A[64 x 16] * B[16 x BN] (N-major: trans-b = 1); A is
// K-major (TA = 0) or M-major (TA = 1: the weight gradient of
// upconv3x3_bwd.cu, whose A is pixels x channels)
template <int BN, int TA = 0>
struct Wgmma;

template <int TA>
struct Wgmma<64, TA> {
  __device__ static __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};

template <int TA>
struct Wgmma<128, TA> {
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
        "%64, %65, p, 1, 1, %67, 1;\n}\n"
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
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};

template <int TA>
struct Wgmma<256, TA> {
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
        "%128, %129, p, 1, 1, %131, 1;\n}\n"
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
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};

// One K slice of 64 channels: four k16 steps of one warpgroup's 64 rows.
// a_addr: the warpgroup's 64 swizzled rows of 128 bytes; b_addr: [64][BN]
// in panels of 64 columns, `b_panel` bytes apart.
template <int BN>
__device__ __forceinline__ void mma_slice(float* acc, uint32_t a_addr,
                                          uint32_t b_addr, uint32_t b_panel) {
#pragma unroll
  for (int k = 0; k < BK / 16; ++k)
    Wgmma<BN>::mma(acc, make_desc(a_addr + k * 32, 16, 1024),
                   make_desc(b_addr + k * 2048, b_panel, 1024));
}

// Where accumulator register i of this thread lies in the warpgroup's
// 64 x BN tile: row = warp*16 + lane/4 + 8*((i>>1)&1), column =
// (i>>2)*8 + (lane%4)*2 + (i&1).
__device__ __forceinline__ int acc_row(int tid128, int i) {
  return (tid128 >> 5) * 16 + ((tid128 & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int tid128, int i) {
  return (i >> 2) * 8 + (tid128 & 3) * 2 + (i & 1);
}

// Epilogue of one warpgroup's 64 x BN accumulators into the block's bf16
// staging tile [BM][BN + 8] (272- or 144-byte rows: the 4-byte stores of a
// warp fall on 32 banks): act(acc*mul + add) in f32.
template <class P, int BN>
__device__ __forceinline__ void stage_out(const P& p, const float* acc,
                                          uint16_t* stage, int wg_row0,
                                          int row0, int co0, int tid128) {
  constexpr int LDS = BN + 8;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int rl = wg_row0 + acc_row(tid128, i), cl = acc_col(tid128, i);
    const int r = min(row0 + rl, p.M - 1), co = min(co0 + cl, p.N - 2);
    const float v0 = apply_act(fmaf(acc[i], p.mul(co), p.add(r, co)), p.act);
    const float v1 =
        apply_act(fmaf(acc[i + 1], p.mul(co + 1), p.add(r, co + 1)), p.act);
    const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(stage + rl * LDS + cl) = o;
  }
}

// The staged [ROWS][BN + 8] tile to group g's output: 16 bytes a thread,
// whole rows of BN channels contiguous.
template <class P, int ROWS, int BN, int THREADS>
__device__ __forceinline__ void store_staged(const P& p, const uint16_t* stage,
                                             int row0, int co0, int tid,
                                             int g) {
  constexpr int LDS = BN + 8, CPR = BN / 8;
  uint16_t* y = static_cast<uint16_t*>(p.y);
  for (int q = tid; q < ROWS * CPR; q += THREADS) {
    const int rl = q / CPR, c8 = (q % CPR) * 8;
    const int r = row0 + rl, co = co0 + c8;
    if (r < p.M && co < p.N)
      *reinterpret_cast<uint4*>(y + p.y_row(r, g) + co) =
          *reinterpret_cast<const uint4*>(stage + rl * LDS + c8);
  }
}

template <int BM, int BN, int STAGES>
struct Tile {
  static constexpr int THREADS = BM * 2;          // one warpgroup per 64 rows
  static constexpr int A_STAGE = BM * 128;        // bytes
  static constexpr int B_STAGE = BK * BN * 2;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  // + 1024: the ring is aligned by hand
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static_assert(BM * (BN + 8) * 2 <= STAGES * STAGE, "staging fits the ring");
};

template <class P, int BM, int BN, int STAGES, bool TMA_B, bool TMA_A>
__global__ void __launch_bounds__(BM * 2, BN == 256 ? 1 : 2)
    wgmma_kernel(P p, float* ws, Split split,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap amap) {
  using T = Tile<BM, BN, STAGES>;
  constexpr int THREADS = T::THREADS;
  constexpr int A_ROWS_PER_PASS = THREADS / 8;             // 8 chunks a row
  constexpr int A_LOADS = BM / A_ROWS_PER_PASS;            // = 4
  constexpr int B_CPR = BN / 8;                            // chunks per k-row
  constexpr int B_LOADS = BK * B_CPR / THREADS;
  constexpr int B_ROWS_PER_PASS = THREADS / B_CPR;
  constexpr uint32_t B_PANEL = BK * 128;                   // 64 k-rows

  extern __shared__ uint8_t smem_raw[];
  __shared__ long long tap_offs[MAX_TAPS];
  __shared__ __align__(8) unsigned long long b_full[STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);

  const int tid = threadIdx.x;
  // the group varies fastest (igemm::Common::group()), then the column
  // tile: the blocks that run together read the same or neighbouring A
  // rows, which then come from device memory once and from L2 after
  constexpr bool GROUPED = P::kGrouped;
  const int g = GROUPED ? blockIdx.x % p.groups : 0;
  const int tile = GROUPED ? blockIdx.x / p.groups : blockIdx.x;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int row0 = (tile / n_tiles) * BM;
  const int co0 = (tile % n_tiles) * BN;
  // this block's share of its group's K: whole taps [tap_lo, tap_hi)
  const int z = blockIdx.z;
  const int parts = GROUPED ? split.parts[g] : split.parts[0];
  if (z >= parts) return;    // a group split in fewer parts than the grid's
  const int taps = GROUPED ? p.group_taps(g) : p.taps;
  const int tap_lo = z * taps / parts, tap_hi = (z + 1) * taps / parts;
  const uint16_t* a = static_cast<const uint16_t*>(p.a);

  if (tid < taps) tap_offs[tid] = p.tap_off(g, tid);
  if (TMA_B && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&b_full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // A: this thread copies chunk (tid & 7) of A_LOADS rows, every slice
  // (unless A comes by TMA, one box a slice)
  const int a_chunk = tid & 7;
  Gather a_row[A_LOADS];
  uint32_t a_dst[A_LOADS];
  if constexpr (!TMA_A) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int rl = (tid >> 3) + i * A_ROWS_PER_PASS;
      a_row[i] = p.gather(row0 + rl, g);
      a_dst[i] = swz(rl, a_chunk);
    }
  }
  // B: chunk (tid % B_CPR) of B_LOADS k-rows
  const int b_cn = tid % B_CPR, b_kr = tid / B_CPR;
  const bool b_valid = co0 + b_cn * 8 < p.N;
  const int b_col = b_valid ? co0 + b_cn * 8 : 0;
  uint32_t b_dst[B_LOADS];
#pragma unroll
  for (int i = 0; i < B_LOADS; ++i)
    b_dst[i] = T::A_STAGE + (b_cn >> 3) * B_PANEL +
               swz(b_kr + i * B_ROWS_PER_PASS, b_cn & 7);

  int n_iter = 0;
  for (int t = tap_lo; t < tap_hi; ++t) n_iter += p.slices(t);
  __syncthreads();   // tap_offs

  int ld_tap = tap_lo, ld_kc = 0;   // the next slice to copy
  auto issue = [&](int stage) {
    const uint32_t st = ring + stage * T::STAGE;
    const int ci0 = ld_kc * BK;
    if constexpr (!TMA_A) {
      const long long off = tap_offs[ld_tap] + ci0 + a_chunk * 8;
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        const bool valid = (a_row[i].taps >> ld_tap) & 1u;
        cp16(st + a_dst[i],
             valid ? a + p.row_off(a_row[i], ld_tap) + off : a, valid);
      }
    }
    if constexpr (TMA_B) {
      // one thread asks for the slice's BN / 64 panels of 64 k-rows (and
      // counts A's box on the same barrier)
      if (tid == 0) {
        const uint32_t bar = smem_u32(&b_full[stage]);
        mbar_expect_tx(bar, T::B_STAGE + (TMA_A ? T::A_STAGE : 0));
        if constexpr (TMA_A) {
          const int3 c = p.a_box(row0, g, ld_tap);
          tma_load_4d(st, &amap, ci0, c.x, c.y, c.z, bar);
        }
        const int krow = p.w_row(g, ld_tap) + ci0;
#pragma unroll
        for (int pn = 0; pn < BN / 64; ++pn)
          tma_load_2d(st + T::A_STAGE + pn * B_PANEL, &wmap, co0 + pn * 64,
                      krow, bar);
      }
    } else {
      const uint16_t* b_src =
          p.w_rows(ld_tap) +
          static_cast<size_t>(ci0 + b_kr) * static_cast<size_t>(p.N) + b_col;
#pragma unroll
      for (int i = 0; i < B_LOADS; ++i)
        cp16(st + b_dst[i],
             b_src + static_cast<size_t>(i * B_ROWS_PER_PASS) * p.N, b_valid);
    }
    if (++ld_kc == p.slices(ld_tap)) {
      ld_kc = 0;
      ++ld_tap;
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7, tid128 = tid & 127;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iter) issue(s);
    cp_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    // slice `it` has landed; every warpgroup has finished the products of
    // slice it-1, whose stage is refilled below
    cp_wait<STAGES - 2>();
    fence_async_proxy();
    if constexpr (TMA_B)
      mbar_wait(smem_u32(&b_full[it % STAGES]), (it / STAGES) & 1);
    __syncthreads();
    // the products first, so that issuing the next copies overlaps them
    const uint32_t st = ring + (it % STAGES) * T::STAGE;
    wgmma_fence();
    mma_slice<BN>(acc, st + wg * 64 * 128, st + T::A_STAGE, B_PANEL);
    wgmma_commit();
    const int nxt = it + STAGES - 1;
    if (nxt < n_iter) issue(nxt % STAGES);
    cp_commit();
    wgmma_wait<0>();
  }
  cp_wait<0>();
  __syncthreads();

  if (parts > 1) {
    // f32 partial sums to plane first[g] + z of the workspace: 8 bytes a
    // thread, a quad 32 bytes
    const int first = GROUPED ? split.first[g] : 0;
    float* plane = ws + static_cast<size_t>(first + z) * p.M * p.N;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = row0 + wg * 64 + acc_row(tid128, i);
      const int co = co0 + acc_col(tid128, i);
      if (r < p.M && co < p.N)
        *reinterpret_cast<float2*>(plane + static_cast<size_t>(r) * p.N +
                                   co) = make_float2(acc[i], acc[i + 1]);
    }
    return;
  }
  uint16_t* stage = reinterpret_cast<uint16_t*>(ring_ptr);
  stage_out<P, BN>(p, acc, stage, wg * 64, row0, co0, tid128);
  __syncthreads();
  store_staged<P, BM, BN, THREADS>(p, stage, row0, co0, tid, g);
}

// y_g = act(sum_s ws[first[g] + s] * mul + add) for every group split in
// more than one part: the partial sums added in the order s = 0..parts-1,
// eight channels a thread.
template <class P>
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(P p, const float* ws, Split split) {
  const int cpr = p.N / 8;
  const long long per_group = static_cast<long long>(p.M) * cpr;
  const long long q =
      static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (q >= per_group * p.groups) return;
  const int g = P::kGrouped ? static_cast<int>(q / per_group) : 0;
  const int parts = P::kGrouped ? split.parts[g] : split.parts[0];
  if (parts < 2) return;     // that group's blocks stored their outputs
  const long long qg = q - g * per_group;
  const int r = static_cast<int>(qg / cpr);
  const int co = static_cast<int>(qg - static_cast<long long>(r) * cpr) * 8;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  const size_t plane = static_cast<size_t>(p.M) * p.N;
  const float* src = ws +
                     static_cast<size_t>(P::kGrouped ? split.first[g] : 0) *
                         plane +
                     static_cast<size_t>(r) * p.N + co;
  for (int s = 0; s < parts; ++s) {
    const float4 lo = *reinterpret_cast<const float4*>(src + s * plane);
    const float4 hi = *reinterpret_cast<const float4*>(src + s * plane + 4);
    v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
    v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
  }
  union {
    uint4 u;
    uint16_t e[8];
  } o;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    o.e[e] = __bfloat16_as_ushort(__float2bfloat16(apply_act(
        fmaf(v[e], p.mul(co + e), p.add(r, co + e)), p.act)));
  *reinterpret_cast<uint4*>(static_cast<uint16_t*>(p.y) + p.y_row(r, g) +
                            co) = o.u;
}

// ---------------------------------------------------------------------------
// Shallow K: a block keeps its group's B panels resident and walks row
// tiles of 128 x 64 (N = 64), see the note at the top.  Two warpgroups of
// 64 rows; shared memory (1024-byte aligned by hand): the A ring
// [RES_STAGES][128 rows][128 bytes], the resident B slices [slices][64
// k-rows][128 bytes], the bf16 staging tile [128][72]: 99 KB at 4 slices.
// Two blocks per SM, each with a 3-deep ring: one block's epilogue and
// barrier hide behind the other's products.  (One block per SM with an
// 8-deep ring and up to 8 slices of weights -- 64 KB, K of 128 channels --
// was slower than the 128x64 ring at every shape on the H100.)
constexpr int RES_BM = 128, RES_BN = 64, RES_MAX_SLICES = 4;
constexpr int RES_STAGES = 3, RES_BLOCKS = 2;
constexpr int RES_THREADS = 256;
constexpr int RES_A_STAGE = RES_BM * 128;
constexpr int RES_B_SLICE = BK * RES_BN * 2;
constexpr int RES_STAGING = RES_BM * (RES_BN + 8) * 2;

inline int resident_smem(int slices) {
  return RES_STAGES * RES_A_STAGE + slices * RES_B_SLICE + RES_STAGING + 1024;
}

template <class P, bool TMA_A>
__global__ void __launch_bounds__(RES_THREADS, RES_BLOCKS)
    resident_kernel(P p, int row_tiles,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap amap) {
  constexpr int A_LOADS = RES_BM / (RES_THREADS / 8);      // = 4
  extern __shared__ uint8_t smem_raw[];
  __shared__ long long tap_offs[MAX_TAPS];
  __shared__ int slice_tap[RES_MAX_SLICES], slice_ci[RES_MAX_SLICES];
  __shared__ int n_slices;
  __shared__ __align__(8) unsigned long long b_full;
  __shared__ __align__(8) unsigned long long a_full[RES_STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t b_res = ring + RES_STAGES * RES_A_STAGE;

  const int tid = threadIdx.x;
  // block b computes group b % G (as igemm::Common::group()) and walks its
  // row tiles b / G, b / G + stride, ...; the grid is a multiple of G
  const int g = blockIdx.x % p.groups;
  const int first = blockIdx.x / p.groups;
  const int stride = gridDim.x / p.groups;
  if (first >= row_tiles) return;
  const int my_tiles = (row_tiles - first + stride - 1) / stride;
  const int taps = p.group_taps(g);
  const uint16_t* a = static_cast<const uint16_t*>(p.a);

  if (tid < taps) tap_offs[tid] = p.tap_off(g, tid);
  if (tid == 0) {
    int ks = 0;
    for (int t = 0; t < taps; ++t)
      for (int kc = 0; kc < p.slices(t); ++kc, ++ks) {
        slice_tap[ks] = t;
        slice_ci[ks] = kc * BK;
      }
    n_slices = ks;
    mbar_init(smem_u32(&b_full), 1);
    if (TMA_A)
      for (int s = 0; s < RES_STAGES; ++s) mbar_init(smem_u32(&a_full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ks = n_slices;
  if (tid == 0) {
    // the group's whole B, once: one 64 x 64 panel per slice
    const uint32_t bar = smem_u32(&b_full);
    mbar_expect_tx(bar, ks * RES_B_SLICE);
    for (int s = 0; s < ks; ++s)
      tma_load_2d(b_res + s * RES_B_SLICE, &wmap, 0,
                  p.w_row(g, slice_tap[s]) + slice_ci[s], bar);
  }

  // A: this thread copies chunk (tid & 7) of A_LOADS rows of every slice;
  // the rows' gathers are decoded when the tile's first slice is issued
  const int a_chunk = tid & 7;
  Gather a_row[A_LOADS];
  uint32_t a_dst[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i)
    a_dst[i] = swz((tid >> 3) + i * (RES_THREADS / 8), a_chunk);

  const int items = my_tiles * ks;      // (tile, slice) pairs, in order
  auto issue = [&](int item) {
    const int k = item / ks, s = item - k * ks;
    const int row0 = (first + k * stride) * RES_BM;
    const uint32_t st = ring + (item % RES_STAGES) * RES_A_STAGE;
    const int tap = slice_tap[s];
    if constexpr (TMA_A) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&a_full[item % RES_STAGES]);
        mbar_expect_tx(bar, RES_A_STAGE);
        const int3 c = p.a_box(row0, g, tap);
        tma_load_4d(st, &amap, slice_ci[s], c.x, c.y, c.z, bar);
      }
      return;
    }
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i)
        a_row[i] = p.gather(row0 + (tid >> 3) + i * (RES_THREADS / 8), g);
    }
    const long long off = tap_offs[tap] + slice_ci[s] + a_chunk * 8;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const bool valid = (a_row[i].taps >> tap) & 1u;
      cp16(st + a_dst[i], valid ? a + p.row_off(a_row[i], tap) + off : a,
           valid);
    }
  };

  float acc[RES_BN / 2];
#pragma unroll
  for (int i = 0; i < RES_BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7, tid128 = tid & 127;
  uint16_t* staging = reinterpret_cast<uint16_t*>(
      smem_raw + (ring - raw) + RES_STAGES * RES_A_STAGE + ks * RES_B_SLICE);

#pragma unroll
  for (int s = 0; s < RES_STAGES - 1; ++s) {
    if (s < items) issue(s);
    cp_commit();
  }
  for (int it = 0; it < items; ++it) {
    // item `it` has landed; the products of item it-1 are done, so its
    // stage is refilled below, and the last tile's staging has been read
    cp_wait<RES_STAGES - 2>();
    fence_async_proxy();
    if (it == 0) mbar_wait(smem_u32(&b_full), 0);
    if constexpr (TMA_A)
      mbar_wait(smem_u32(&a_full[it % RES_STAGES]), (it / RES_STAGES) & 1);
    __syncthreads();
    const int k = it / ks, s = it - k * ks;
    const uint32_t st = ring + (it % RES_STAGES) * RES_A_STAGE;
    wgmma_fence();
    mma_slice<RES_BN>(acc, st + wg * 64 * 128, b_res + s * RES_B_SLICE,
                      RES_B_SLICE);
    wgmma_commit();
    const int nxt = it + RES_STAGES - 1;
    if (nxt < items) issue(nxt);
    cp_commit();
    wgmma_wait<0>();
    if (s == ks - 1) {
      // the tile's epilogue, while the next tile's slices are in flight
      const int row0 = (first + k * stride) * RES_BM;
      stage_out<P, RES_BN>(p, acc, staging, wg * 64, row0, 0, tid128);
      __syncthreads();
      store_staged<P, RES_BM, RES_BN, RES_THREADS>(p, staging, row0, 0, tid,
                                                   g);
#pragma unroll
      for (int i = 0; i < RES_BN / 2; ++i) acc[i] = 0.f;
    }
  }
  cp_wait<0>();
}

// The shapes this path takes (bf16 only; the caller checks the type).
template <class P>
inline bool applies(const P& p) {
  bool taps_ok = p.groups >= 1 && p.groups <= MAX_GROUPS;
  for (int g = 0; taps_ok && g < p.groups; ++g)
    taps_ok = p.group_taps(g) <= MAX_TAPS;
  return p.Cin % BK == 0 && p.N % 64 == 0 && taps_ok && p.vec_a &&
         p.vec_w && p.vec_y;
}

// The tiles in the order of the callers' tile argument; kResident128x64 is
// resident_kernel (N = 64, every group's K at most RES_MAX_SLICES slices,
// one weight matrix, no split).
enum TileId {
  k128x128 = 0, k128x64 = 1, k64x128 = 2, k128x256 = 3, kResident128x64 = 4
};

template <class P>
cudaError_t weight_map(const P& p, CUtensorMap* wmap) {
  return make_weight_map(wmap, p.w, static_cast<uint64_t>(p.weight_rows()),
                         p.N);
}

template <class P, int BM, int BN, int STAGES, bool TMA_A>
cudaError_t launch_tile_a(const P& p, float* ws, const Split& split, int most,
                          cudaStream_t s) {
  using T = Tile<BM, BN, STAGES>;
  constexpr bool TMA_B = P::kOneWeightMatrix;
  auto kernel = wgmma_kernel<P, BM, BN, STAGES, TMA_B, TMA_A>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap wmap = {}, amap = {};
  if constexpr (TMA_B) {
    err = weight_map(p, &wmap);
    if (err != cudaSuccess) return err;
  }
  if constexpr (TMA_A) {
    err = p.a_map(&amap, BM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.M + BM - 1) / BM * ((p.N + BN - 1) / BN) * p.groups, 1,
                  most);
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(p, ws, split, wmap, amap);
  return cudaGetLastError();
}

// A by TMA where the problem's rows are image pixels, its weights one
// matrix and its tiles whole image rows; gathered by cp.async otherwise.
template <class P, int BM, int BN, int STAGES>
cudaError_t launch_tile(const P& p, float* ws, const Split& split, int most,
                        cudaStream_t s) {
  if constexpr (P::kImageA && P::kOneWeightMatrix) {
    if (p.a_boxes(BM))
      return launch_tile_a<P, BM, BN, STAGES, true>(p, ws, split, most, s);
  }
  return launch_tile_a<P, BM, BN, STAGES, false>(p, ws, split, most, s);
}

template <class P, bool TMA_A>
cudaError_t launch_resident_a(const P& p, int slices, cudaStream_t s) {
  const int smem = resident_smem(slices);
  auto kernel = resident_kernel<P, TMA_A>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap wmap = {}, amap = {};
  if ((err = weight_map(p, &wmap)) != cudaSuccess) return err;
  if constexpr (TMA_A) {
    if ((err = p.a_map(&amap, RES_BM)) != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int row_tiles = (p.M + RES_BM - 1) / RES_BM;
  const int slots = RES_BLOCKS * sms / p.groups;
  const int per_group = slots < row_tiles ? slots : row_tiles;
  kernel<<<per_group * p.groups, RES_THREADS, smem, s>>>(p, row_tiles, wmap,
                                                         amap);
  return cudaGetLastError();
}

template <class P>
cudaError_t launch_resident(const P& p, cudaStream_t s) {
  if constexpr (!P::kOneWeightMatrix) {
    return cudaErrorInvalidValue;
  } else {
    int most = 0;
    for (int g = 0; g < p.groups; ++g) {
      const int ks = p.group_taps(g) * (p.Cin / BK);
      most = ks > most ? ks : most;
    }
    if (p.N != RES_BN || most > RES_MAX_SLICES) return cudaErrorInvalidValue;
    if constexpr (P::kImageA) {
      if (p.a_boxes(RES_BM)) return launch_resident_a<P, true>(p, most, s);
    }
    return launch_resident_a<P, false>(p, most, s);
  }
}

// Launches the wgmma GEMM on `s` with the caller's tile and, per group, the
// number of parts of K (whole taps each; parts[g] > 1 for any group needs
// the f32 workspace of one [M][N] plane per part of every split group
// and runs the reduce kernel after it).  Stages are
// sized so that two blocks fit one SM (at most 97 KB a block), except for
// 128x256 and the resident kernel (one).  Returns the CUDA error of the
// launches.
template <class P>
cudaError_t launch(const P& p, int tile, const int* parts, float* ws,
                   cudaStream_t s) {
  if (p.groups < 1 || p.groups > MAX_GROUPS) return cudaErrorInvalidValue;
  Split split = {};
  int planes = 0, most = 1;
  for (int g = 0; g < p.groups; ++g) {
    const int n = parts[g];
    if (n < 1 || n > MAX_SPLIT || n > p.group_taps(g))
      return cudaErrorInvalidValue;
    split.parts[g] = n;
    split.first[g] = n > 1 ? planes : 0;
    planes += n > 1 ? n : 0;
    most = n > most ? n : most;
  }
  if (planes > 0 && ws == nullptr) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (tile) {
    case k128x128: err = launch_tile<P, 128, 128, 3>(p, ws, split, most, s); break;
    case k128x64: err = launch_tile<P, 128, 64, 4>(p, ws, split, most, s); break;
    case k64x128: err = launch_tile<P, 64, 128, 4>(p, ws, split, most, s); break;
    case k128x256: err = launch_tile<P, 128, 256, 4>(p, ws, split, most, s); break;
    case kResident128x64:
      return planes > 0 ? cudaErrorInvalidValue
                        : launch_resident(p, s);
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || planes == 0) return err;
  const long long chunks = static_cast<long long>(p.M) * (p.N / 8) * p.groups;
  splitk_reduce_kernel<P>
      <<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(p, ws,
                                                                   split);
  return cudaGetLastError();
}

}  // namespace igemm90
