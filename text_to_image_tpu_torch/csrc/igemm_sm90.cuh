// Implicit GEMM on Hopper's warpgroup matrix unit (wgmma, sm_90a): the
// aligned bf16 path of conv5x5_s2.cu and of conditioning_join.cu.
//
//   Y[r, co] = act(sum_k A[r, k] * Wt[k, co] * mul(co) + add(r, co)),
//   r < M, co < N
//
// Same problem as igemm.cuh (K walked as `taps` taps of Cin channels, A rows
// gathered, weights [taps][Cin][N] row-major), for bf16 with Cin % 64 == 0,
// N % 64 == 0, taps <= 32 and 16-byte-aligned pointers.  A problem type P is
// the one igemm.cuh takes (its `add`, and Common's `mul`, `y_row` and
// `groups`, are read here too) plus the gather in hoisted form:
//
//   struct P : igemm::Common {
//     // decoded once per row: element offsets from `a` of the row's tap 0,
//     // channel 0 (it may lie outside the tensor) and bit t set where tap t
//     // reads inside it
//     __device__ igemm90::Gather gather(int r) const;    // any r, even >= M
//     // which of the row's offsets tap t starts from (Gather::base, or
//     // base2 for a problem whose taps read two tensors)
//     __device__ long long row_off(const Gather&, int tap) const;
//     // element offset of tap t from there: the same for every row
//     __device__ long long tap_off(int tap) const;
//     // 64-channel slices of tap t
//     __device__ int slices(int tap) const;
//     // the weights: one row-major matrix [rows][N] at `w`, of which tap t
//     // reads from row w_row(t) -- then TMA brings them, one thread asking
//     // for whole swizzled panels -- or a pointer per tap, copied by cp.async
//     static constexpr bool kOneWeightMatrix;
//     __device__ int w_row(int tap) const;                 // if it is one
//     __device__ const uint16_t* w_rows(int tap) const;    // if it is not
//   };
//
// so that inside the K loop a tap costs one table read, one bit test and a
// few adds per 16-byte copy, and no division.
//
// What bounds it: the deep layers are bound by tensor-core operations (see
// conv5x5_s2.cu), and only wgmma reaches that rate.  Design:
//  * K slices of 64 channels: one slice is a 128-byte row per A row, the
//    width of the 128-byte shared-memory swizzle, and never straddles a tap.
//  * A tile [BM][64] K-major, B tile [64][BN] N-major as the weights lie in
//    memory (the descriptor's transpose bit, no packing launch), both in the
//    128-byte-swizzled layout wgmma reads without bank conflicts: 16-byte
//    chunk c of 128-byte row r sits at chunk c ^ (r & 7); B is split in
//    panels of 64 output channels.
//  * A ring of stages in shared memory, one __syncthreads per slice of four
//    k16 wgmma steps.  A is gathered by cp.async, 16 bytes a thread,
//    zero-filled where the tap lies outside the image.  The weights of a
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
//    waves).  The blocks that run together are the column tiles of the same
//    rows, so A comes from device memory once and from L2 after.  Tried and
//    not kept: a copy-only warpgroup handing stages over through mbarriers
//    (slower: one warpgroup of cp.async cannot feed two of wgmma), and one
//    group of products kept in flight over the barrier (no gain).
//  * Epilogue from the registers: mul/add/act in f32, bf16 through shared
//    memory, whole NHWC rows stored 16 bytes a thread.  Each output once.
//  * Split K over whole taps (blockIdx.z) for calls with too few tiles for
//    132 SMs: f32 partial sums go to a workspace [split][M][N] and
//    splitk_reduce_kernel adds them in the fixed order 0..split-1 before
//    the epilogue: no atomics, the same bits every run.

#pragma once

#include <cuda.h>

#include "igemm.cuh"

namespace igemm90 {

using igemm::apply_act;

constexpr int BK = 64;            // channels per K slice (128 bytes)
constexpr int MAX_TAPS = 32;      // the gather's mask is 32 bits
constexpr int MAX_SPLIT = 5;

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

// A tensor map of a row-major bf16 matrix [rows][cols] for boxes of 64 rows
// by 64 columns (one swizzled panel).  cuTensorMapEncodeTiled is reached
// through the runtime, so the library links against no driver stub.
inline cudaError_t make_weight_map(CUtensorMap* map, const void* w,
                                   uint64_t rows, uint64_t cols) {
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
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, 64}, elem[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// D[64 x BN] += A[64 x 16] (K-major) * B[16 x BN] (N-major: trans-b = 1)
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
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
struct Wgmma<128> {
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
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
struct Wgmma<256> {
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
        "%128, %129, p, 1, 1, 0, 1;\n}\n"
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

// The staged [ROWS][BN + 8] tile to the output: 16 bytes a thread, whole
// rows of BN channels contiguous.
template <class P, int ROWS, int BN, int THREADS>
__device__ __forceinline__ void store_staged(const P& p, const uint16_t* stage,
                                             int row0, int co0, int tid) {
  constexpr int LDS = BN + 8, CPR = BN / 8;
  uint16_t* y = static_cast<uint16_t*>(p.y);
  for (int q = tid; q < ROWS * CPR; q += THREADS) {
    const int rl = q / CPR, c8 = (q % CPR) * 8;
    const int r = row0 + rl, co = co0 + c8;
    if (r < p.M && co < p.N)
      *reinterpret_cast<uint4*>(y + p.y_row(r) + co) =
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

template <class P, int BM, int BN, int STAGES, bool TMA_B>
__global__ void __launch_bounds__(BM * 2, BN == 256 ? 1 : 2)
    wgmma_kernel(P p, float* ws, int split,
                 const __grid_constant__ CUtensorMap wmap) {
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
  // column tiles vary fastest: the blocks that run together read the same
  // A rows, which then come from device memory once and from L2 after
  const int n_tiles = (p.N + BN - 1) / BN;
  const int row0 = (blockIdx.x / n_tiles) * BM;
  const int co0 = (blockIdx.x % n_tiles) * BN;
  const uint16_t* a = static_cast<const uint16_t*>(p.a);

  if (tid < p.taps) tap_offs[tid] = p.tap_off(tid);
  if (TMA_B && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&b_full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // A: this thread copies chunk (tid & 7) of A_LOADS rows, every slice
  const int a_chunk = tid & 7;
  Gather a_row[A_LOADS];
  uint32_t a_dst[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int rl = (tid >> 3) + i * A_ROWS_PER_PASS;
    a_row[i] = p.gather(row0 + rl);
    a_dst[i] = swz(rl, a_chunk);
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

  // this block's share of K: whole taps [tap_lo, tap_hi)
  const int z = blockIdx.z;
  const int tap_lo = z * p.taps / split, tap_hi = (z + 1) * p.taps / split;
  int n_iter = 0;
  for (int t = tap_lo; t < tap_hi; ++t) n_iter += p.slices(t);
  __syncthreads();   // tap_offs

  int ld_tap = tap_lo, ld_kc = 0;   // the next slice to copy
  auto issue = [&](int stage) {
    const uint32_t st = ring + stage * T::STAGE;
    const int ci0 = ld_kc * BK;
    const long long off = tap_offs[ld_tap] + ci0 + a_chunk * 8;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const bool valid = (a_row[i].taps >> ld_tap) & 1u;
      cp16(st + a_dst[i],
           valid ? a + p.row_off(a_row[i], ld_tap) + off : a, valid);
    }
    if constexpr (TMA_B) {
      // one thread asks for the slice's BN / 64 panels of 64 k-rows
      if (tid == 0) {
        const uint32_t bar = smem_u32(&b_full[stage]);
        mbar_expect_tx(bar, T::B_STAGE);
        const int krow = p.w_row(ld_tap) + ci0;
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

  if (split > 1) {
    // f32 partial sums to ws[z][M][N]: 8 bytes a thread, a quad 32 bytes
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = row0 + wg * 64 + acc_row(tid128, i);
      const int co = co0 + acc_col(tid128, i);
      if (r < p.M && co < p.N)
        *reinterpret_cast<float2*>(
            ws + (static_cast<size_t>(z) * p.M + r) * p.N + co) =
            make_float2(acc[i], acc[i + 1]);
    }
    return;
  }
  uint16_t* stage = reinterpret_cast<uint16_t*>(ring_ptr);
  stage_out<P, BN>(p, acc, stage, wg * 64, row0, co0, tid128);
  __syncthreads();
  store_staged<P, BM, BN, THREADS>(p, stage, row0, co0, tid);
}

// y = act(sum_s ws[s] * mul + add): the split-K partial sums added in the
// order s = 0..split-1, eight channels a thread.
template <class P>
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(P p, const float* ws, int split) {
  const int cpr = p.N / 8;
  const long long q =
      static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (q >= static_cast<long long>(p.M) * cpr) return;
  const int r = static_cast<int>(q / cpr);
  const int co = static_cast<int>(q - static_cast<long long>(r) * cpr) * 8;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  const size_t plane = static_cast<size_t>(p.M) * p.N;
  const float* src = ws + static_cast<size_t>(r) * p.N + co;
  for (int s = 0; s < split; ++s) {
    const float4 lo = *reinterpret_cast<const float4*>(src + s * plane);
    const float4 hi = *reinterpret_cast<const float4*>(src + s * plane + 4);
    v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
    v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
  }
  igemm::store_out<P, true>(p, r, co, v, 8);
}

// The shapes this path takes (bf16 only; the caller checks the type).
template <class P>
inline bool applies(const P& p) {
  return p.Cin % BK == 0 && p.N % 64 == 0 && p.taps <= MAX_TAPS && p.vec_a &&
         p.vec_w && p.vec_y;
}

enum TileId { k128x128 = 0, k128x64 = 1, k64x128 = 2, k128x256 = 3 };

template <class P, int BM, int BN, int STAGES>
cudaError_t launch_tile(const P& p, float* ws, int split, cudaStream_t s) {
  using T = Tile<BM, BN, STAGES>;
  constexpr bool TMA_B = P::kOneWeightMatrix;
  auto kernel = wgmma_kernel<P, BM, BN, STAGES, TMA_B>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap wmap = {};
  if constexpr (TMA_B) {
    err = make_weight_map(&wmap, p.w,
                          static_cast<uint64_t>(p.taps) * p.Cin, p.N);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.M + BM - 1) / BM * ((p.N + BN - 1) / BN), 1, split);
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(p, ws, split, wmap);
  return cudaGetLastError();
}

// Launches the wgmma GEMM on `s` with the caller's tile and split of K
// (whole taps; split > 1 needs the f32 workspace [split][M][N] and runs the
// reduce kernel after it).  Stages are sized so that two blocks fit one SM
// (at most 97 KB a block).  Returns the CUDA error of the launches.
template <class P>
cudaError_t launch(const P& p, int tile, int split, float* ws,
                   cudaStream_t s) {
  if (split < 1 || split > MAX_SPLIT || split > p.taps ||
      p.groups != 1 || (split > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (tile) {
    case k128x128: err = launch_tile<P, 128, 128, 3>(p, ws, split, s); break;
    case k128x64: err = launch_tile<P, 128, 64, 4>(p, ws, split, s); break;
    case k64x128: err = launch_tile<P, 64, 128, 4>(p, ws, split, s); break;
    case k128x256: err = launch_tile<P, 128, 256, 4>(p, ws, split, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || split == 1) return err;
  const long long chunks = static_cast<long long>(p.M) * (p.N / 8);
  splitk_reduce_kernel<P>
      <<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(p, ws,
                                                                   split);
  return cudaGetLastError();
}

}  // namespace igemm90
