// Cycles a wgmma instruction takes on the card, by shape and operand
// layout: one warpgroup alone (128 threads) and two together (256), each
// issuing 16 products a commit group into the same accumulators (or, in
// one line, into four sets in turn, as upconv_co32.cuh's parities), 200
// times, on every SM.  A is K-major in the 128-byte swizzle at a
// 1024-byte-aligned start or at starts shifted by whole 128-byte rows (as
// upconv_co32.cuh and upconv_dx.cuh read staged pixels); B is N-major in
// the 64-byte swizzle (32-column panels, upconv_co32.cuh's weights) or in
// the 128-byte swizzle, or K-major (upconv_dx.cuh).  Built and run by
// wgmma_probe.py.
#include <cstdio>
#include "upconv_co32.cuh"
#include "upconv_dx.cuh"

template <int KIND>
__global__ void __launch_bounds__(256, 1) probe(long long* out, int iters) {
  extern __shared__ __align__(1024) uint8_t sm[];
  const uint32_t base = (igemm90::smem_u32(sm) + 1023u) & ~1023u;
  for (int i = threadIdx.x; i < 200 * 1024 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(sm)[i] = 0x3c003c00u;
  __syncthreads();
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const int wg = threadIdx.x >> 7;
  const uint32_t a_base = base + wg * 32768;      // A region per wg
  const uint32_t b_base = base + 65536;           // B shared
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    igemm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t shift = (KIND & 16) ? 128 * ((k % 3) + 1) : 0;
      const uint64_t a = dx90::desc<128>(a_base + shift) + 2 * (k & 3);
      if constexpr ((KIND & 15) == 0) up32::mma32(acc, a, up32::b_desc(b_base + (k & 3) * 1024), 1);
      if constexpr ((KIND & 15) == 7) up32::mma32(acc + 16 * (k & 3), a, up32::b_desc(b_base + (k & 3) * 1024), 1);
      if constexpr ((KIND & 15) == 1) igemm90::Wgmma<64>::mma(acc, a, up32::b_desc(b_base + (k & 3) * 1024));
      if constexpr ((KIND & 15) == 2) igemm90::Wgmma<128>::mma(acc, a, up32::b_desc(b_base + (k & 3) * 1024));
      if constexpr ((KIND & 15) == 3) dx90::Mma<128>::mma(acc, a, dx90::desc<128>(b_base + (k & 3) * 32));
      if constexpr ((KIND & 15) == 4) dx90::Mma<64>::mma(acc, a, dx90::desc<128>(b_base + (k & 3) * 32));
      if constexpr ((KIND & 15) == 5) dx90::Mma<256>::mma(acc, a, dx90::desc<128>(b_base + (k & 3) * 32));
      if constexpr ((KIND & 15) == 6) igemm90::Wgmma<64>::mma(acc, a, igemm90::make_desc(b_base + (k & 3) * 2048, 8192, 1024));
    }
    igemm90::wgmma_commit();
    igemm90::wgmma_wait<0>();
  }
  long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += acc[i];
  if ((threadIdx.x & 127) == 0) { out[blockIdx.x * 2 + wg] = t1 - t0; if (s == 12345.f) out[0] = 0; }
}

template <int KIND>
void run(const char* name, int threads) {
  long long* d; cudaMalloc(&d, 132 * 2 * sizeof(long long));
  auto k = probe<KIND>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 201 * 1024);
  const int iters = 200;
  k<<<132, threads, 201 * 1024>>>(d, iters);
  cudaError_t e = cudaDeviceSynchronize();
  long long h[2]; cudaMemcpy(h, d, 2 * sizeof(long long), cudaMemcpyDeviceToHost);
  printf("%-44s threads %3d: %7.1f clk per instruction per wg (%s)\n", name, threads,
         (double)h[0] / (iters * 16), cudaGetErrorString(e));
  cudaFree(d);
}

int main() {
  for (int threads : {128, 256}) {
    run<0>("m64n32k16 A K128 aligned, B MN SW64", threads);
    run<16>("m64n32k16 A K128 shifted, B MN SW64", threads);
    run<23>("m64n32k16 shifted, 4 accumulator sets", threads);
    run<1>("m64n64k16 A aligned, B MN SW64 2 panels", threads);
    run<17>("m64n64k16 A shifted, B MN SW64 2 panels", threads);
    run<2>("m64n128k16 A aligned, B MN SW64 4 panels", threads);
    run<18>("m64n128k16 A shifted, B MN SW64 4 panels", threads);
    run<6>("m64n64k16 A aligned, B MN SW128", threads);
    run<4>("m64n64k16 A aligned, B K SW128", threads);
    run<3>("m64n128k16 A aligned, B K SW128", threads);
    run<19>("m64n128k16 A shifted, B K SW128", threads);
    run<5>("m64n256k16 A aligned, B K SW128", threads);
  }
  int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  printf("clock rate attr %d kHz\n", clk);
  return 0;
}
