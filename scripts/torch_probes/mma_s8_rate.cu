// Probe: what mma.sync m16n8k32 s8 can do on the card, without any feeding.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o mma_s8_rate scripts/torch_probes/mma_s8_rate.cu && ./mma_s8_rate
//
// `regs`: MT x NT independent accumulators, operands held in registers.
// `smem`: the int8 kernels' inner loop (`warp_mma`, fragments read from
// shared memory every k step), with no global loads and no barriers.
// Read on an NVIDIA H100 80GB HBM3 at 700 W: regs 4x4 1,180 to 1,210 TOP/s,
// regs 4x8 1,255, regs 2x2 1,234; smem 4x4 1,077, smem 4x8 1,054, smem 2x2
// 694 TOP/s. The kernels around this loop reach 90 to 250 TOP/s: feeding the
// loop, not the loop, is their limit.
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

#include "../../videoitg_tpu_torch/csrc/int8_common.cuh"
using namespace videoitg;

template <int MT, int NT>
__global__ void __launch_bounds__(256) regs_only(int iters, int* out) {
  int acc[MT][NT][4] = {};
  uint32_t a[MT][4], b[NT][2];
  for (int i = 0; i < MT; ++i)
    for (int j = 0; j < 4; ++j) a[i][j] = threadIdx.x + i + j;
  for (int i = 0; i < NT; ++i)
    for (int j = 0; j < 2; ++j) b[i][j] = threadIdx.x * 3 + i + j;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_s8_16832(acc[mt][nt], a[mt], b[nt]);
  }
  int s = 0;
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < NT; ++nt)
      for (int j = 0; j < 4; ++j) s += acc[mt][nt][j];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

template <int MT, int NT>
__global__ void __launch_bounds__(256) smem_frags(int iters, int a_stride, int* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  int8_t* bs = as + 128 * a_stride;
  for (int i = threadIdx.x; i < 128 * a_stride + 256 * kI8BStride; i += 256) smem[i] = i;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int acc[MT][NT][4] = {};
  for (int it = 0; it < iters; ++it) {
    warp_mma<MT, NT>(acc, as + (warp / 4) * (MT * 16) * a_stride + (it % 8) * 64, a_stride,
                         bs + (warp % 4) * (NT * 8) * kI8BStride, g, t);
  }
  int s = 0;
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < NT; ++nt)
      for (int j = 0; j < 4; ++j) s += acc[mt][nt][j];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

template <class F>
float time_ms(F f) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  f();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  f();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

int main() {
  int* out;
  cudaMalloc(&out, 264 * 256 * 4);
  const int iters = 20000;
  auto report = [&](const char* name, float ms, double mmas_per_warp_iter, int blocks) {
    const double ops = 2.0 * 4096 * mmas_per_warp_iter * iters * 8.0 * blocks;
    printf("%s: %.3f ms, %.1f TOP/s\n", name, ms, ops / ms / 1e9);
  };
  report("regs 4x4, 1 block/SM", time_ms([&] { regs_only<4, 4><<<132, 256>>>(iters, out); }), 16, 132);
  report("regs 4x4, 2 blocks/SM", time_ms([&] { regs_only<4, 4><<<264, 256>>>(iters, out); }), 16, 264);
  report("regs 4x8, 1 block/SM", time_ms([&] { regs_only<4, 8><<<132, 256>>>(iters, out); }), 32, 132);
  report("regs 2x2, 2 blocks/SM", time_ms([&] { regs_only<2, 2><<<264, 256>>>(iters, out); }), 4, 264);
  const int smem = 128 * 1168 + 256 * kI8BStride;
  cudaFuncSetAttribute(smem_frags<4, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(smem_frags<4, 8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(smem_frags<2, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  report("smem 4x4, 1 block/SM", time_ms([&] { smem_frags<4, 4><<<132, 256, smem>>>(iters, 1168, out); }), 32, 132);
  report("smem 4x8, 1 block/SM", time_ms([&] { smem_frags<4, 8><<<132, 256, smem>>>(iters, 1168, out); }), 64, 132);
  report("smem 2x2, 1 block/SM", time_ms([&] { smem_frags<2, 2><<<132, 256, smem>>>(iters, 1168, out); }), 8, 132);
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
