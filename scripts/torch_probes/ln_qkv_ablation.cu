// Probe: where kernel G (fused_ln_qkv_int8) spends its time, by leaving
// parts out. It carries its own copy of the streaming loop so that each part
// can be switched off with a flag; results with a part missing are wrong by
// construction, only the times mean anything.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o ln_qkv_ablation scripts/torch_probes/ln_qkv_ablation.cu && ./ln_qkv_ablation
//
// The probe keeps the first version's loop (tile positions by integer
// division, every load address worked out per tile); -DWITH_COUNTERS swaps
// the divisions for counters. Row quantisation is the shared header's.
// Read on an NVIDIA H100 80GB HBM3 at 700 W, [93,312, 1152] x [1152, 3456]:
//   with the first row quantiser (row re-read in four passes, a division per
//   value): as is 3.859 ms; two stages 3.843; no weight loads 2.704; no
//   stores 3.739; no row quantisation 2.910; no loads, no stores 2.570; no
//   loads, stores or quantisation 1.614; and no barrier either 1.364;
//   with rows in registers and `quant8_chunk`: as is 3.249 (3.110 with
//   counters); no weight loads 2.173 (2.091); no row quantisation 2.910
//   (2.813); loads' address arithmetic kept but no copy started 3.212.
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

#include "../../videoitg_tpu_torch/csrc/int8_common.cuh"
using namespace videoitg;

// The first version's weight-tile loader: every address worked out per tile.
template <int BN>
__device__ __forceinline__ void load_w_tile(int8_t* dst, const int8_t* __restrict__ w, int n0,
                                            int k0, int N, int K) {
  for (int idx = threadIdx.x; idx < BN * 4; idx += kI8Threads) {
    const int r = idx >> 2;
    const int c = (idx & 3) * 16;
    const bool valid = (n0 + r < N) && (k0 + c < K);
    const int8_t* src = valid ? w + static_cast<size_t>(n0 + r) * K + k0 + c : w;
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * kI8BStride + c));
    const int bytes = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(d), "l"(src), "r"(bytes));
  }
}

// FLAGS: 1 = no weight loads in the loop, 2 = no epilogue stores, 4 = no row
// quantisation, 8 = no barrier in the loop (racy: timing only).
template <int STAGES, int FLAGS, class Epi>
__device__ __forceinline__ void stream(const int8_t* as, int a_stride, const int8_t* __restrict__ w,
                                       int N, int K, int8_t* bs, int first_n_tile, Epi epi) {
  constexpr int WN = 4, MT = 4, NT = 4, BN = WN * NT * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int nk = (K + kI8BK - 1) / kI8BK, nn = (N + BN - 1) / BN, total = nn * nk;
  int acc[MT][NT][4];
  auto fetch = [&](int j) {
    if (j < total && !(FLAGS & 1)) {
      load_w_tile<BN>(bs + (j % STAGES) * BN * kI8BStride, w, ((j / nk + first_n_tile) % nn) * BN,
                      (j % nk) * kI8BK, N, K);  // addresses worked out per tile, as it first was
    }
    cp_async_commit();
  };
  for (int j = 0; j < STAGES - 1; ++j) fetch(j);
#ifdef WITH_COUNTERS
  int nt_blk = first_n_tile % nn, kt = 0;
#endif
  for (int j = 0; j < total; ++j) {
#ifndef WITH_COUNTERS
    const int nt_blk = (j / nk + first_n_tile) % nn, kt = j % nk;
#endif
    cp_async_wait<STAGES - 2>();
    if (!(FLAGS & 8)) __syncthreads();
    fetch(j + STAGES - 1);
    if (kt == 0) {
      for (int mt = 0; mt < MT; ++mt)
        for (int nt = 0; nt < NT; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
    }
    warp_mma<MT, NT>(acc, as + wm * MT * 16 * a_stride + kt * kI8BK, a_stride,
                         bs + (j % STAGES) * BN * kI8BStride + wn * NT * 8 * kI8BStride, g, t);
    if (kt == nk - 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int row = wm * MT * 16 + mt * 16 + g;
          const int col = nt_blk * BN + wn * NT * 8 + nt * 8 + 2 * t;
          if (col < N) {
            epi(row, col, acc[mt][nt][0], acc[mt][nt][1]);
            epi(row + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
          }
        }
    }
#ifdef WITH_COUNTERS
    if (++kt == nk) {
      kt = 0;
      if (++nt_blk == nn) nt_blk = 0;
    }
#endif
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int FLAGS, int STAGES>
__global__ void __launch_bounds__(256)
probe(const __nv_bfloat16* x, const float* lns, const float* lnb, const int8_t* w, const float* s,
      const float* b, __nv_bfloat16* q, int rows, int H, int N, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int a_stride = H + 16;
  int8_t* as = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* bs = as + 128 * a_stride;
  float* rs = reinterpret_cast<float*>(bs + STAGES * 128 * kI8BStride);
  const int row0 = blockIdx.x * 128;
  if (!(FLAGS & 4)) {
    quantize_rows<true>(as, a_stride, rs, x, lns, lnb, eps, row0, 128, rows, H, H);
  } else if (threadIdx.x < 128) {
    rs[threadIdx.x] = 1.f;
  }
  __syncthreads();
  stream<STAGES, FLAGS>(as, a_stride, w, N, H, bs, blockIdx.x, [&](int row, int col, int v0, int v1) {
    const int grow = row0 + row;
    if (grow >= rows) return;
    const float ys = rs[row];
    const float h0 = scale_bias(v0, ys, s[col], b[col]);
    const float h1 = scale_bias(v1, ys, s[col + 1], b[col + 1]);
    if (!(FLAGS & 2) || h0 == 123.456f) {
      *reinterpret_cast<uint32_t*>(q + static_cast<size_t>(grow) * N + col) = pack_bf16x2(h0, h1);
    }
  });
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
  f();
  f();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 3;
}

template <int FLAGS, int STAGES>
void run(const char* name, void** p, int rows, int H, int N) {
  const int smem = 128 * (H + 16) + STAGES * 128 * kI8BStride + 512;
  cudaFuncSetAttribute(probe<FLAGS, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const float ms = time_ms([&] {
    probe<FLAGS, STAGES><<<(rows + 127) / 128, 256, smem>>>(
        (const __nv_bfloat16*)p[0], (const float*)p[1], (const float*)p[2], (const int8_t*)p[3],
        (const float*)p[4], (const float*)p[5], (__nv_bfloat16*)p[6], rows, H, N, 1e-6f);
  });
  printf("%-45s %.3f ms  %s\n", name, ms, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  const int rows = 93312, H = 1152, N = 3456;
  void* p[7];
  cudaMalloc(&p[0], (size_t)rows * H * 2);
  cudaMemset(p[0], 0x3c, (size_t)rows * H * 2);
  cudaMalloc(&p[1], H * 4);
  cudaMalloc(&p[2], H * 4);
  cudaMemset(p[1], 0, H * 4);
  cudaMemset(p[2], 0, H * 4);
  cudaMalloc(&p[3], (size_t)N * H);
  cudaMemset(p[3], 1, (size_t)N * H);
  cudaMalloc(&p[4], N * 4);
  cudaMalloc(&p[5], N * 4);
  cudaMemset(p[4], 0, N * 4);
  cudaMemset(p[5], 0, N * 4);
  cudaMalloc(&p[6], (size_t)rows * N * 2);
  run<0, 4>("as is (4 stages)", p, rows, H, N);
  run<0, 2>("2 stages", p, rows, H, N);
  run<1, 4>("no weight loads", p, rows, H, N);
  run<2, 4>("no epilogue stores", p, rows, H, N);
  run<4, 4>("no row quantisation", p, rows, H, N);
  run<3, 4>("no loads, no stores", p, rows, H, N);
  run<7, 4>("no loads, no stores, no quantisation", p, rows, H, N);
  run<15, 4>("... and no barrier", p, rows, H, N);
  run<8, 4>("only: no barrier", p, rows, H, N);
  return 0;
}
