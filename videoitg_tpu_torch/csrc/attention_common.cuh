// Shared pieces of the TMA + wgmma attention kernels (hopper_attention*.cuh):
// the row reductions, log2 e, and the dispatch over head dims.
//
// A consumer thread owns two query rows of its warp's 16 (lane / 4 and
// lane / 4 + 8) and, of each row, the columns 2 t and 2 t + 1 of every 8,
// t = lane % 4: the four threads of a quad share a row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace videoitg {

constexpr float kLog2e = 1.4426950408889634f;

// Reductions over the 4 threads (t = 0..3) that share a query row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One instantiation per head dim padded to a multiple of 16.
#define VIDEOITG_DISPATCH_DP(launch, args)                     \
  switch (((args).D + 15) / 16) {                              \
    case 1: return static_cast<int>(launch<16>(args));         \
    case 2: return static_cast<int>(launch<32>(args));         \
    case 3: return static_cast<int>(launch<48>(args));         \
    case 4: return static_cast<int>(launch<64>(args));         \
    case 5: return static_cast<int>(launch<80>(args));         \
    case 6: return static_cast<int>(launch<96>(args));         \
    case 7: return static_cast<int>(launch<112>(args));        \
    default: return static_cast<int>(launch<128>(args));       \
  }

}  // namespace videoitg
