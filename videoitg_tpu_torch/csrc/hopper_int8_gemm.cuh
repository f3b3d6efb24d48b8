// The TMA + s8 wgmma GEMM behind every int8 product of the act8 tier: kernels
// F (quant_gemm.cu) and G, H, I (fused_encoder.cu). sm_90a.
//
// out tile [128][256] of A (int8 [M][K]) x B^T (int8 [N][K]), both K-major
// in device memory, an exact int32 sum, handed to an epilogue policy. A block
// is two consumer warpgroups of 64 rows each and a producer warpgroup of
// which one warp works, as in the attention kernels (hopper_attention.cuh),
// one block an SM. The producer keeps a ring of stages in flight by TMA, each
// stage 128 bytes of k of A [128][128] and B [256][128], one box per operand
// with the 128-byte swizzle. Consumers wait on a stage's `full` barrier,
// issue its four m64n256k32.s32.s8.s8 wgmmas (a k32 step is 32 bytes: it
// advances the descriptor's start by 32 bytes inside the 1024-byte-aligned
// swizzle atom), commit, and release the stage before (its wgmmas have
// completed once at most one group is in flight) on its `empty` barrier.
// Nothing is transposed: TMA writes the swizzled layout wgmma reads, K-major
// for both operands (the only layout the s8 MMA takes). TMA's zero fill
// covers the rows past M, the rows past N and the bytes past K (K % 32 may be
// 16: fc2's K = 4304 is 134.5 k32 steps, and the last one is half zeros in
// both operands). Four 32-byte boxes a stage with the 32-byte swizzle of the
// attention kernels, 64-row tiles (two blocks an SM) and tiles of 128 or 192
// columns were each slower (PERF.md, section 6).
//
// Registers: a consumer holds 128 int32 accumulators. The producer warpgroup
// gives its registers up (setmaxnreg 24) and the consumers take them (240):
// 24 + 2 x 240 = 504 of the 512 a lane has per register file.
//
// Tile order: blocks walk the [M / 128] x [N / 256] tile grid in groups of
// kGroupM row tiles, row tiles the fastest within a group, so that the blocks
// in flight share ~16 row tiles of A and ~8 column tiles of B in L2 instead
// of re-reading all of B for every row tile.
//
// The epilogue is a policy, as the attention kernels' mask is, in one of
// two forms (Epi::kStaged):
//   * staged: the consumers write their accumulators to the ring (free by
//     then) as an int32 tile, and every consumer thread calls
//     Epi::chunk(row, col, v) with 8 consecutive sums v of row `row` at
//     columns col..col + 7 (col % 8 == 0), the 32 lanes of a warp side by
//     side along one row: the policy's loads and stores are 16 bytes a thread
//     and coalesced. The row padding (kPad) keeps the fragment stores free of
//     bank conflicts.
//   * in registers: Epi::apply(acc, row0, n0, t) gets the thread's sums
//     where wgmma left them: rows row0 and row0 + 8 (registers 4j, 4j + 1 and
//     4j + 2, 4j + 3) at columns n0 + 8j + 2t + {0, 1}, j < kBN / 8. For a
//     policy that stores nothing per element (a row reduction).
// Rows past M and columns past N hold sums over zeros; the policy skips them
// (N % 8 == 0). The policies live with their kernels: `Act8Out` in
// quant_gemm.cu; `QkvOut` (G), `RowAmax`, `QuantStore` (H) and
// `BiasResidual` (H's fc2 and I, the row scale's source a template
// parameter) in fused_encoder.cu.
//
// A block computes one tile and exits: a tile's ring fill and its epilogue
// are not overlapped with another tile's main loop. At K = 1152 (G, I: nine
// stages) that costs more than at the LM's K = 3584 (PERF.md, section 7).
#pragma once

#include "hopper_common.cuh"

namespace videoitg {
namespace hgemm {

constexpr int kBM = 128;                  // rows of a tile: two consumer warpgroups
constexpr int kBN = 256;                  // columns of a tile
constexpr int kBK = 128;                  // bytes of k per stage (one box): four k32 steps
constexpr int kSubs = kBK / 32;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kStages = 196608 / kStageBytes;        // a ring of at most 192 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + slack to align to 1024
constexpr int kGroupM = 16;               // row tiles per group of the tile order
constexpr int kPad = 8;                   // int32s of row padding in the epilogue's tile
static_assert(kStages >= 2 && kBM * (kBN + kPad) * 4 <= kStages * kStageBytes,
              "a ring of two stages or more, and the epilogue's int32 tile fits it");

// The consumer warpgroups alone (named barrier 1; the producer has left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

template <class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
            const Epi epi, int M, int N, int K) {
  constexpr int kATile = kBM * kBK;  // bytes of A in a stage
  constexpr int kBTile = kBN * kBK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  uint8_t* as = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
  uint8_t* bs = as + kStages * kATile;

  // This block's tile in the grouped order.
  const int mm = cdiv(M, kBM);
  const int per_group = kGroupM * cdiv(N, kBN);
  const int first_m = static_cast<int>(blockIdx.x) / per_group * kGroupM;
  const int gm = min(kGroupM, mm - first_m);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % gm) * kBM;
  const int n0 = in_group / gm * kBN;
  const int n_k32 = cdiv(K, 32);
  const int n_iters = cdiv(K, kBK);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------------ producer --
    hopper::setmaxnreg_dec<24>();
    if (warp != kConsumerWarps || lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_iters; ++it) {
      // one box of each operand, zeros past K
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      hopper::mbar_arrive_expect_tx(&full[stage], kATile + kBTile);
      hopper::tma_load_3d(as + stage * kATile, &a_map, &full[stage], it * kBK, m0, 0);
      hopper::tma_load_3d(bs + stage * kBTile, &b_map, &full[stage], it * kBK, n0, 0);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers --
  hopper::setmaxnreg_inc<240>();
  const int wg = warp / 4;
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  // This warpgroup's 64 rows of A: 64 rows into the stage's tile.
  const uint32_t a_base = hopper::smem_u32(as) + wg * 64 * kBK;
  const uint32_t b_base = hopper::smem_u32(bs);

  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_iters; ++it) {
    const int subs = min(kSubs, n_k32 - it * kSubs);
    hopper::mbar_wait(&full[stage], phase);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kSubs; ++c) {
      if (c < subs) {
        const uint32_t a = a_base + stage * kATile;
        const uint32_t b = b_base + stage * kBTile;
        hopper::wgmma_s8<kBN>(acc, hopper::desc_b128(a + c * 32, 1024),
                              hopper::desc_b128(b + c * 32, 1024), 1);
      }
    }
    hopper::wgmma_commit();
    // At most this stage's group in flight: the previous stage is consumed.
    hopper::wgmma_wait<1>();
    if (it > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);

  if constexpr (!Epi::kStaged) {
    epi.apply(acc, m0 + wg * 64 + (warp % 4) * 16 + lane / 4, n0, lane % 4);
  } else {
    // Both warpgroups past their last wgmma, the ring holds the tile's sums
    // as int32 [kBM][kBN + kPad]; then each thread hands the policy 8
    // consecutive sums of a row at a time, a warp to a row.
    consumer_sync();
    int* tile = reinterpret_cast<int*>(as);
    const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      *reinterpret_cast<int2*>(tile + r * (kBN + kPad) + 8 * j + 2 * t) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(tile + (r + 8) * (kBN + kPad) + 8 * j + 2 * t) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    consumer_sync();
    constexpr int kLanes = kBN / 8;  // 32: a warp covers a row
    const int c = (threadIdx.x % kLanes) * 8;
    for (int rr = threadIdx.x / kLanes; rr < kBM; rr += 32 * kConsumerWarps / kLanes) {
      const int4* src = reinterpret_cast<const int4*>(tile + rr * (kBN + kPad) + c);
      const int4 lo = src[0], hi = src[1];
      const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      epi.chunk(m0 + rr, n0 + c, v);
    }
  }
}

// Encodes the maps of A [M][K] and B [N][K] and launches gemm_kernel<Epi>
// with the policy `epi` on `stream`. M, N, K > 0, K % 16 == 0, both bases
// 16-byte aligned.
template <class Epi>
cudaError_t launch(const void* a, const void* b, const Epi& epi, int M, int N, int K,
                   cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  cudaError_t err = hopper::make_rows_map_u8(&a_map, a, M, K, kBM);
  if (err != cudaSuccess) return err;
  err = hopper::make_rows_map_u8(&b_map, b, N, K, kBN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  gemm_kernel<Epi><<<cdiv(M, kBM) * cdiv(N, kBN), kThreads, kSmemBytes, stream>>>(
      a_map, b_map, epi, M, N, K);
  return cudaGetLastError();
}

}  // namespace hgemm
}  // namespace videoitg
