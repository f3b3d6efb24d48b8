// dQ of streaming attention, query-stationary, on the TMA + wgmma skeleton of
// hopper_attention.cuh. sm_90a. One kernel serves two callers, told apart by
// the mask policy, a template parameter:
//  * kernel D (flash_attention_train.cu, `flash_train_dq`, `KeyMask`):
//    native GQA (q head h reads KV head h / (Hq / Hkv)), a key-valid mask
//    [B, S] or none. Replaces the TPU kernel `_dq_kernel` of
//    videoitg_tpu/ops/flash_attention_train.py.
//  * kernel J's dq (flash_attention_segment.cu, `flash_segment_dq`,
//    `SegmentIds`): MHA after the caller's KV repeat, a query sees a key iff
//    their int32 segment ids are equal; every row is computed, whatever its
//    id. Replaces the dq kernel of jax's library flash attention for the TPU
//    behind `mha_trainable` (videoitg_tpu/ops/attention.py).
// Three products of S x S x D per head (5.95 TFLOP at the grounding step's
// [1, 28/4, 16640, 128]) against a few hundred MB: bound by the tensor cores.
//
// A block owns 128 query rows of one (batch, q head): a producer warp and two
// consumer warpgroups of 64 rows (setmaxnreg kDqProducerRegs /
// kDqConsumerRegs). The producer loads the block's Q and dO once by TMA,
// then streams K and V tiles of kDqKeys keys through a ring of kDqStages
// stages; its 32 lanes stage each tile's mask data beside it (the policy's
// word per key, hopper_attention.cuh: a valid byte, 0 past S, or the key's
// segment id). Each
// consumer thread reads its two rows' lse (log2 units, +inf past S) and
// delta (0 past S) once into registers: a 1-D TMA box at (b Hq + h) S + q0
// floats is 16-byte aligned only when S % 4 == 0.
//
// Per key tile a consumer warpgroup computes, for its 64 rows:
//   S  = Q K^T  and  dP = dO V^T   (wgmma SS, both K-major; S is waited for
//                                   first, so its exponentials overlap dP's
//                                   MMAs)
//   p  = exp2(s scale_log2 - lse log2 e), 0 where the policy hides the key
//        or (causal) the key lies after the row; lse = +inf gives p = 0
//   ds = p (dp - delta)
//   dQ += bf16(dS) K               (wgmma RS: dS packed from the accumulator
//                                   registers as tile_pv packs P, K read
//                                   MN-major through the descriptor as
//                                   tile_pv reads V)
// and at the end stores sm_scale dQ for its rows below S. No thread copies
// or transposes a tile, and there are no atomics: dq is the same bits from
// run to run.
//
// Registers: a consumer holds dQ (DP / 2 fp32), S and dP (kDqKeys / 2 each)
// and the packed dS (kDqKeys / 4): 192 at DP = 128 with 128-key tiles, S and
// dP dying as dS is packed. ptxas (-Xptxas -v, sm_90a): 168 registers at
// entry, setmaxnreg 24 / 240, no spill at any head dim, both policies.
// Shared memory at DP = 128: Q and dO 64 KiB, two stages of K + V 128 KiB.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): D 9.45 ms at [1,
// 28/4, 16640, 128] with 16,500 valid (620 TFLOP/s of useful work; the
// mma.sync kernel it replaced 50.17 ms), 4.79 ms causal at [1, 28/4, 16960,
// 128]; J's dQ 11.64 ms at [1, 28, 16896, 128] (was 74.76), 6.35 ms causal at
// [1, 28, 17408, 128]. Tiles of 64 keys in a ring of 3 or 4 stages took 11.8
// to 12.3 ms for D (scripts/torch_probes/attention_probe.py --train).
#pragma once

#include "hopper_attention_dkv.cuh"

namespace videoitg {
namespace hattn {

constexpr int kDqKeys = 128;  // keys per ring stage
constexpr int kDqStages = 2;
constexpr int kDqProducerRegs = 24;
constexpr int kDqConsumerRegs = 240;  // 24 + 2 x 240 = 504 of a lane's 512

template <int DP>
__host__ __device__ constexpr int dq_tile_bytes() {
  return DP / 16 * kDqKeys * 32;  // one tile of K or V
}

template <int DP, class Policy>
constexpr int dq_smem_bytes() {
  // Q and dO, the K + V stages, the mask words per stage, alignment slack.
  return 2 * q_bytes<DP>() +
         kDqStages * (2 * dq_tile_bytes<DP>() +
                      kDqKeys * static_cast<int>(sizeof(typename Policy::Word))) +
         1024;
}

// One key tile for a consumer warpgroup: Q and dO at q_addr / do_addr (this
// warpgroup's 64 rows), K and V at k_addr / v_addr, the tile's mask words at
// `words`; `masked` is set where some key of the tile may be hidden from
// some row of the warpgroup.
template <int DP, class Policy>
__device__ __forceinline__ void dq_tile(float (&acc)[DP / 2], uint32_t q_addr, uint32_t do_addr,
                                        uint32_t k_addr, uint32_t v_addr,
                                        const typename Policy::Word* words, bool masked, int k0,
                                        int S, bool causal, int row0, int row1, int rk0, int rk1,
                                        float lse0, float lse1, float delta0, float delta1,
                                        float scale_log2, int t) {
  constexpr int N = kDqKeys;
  float s[N / 2], dp[N / 2];
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    wgmma_ss<N>(s, desc_b32(q_addr + c * kBlockM * 32, 16, 256),
                desc_b32(k_addr + c * N * 32, 16, 256), c > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    wgmma_ss<N>(dp, desc_b32(do_addr + c * kBlockM * 32, 16, 256),
                desc_b32(v_addr + c * N * 32, 16, 256), c > 0);
  }
  wgmma_commit();
  wgmma_wait<1>();  // S is in; dP still runs
  fence_operands(s);
  if (masked) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      typename Policy::Word w[2];
      load_word_pair(w, words + 8 * j + 2 * t);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        const bool see0 = Policy::sees(w[c], key, S, rk0) && !(causal && key > row0);
        const bool see1 = Policy::sees(w[c], key, S, rk1) && !(causal && key > row1);
        s[4 * j + c] = see0 ? ex2(fmaf(s[4 * j + c], scale_log2, -lse0)) : 0.f;
        s[4 * j + 2 + c] = see1 ? ex2(fmaf(s[4 * j + 2 + c], scale_log2, -lse1)) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[4 * j + c] = ex2(fmaf(s[4 * j + c], scale_log2, -lse0));
        s[4 * j + 2 + c] = ex2(fmaf(s[4 * j + 2 + c], scale_log2, -lse1));
      }
    }
  }
  wgmma_wait<0>();
  fence_operands(dp);
  // ds = p (dp - delta), rounded to bf16 as the A operand of dS K: two
  // 8-key chunks of the accumulator are one A fragment (k16 step).
  uint32_t da[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      da[kk][2 * h] = pack_bf16x2(s[4 * j] * (dp[4 * j] - delta0),
                                  s[4 * j + 1] * (dp[4 * j + 1] - delta0));
      da[kk][2 * h + 1] = pack_bf16x2(s[4 * j + 2] * (dp[4 * j + 2] - delta1),
                                      s[4 * j + 3] * (dp[4 * j + 3] - delta1));
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    wgmma_rs<DP>(acc, da[kk], desc_b32(k_addr + kk * 16 * 32, N * 32, 256));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
  fence_operands(da);
}

// Grid (ceil(S / 128), Hq, B): the query tiles are the fastest index, so
// that the blocks of a wave read the same K and V tiles from L2 (with the q
// heads fastest, J's dQ took 12.89 to 13.17 ms at [1, 28, 16896, 128] against
// 12.00, D 9.95 to 10.11 against 9.79: NVIDIA H100 80GB HBM3 at 700 W,
// scripts/torch_probes/attention_probe.py --train). Under causal the query
// tiles run in reverse, so that the blocks with the most key tiles start
// first.
template <int DP, class Policy>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
          const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
          const Policy policy, const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int S, int D, int causal,
          float sm_scale) {
  using Word = typename Policy::Word;
  constexpr int N = kDqKeys;
  constexpr int kQ = q_bytes<DP>();
  constexpr int kTile = dq_tile_bytes<DP>();
  constexpr int kWordsPerLane = N / 32;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDqStages];
  __shared__ __align__(8) uint64_t empty[kDqStages];
  __shared__ __align__(8) uint64_t q_full;
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* dos = qs + kQ;
  uint8_t* ring = dos + kQ;  // per stage: K, then V
  Word* words = reinterpret_cast<Word*>(ring + kDqStages * 2 * kTile);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBlockM;
  const int bh_q = b * Hq + h;
  const int bh_kv = b * Hkv + h / (Hq / Hkv);
  int n_tiles = (S + N - 1) / N;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlockM, S) - 1) / N + 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 2);  // TMA bytes + the lanes' mask words
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(&q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------------ producer --
    setmaxnreg_dec<kDqProducerRegs>();
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&q_full, 2 * kQ);
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        tma_load_3d(qs + c * kBlockM * 32, &q_map, &q_full, 16 * c, q0, bh_q);
        tma_load_3d(dos + c * kBlockM * 32, &do_map, &q_full, 16 * c, q0, bh_q);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * N;
      Word w[kWordsPerLane];  // this lane's words, read before the wait
#pragma unroll
      for (int i = 0; i < kWordsPerLane; ++i) {
        w[i] = policy.stage(b, k0 + kWordsPerLane * lane + i, S);
      }
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* dst = ring + stage * 2 * kTile;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * kTile);
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          tma_load_3d(dst + c * N * 32, &k_map, &full[stage], 16 * c, k0, bh_kv);
          tma_load_3d(dst + kTile + c * N * 32, &v_map, &full[stage], 16 * c, k0, bh_kv);
        }
      }
#pragma unroll
      for (int i = 0; i < kWordsPerLane; ++i) {
        words[stage * N + kWordsPerLane * lane + i] = w[i];
      }
      __syncwarp();  // every lane's words are written before lane 0 arrives
      if (lane == 0) mbar_arrive(&full[stage]);
      advance(stage, phase, kDqStages);
    }
    return;
  }

  // -------------------------------------------------------------- consumers --
  setmaxnreg_inc<kDqConsumerRegs>();
  const int wg = warp / 4;
  const int t = lane % 4;
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + (warp % 4) * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;
  const float* lse_h = lse + static_cast<size_t>(bh_q) * S;
  const float* delta_h = delta + static_cast<size_t>(bh_q) * S;
  const float lse0 = row0 < S ? lse_h[row0] * kLog2e : INFINITY;
  const float lse1 = row1 < S ? lse_h[row1] * kLog2e : INFINITY;
  const float delta0 = row0 < S ? delta_h[row0] : 0.f;
  const float delta1 = row1 < S ? delta_h[row1] : 0.f;
  const int rk0 = policy.row_key(b, row0, S);
  const int rk1 = policy.row_key(b, row1, S);
  const bool has_mask = policy.has_mask();
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 32;
  const uint32_t do_addr = smem_u32(dos) + wg * 64 * 32;
  const float scale_log2 = sm_scale * kLog2e;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  mbar_wait(&q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * N;
    mbar_wait(&full[stage], phase);
    // Causal: a tile wholly after this warpgroup's rows adds nothing.
    if (!causal || k0 <= wg_row0 + 63) {
      const uint32_t k_addr = smem_u32(ring + stage * 2 * kTile);
      const bool masked = has_mask || k0 + N > S || (causal && k0 + N - 1 > wg_row0);
      dq_tile<DP, Policy>(acc, q_addr, do_addr, k_addr, k_addr + kTile, words + stage * N,
                          masked, k0, S, causal, row0, row1, rk0, rk1, lse0, lse1, delta0,
                          delta1, scale_log2, t);
    }
    if (lane == 0) mbar_arrive(&empty[stage]);
    advance(stage, phase, kDqStages);
  }
  store_scaled<DP>(dq + static_cast<size_t>(bh_q) * S * D, acc, row0, row1, sm_scale, S, D, t);
}

// Q and dO in tensor maps of 128-row boxes, K and V of kDqKeys-row boxes;
// grid (ceil(S / 128), Hq, B).
template <int DP, class Policy>
cudaError_t launch_dq(const BwdArgs& a, const Policy& policy) {
  CUtensorMap q_map, do_map, k_map, v_map;
  cudaError_t err = make_rows_map(&q_map, a.q, a.B * a.Hq, a.S, a.D, kBlockM);
  if (err == cudaSuccess) err = make_rows_map(&do_map, a.dout, a.B * a.Hq, a.S, a.D, kBlockM);
  if (err == cudaSuccess) err = make_rows_map(&k_map, a.k, a.B * a.Hkv, a.S, a.D, kDqKeys);
  if (err == cudaSuccess) err = make_rows_map(&v_map, a.v, a.B * a.Hkv, a.S, a.D, kDqKeys);
  if (err != cudaSuccess) return err;
  constexpr int smem = dq_smem_bytes<DP, Policy>();
  err = cudaFuncSetAttribute(dq_kernel<DP, Policy>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kBlockM - 1) / kBlockM, a.Hq, a.B);
  dq_kernel<DP, Policy><<<grid, kThreads, smem, a.stream>>>(
      q_map, do_map, k_map, v_map, policy, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.Hq, a.Hkv, a.S, a.D, a.causal, a.sm_scale);
  return cudaGetLastError();
}

}  // namespace hattn
}  // namespace videoitg
