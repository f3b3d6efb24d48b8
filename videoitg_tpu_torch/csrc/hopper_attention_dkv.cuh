// dK and dV of streaming attention, key-stationary, on the TMA + wgmma
// skeleton of hopper_attention.cuh. sm_90a. One kernel serves two callers,
// told apart by the mask policy, a template parameter:
//  * kernel E (flash_attention_train.cu, `flash_train_dkv`, `KeyMask`):
//    native GQA, sums over the q heads of the group, a key-valid mask [B, S]
//    or none. Replaces the TPU kernel `_dkv_kernel` of
//    videoitg_tpu/ops/flash_attention_train.py.
//  * kernel J's dK/dV (flash_attention_segment.cu, `flash_segment_dkv`,
//    `SegmentIds`): MHA after the caller's KV repeat (a group of 1), a key
//    is seen by a row iff their int32 segment ids are equal; every row
//    counts, whatever its id. Replaces the dkv kernel of jax's library flash
//    attention for the TPU behind `mha_trainable`
//    (videoitg_tpu/ops/attention.py).
// Four products of S x S x D per head (7.8 TFLOP at the grounding step's
// [1, 28/4, 16640, 128]) against a few hundred MB: bound by the tensor cores.
//
// A block owns 128 keys of one (batch, KV head): a producer warp and two
// consumer warpgroups of 64 keys each (setmaxnreg 24 / 240). The producer
// loads the block's K and V tiles once by TMA, then walks every q head of
// the group and every query tile of 64 rows, and streams each tile's Q and
// dO through a ring of kDkvStages stages by TMA; its 32 lanes stage the
// tile's 64 lse (in log2 units) and 64 delta values beside them (+inf / 0
// past S: a 1-D TMA box would start at (b Hq + h) S + q0 floats, a multiple
// of 16 bytes only when S % 4 == 0), and with segment ids the tile's 64 q
// ids (plain loads from q_ids + b S + q0, 0 past S). Each consumer thread
// keeps its two keys' policy words in registers: the valid byte (0 past S)
// or the kv id. The sums over the group stay in the block's registers: no
// atomics, the same bits from run to run.
//
// Per query tile a consumer warpgroup computes, for its 64 keys (rows) and
// the tile's 64 queries (columns):
//   S^T  = K Q^T   and  dP^T = V dO^T   (wgmma SS: K / V as A, Q / dO as B,
//                                        both K-major, as Q K^T in stream_kernel)
//   p    = exp2(s scale_log2 - lse log2 e), 0 where the policy hides the key
//          from the query (invalid or past S; another id) or (causal) the key
//          lies after the query; a row with lse = +inf (no visible key, or
//          past S) gives p = 0 by itself
//   ds   = p (dp - delta)
//   dV  += bf16(P^T) dO   and  dK += bf16(dS^T) Q   (wgmma RS: P^T and dS^T
//          from the accumulators' registers, packed as tile_pv packs P; dO
//          and Q read MN-major through the descriptor, as tile_pv reads V)
// and at the end stores dV and sm_scale dK for its keys below S. No thread
// copies or transposes a tile: TMA writes the 32-byte-swizzled 16-column
// boxes (hopper_common.cuh) that both readings of Q and dO use.
//
// Registers: a consumer holds dK and dV (DP / 2 fp32 each, 128 at DP = 128),
// S^T and dP^T (32 each) and the packed P^T and dS^T (16 each) at once:
// 224 of the 240 that setmaxnreg gives it. ptxas (-Xptxas -v, sm_90a): 168
// registers at entry, no spill but at DP = 128 (4 bytes of spill stores, 8 of
// loads, the same with setmaxnreg 40 / 232, which is 4% slower); the
// segment-id instance does not spill.
//
// On an NVIDIA H100 80GB HBM3 at 700 W E takes 12.97 ms at [1, 28/4, 16640,
// 128] with 16,500 valid (602 TFLOP/s of useful work; the mma.sync kernel it
// replaced 70.40 ms), 6.59 ms causal at [1, 28/4, 16960, 128]; a ring of 2 or
// 4 stages times the same as 3. J's dK/dV takes 13.43 ms at [1, 28, 16896,
// 128] with 16,500 valid (581 TFLOP/s; the mma.sync kernel it replaced 75.57
// ms), 7.09 ms causal at [1, 28, 17408, 128]; with the heads the fastest grid
// index 14.31 against 13.38 (scripts/torch_probes/attention_probe.py --train).
#pragma once

#include "hopper_attention.cuh"

namespace videoitg {
namespace hattn {

constexpr int kDkvKeys = 128;    // keys per block, 64 per consumer warpgroup
constexpr int kDkvRows = 64;     // query rows per ring stage
constexpr int kDkvStages = 3;
constexpr int kDkvProducerRegs = 24;
constexpr int kDkvConsumerRegs = 240;  // 24 + 2 x 240 = 504 of a lane's 512
// Grid order of each caller's instance (dkv_kernel's kKeyTilesFirst): E
// (GQA, 4 KV heads at the training shape) keeps the heads fastest, J (28
// heads after the KV repeat) puts the key tiles fastest.
constexpr int kDkvKeyTilesFirstE = 0;
constexpr int kDkvKeyTilesFirstJ = 1;
// J's forward likewise (stream_kernel's kQueryTilesFirst, hopper_attention.cuh):
// the query tiles fastest, so that a wave's blocks read one head's K and V.
constexpr int kFwdQueryTilesFirstJ = 1;

template <int DP>
__host__ __device__ constexpr int dkv_rows_bytes() {
  return DP / 16 * kDkvRows * 32;  // one 64-row tile of Q or dO
}

// Per stage: lse and delta, and the q ids where rows carry one.
template <class Policy>
__host__ __device__ constexpr int dkv_stat_words() {
  return (Policy::kRowIds ? 3 : 2) * kDkvRows;
}

template <int DP, class Policy>
constexpr int dkv_kernel_smem_bytes() {
  // K and V, the Q + dO stages, the stats per stage, alignment slack.
  return 2 * q_bytes<DP>() +
         kDkvStages * (2 * dkv_rows_bytes<DP>() + dkv_stat_words<Policy>() * 4) + 1024;
}

// dst rows = scale * acc for this thread's two rows below S; columns >= D
// are not stored.
template <int DP>
__device__ __forceinline__ void store_scaled(__nv_bfloat16* out, const float (&acc)[DP / 2],
                                             int row0, int row1, float scale, int S, int D,
                                             int t) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= D) continue;
    if (row0 < S) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row0) * D + col) =
          pack_bf16x2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    }
    if (row1 < S) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row1) * D + col) =
          pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// One query tile for a consumer warpgroup: its keys are key0 / key1 (this
// thread's rows, with policy words w0 / w1, seen by some row at all as ok0 /
// ok1), the tile's Q and dO at q_addr /
// do_addr, its lse (log2 units) and delta at st[0..63] / st[64..127], and
// with segment ids its q ids at st[128..191]. `diag` is set where some key of
// the warpgroup lies after some query.
template <int DP, class Policy>
__device__ __forceinline__ void dkv_tile(float (&dk)[DP / 2], float (&dv)[DP / 2],
                                         uint32_t k_addr, uint32_t v_addr, uint32_t q_addr,
                                         uint32_t do_addr, const float* st, int q0, int key0,
                                         int key1, typename Policy::Word w0,
                                         typename Policy::Word w1, bool ok0, bool ok1, bool diag,
                                         float scale_log2, int t) {
  float s[kDkvRows / 2], dp[kDkvRows / 2];
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    wgmma_ss<kDkvRows>(s, desc_b32(k_addr + c * kDkvKeys * 32, 16, 256),
                       desc_b32(q_addr + c * kDkvRows * 32, 16, 256), c > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    wgmma_ss<kDkvRows>(dp, desc_b32(v_addr + c * kDkvKeys * 32, 16, 256),
                       desc_b32(do_addr + c * kDkvRows * 32, 16, 256), c > 0);
  }
  wgmma_commit();
  wgmma_wait<1>();  // S^T is in; dP^T still runs
  fence_operands(s);
#pragma unroll
  for (int j = 0; j < kDkvRows / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(st + col);
    int id[2] = {0, 0};  // the two queries' ids
    if constexpr (Policy::kRowIds) {
      load_word_pair(id, reinterpret_cast<const int*>(st + 2 * kDkvRows) + col);
    }
    const int qa = q0 + col, qb = qa + 1;
    s[4 * j] = ok0 && Policy::same(w0, id[0]) && !(diag && key0 > qa)
                   ? ex2(fmaf(s[4 * j], scale_log2, -l2.x)) : 0.f;
    s[4 * j + 1] = ok0 && Policy::same(w0, id[1]) && !(diag && key0 > qb)
                       ? ex2(fmaf(s[4 * j + 1], scale_log2, -l2.y)) : 0.f;
    s[4 * j + 2] = ok1 && Policy::same(w1, id[0]) && !(diag && key1 > qa)
                       ? ex2(fmaf(s[4 * j + 2], scale_log2, -l2.x)) : 0.f;
    s[4 * j + 3] = ok1 && Policy::same(w1, id[1]) && !(diag && key1 > qb)
                       ? ex2(fmaf(s[4 * j + 3], scale_log2, -l2.y)) : 0.f;
  }
  wgmma_wait<0>();
  fence_operands(dp);
  uint32_t pa[kDkvRows / 16][4], da[kDkvRows / 16][4];
#pragma unroll
  for (int j = 0; j < kDkvRows / 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(st + kDkvRows + 8 * j + 2 * t);
    dp[4 * j] = s[4 * j] * (dp[4 * j] - dl.x);
    dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - dl.y);
    dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - dl.x);
    dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - dl.y);
  }
  // Two 8-query chunks of an accumulator are one A fragment (k16 step).
#pragma unroll
  for (int kk = 0; kk < kDkvRows / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pa[kk][i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      da[kk][i] = pack_bf16x2(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDkvRows / 16; ++kk) {
    wgmma_rs<DP>(dv, pa[kk], desc_b32(do_addr + kk * 16 * 32, kDkvRows * 32, 256));
  }
#pragma unroll
  for (int kk = 0; kk < kDkvRows / 16; ++kk) {
    wgmma_rs<DP>(dk, da[kk], desc_b32(q_addr + kk * 16 * 32, kDkvRows * 32, 256));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(dv);
  fence_operands(dk);
  fence_operands(pa);
  fence_operands(da);
}

// Grid (Hkv, ceil(S / 128), B) with kKeyTilesFirst false: the key tile is
// the slower index, so the blocks of the first key tiles, which have the most
// query tiles under causal, start first. With kKeyTilesFirst the grid is
// (ceil(S / 128), Hkv, B): the blocks of a wave share one head's Q and dO
// stream, where with the heads fastest a wave of a group-1 caller (J: 28
// heads) streams 28 heads' Q and dO at once.
template <int DP, class Policy, bool kKeyTilesFirst>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
           const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
           const Policy policy, const float* __restrict__ lse,
           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int S, int D, int causal,
           float sm_scale) {
  using Word = typename Policy::Word;
  constexpr int kKV = q_bytes<DP>();         // a 128-row tile of K or V
  constexpr int kRows = dkv_rows_bytes<DP>();
  constexpr int kStage = 2 * kRows;          // Q, then dO
  constexpr int kStats = dkv_stat_words<Policy>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDkvStages];
  __shared__ __align__(8) uint64_t empty[kDkvStages];
  __shared__ __align__(8) uint64_t kv_full;
  uint8_t* ks = align_1024(smem_raw);
  uint8_t* vs = ks + kKV;
  uint8_t* ring = vs + kKV;
  float* stats = reinterpret_cast<float*>(ring + kDkvStages * kStage);  // per stage

  const int hk = kKeyTilesFirst ? blockIdx.y : blockIdx.x;
  const int k0 = (kKeyTilesFirst ? blockIdx.x : blockIdx.y) * kDkvKeys;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int bh_kv = b * Hkv + hk;
  const int n_qt = (S + kDkvRows - 1) / kDkvRows;
  // Causal: query tiles before this key tile see none of its keys.
  const int qt_begin = causal ? k0 / kDkvRows : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 2);  // TMA bytes + the lanes' stats
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(&kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------------ producer --
    setmaxnreg_dec<kDkvProducerRegs>();
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&kv_full, 2 * kKV);
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        tma_load_3d(ks + c * kDkvKeys * 32, &k_map, &kv_full, 16 * c, k0, bh_kv);
        tma_load_3d(vs + c * kDkvKeys * 32, &v_map, &kv_full, 16 * c, k0, bh_kv);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int hg = 0; hg < group; ++hg) {
      const int bh_q = b * Hq + hk * group + hg;
      const float* lse_h = lse + static_cast<size_t>(bh_q) * S;
      const float* delta_h = delta + static_cast<size_t>(bh_q) * S;
      for (int qt = qt_begin; qt < n_qt; ++qt) {
        const int q0 = qt * kDkvRows;
        const int r0 = q0 + lane, r1 = r0 + 32;  // this lane's rows, read before the wait
        const float l0 = r0 < S ? lse_h[r0] * kLog2e : INFINITY;
        const float l1 = r1 < S ? lse_h[r1] * kLog2e : INFINITY;
        const float d0 = r0 < S ? delta_h[r0] : 0.f;
        const float d1 = r1 < S ? delta_h[r1] : 0.f;
        int i0 = 0, i1 = 0;
        if constexpr (Policy::kRowIds) {
          i0 = policy.row_key(b, r0, S);
          i1 = policy.row_key(b, r1, S);
        }
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* dst = ring + stage * kStage;
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], kStage);
#pragma unroll
          for (int c = 0; c < DP / 16; ++c) {
            tma_load_3d(dst + c * kDkvRows * 32, &q_map, &full[stage], 16 * c, q0, bh_q);
            tma_load_3d(dst + kRows + c * kDkvRows * 32, &do_map, &full[stage], 16 * c, q0,
                        bh_q);
          }
        }
        float* st = stats + stage * kStats;
        st[lane] = l0;
        st[lane + 32] = l1;
        st[kDkvRows + lane] = d0;
        st[kDkvRows + lane + 32] = d1;
        if constexpr (Policy::kRowIds) {
          int* ids = reinterpret_cast<int*>(st + 2 * kDkvRows);
          ids[lane] = i0;
          ids[lane + 32] = i1;
        }
        __syncwarp();  // every lane's values are written before lane 0 arrives
        if (lane == 0) mbar_arrive(&full[stage]);
        advance(stage, phase, kDkvStages);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers --
  setmaxnreg_inc<kDkvConsumerRegs>();
  const int wg = warp / 4;
  const int t = lane % 4;
  const int wg_key0 = k0 + wg * 64;
  const int key0 = wg_key0 + (warp % 4) * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
  const int key1 = key0 + 8;
  const Word w0 = policy.stage(b, key0, S);
  const Word w1 = policy.stage(b, key1, S);
  const bool ok0 = Policy::key_ok(w0, key0, S);
  const bool ok1 = Policy::key_ok(w1, key1, S);
  const uint32_t k_addr = smem_u32(ks) + wg * 64 * 32;
  const uint32_t v_addr = smem_u32(vs) + wg * 64 * 32;
  const float scale_log2 = sm_scale * kLog2e;

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(&kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int hg = 0; hg < group; ++hg) {
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * kDkvRows;
      mbar_wait(&full[stage], phase);
      // Causal: a tile wholly before this warpgroup's keys adds nothing.
      if (!causal || q0 + kDkvRows > wg_key0) {
        const uint32_t q_addr = smem_u32(ring + stage * kStage);
        dkv_tile<DP, Policy>(dk_acc, dv_acc, k_addr, v_addr, q_addr, q_addr + kRows,
                             stats + stage * kStats, q0, key0, key1, w0, w1, ok0, ok1,
                             causal && q0 < wg_key0 + 63, scale_log2, t);
      }
      if (lane == 0) mbar_arrive(&empty[stage]);
      advance(stage, phase, kDkvStages);
    }
  }
  const size_t kv_base = static_cast<size_t>(bh_kv) * S * D;
  store_scaled<DP>(dv + kv_base, dv_acc, key0, key1, 1.f, S, D, t);
  store_scaled<DP>(dk + kv_base, dk_acc, key0, key1, sm_scale, S, D, t);
}

// The operands of the two backward kernels (dq_kernel, dkv_kernel).
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Hq, Hkv, S, D, causal;
  float sm_scale;
  cudaStream_t stream;
};

// Q and dO in tensor maps of 64-row boxes, K and V of 128-row boxes.
template <int DP, bool kKeyTilesFirst, class Policy>
cudaError_t launch_dkv(const BwdArgs& a, const Policy& policy) {
  CUtensorMap q_map, do_map, k_map, v_map;
  cudaError_t err = make_rows_map(&q_map, a.q, a.B * a.Hq, a.S, a.D, kDkvRows);
  if (err == cudaSuccess) err = make_rows_map(&do_map, a.dout, a.B * a.Hq, a.S, a.D, kDkvRows);
  if (err == cudaSuccess) err = make_rows_map(&k_map, a.k, a.B * a.Hkv, a.S, a.D, kDkvKeys);
  if (err == cudaSuccess) err = make_rows_map(&v_map, a.v, a.B * a.Hkv, a.S, a.D, kDkvKeys);
  if (err != cudaSuccess) return err;
  constexpr int smem = dkv_kernel_smem_bytes<DP, Policy>();
  err = cudaFuncSetAttribute(dkv_kernel<DP, Policy, kKeyTilesFirst>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int key_tiles = (a.S + kDkvKeys - 1) / kDkvKeys;
  const dim3 grid = kKeyTilesFirst ? dim3(key_tiles, a.Hkv, a.B) : dim3(a.Hkv, key_tiles, a.B);
  dkv_kernel<DP, Policy, kKeyTilesFirst><<<grid, kThreads, smem, a.stream>>>(
      q_map, do_map, k_map, v_map, policy, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.Hq, a.Hkv, a.S, a.D, a.causal, a.sm_scale);
  return cudaGetLastError();
}

}  // namespace hattn
}  // namespace videoitg
