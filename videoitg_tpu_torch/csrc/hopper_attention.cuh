// The TMA + wgmma attention kernels behind kernels A (flash_attention_short.cu)
// and B (flash_attention.cu). sm_90a.
//
// A block is three warpgroups: two consumer warpgroups of 64 query rows each
// (warps 0-7) and a producer warpgroup of which one warp works (warp 8). The
// producer loads tiles by TMA into shared memory and announces their bytes
// on `full` barriers; consumers wait on `full`, compute S = Q K^T with wgmma
// from shared memory (both operands K-major), turn S into P in registers,
// accumulate O += P V with P as wgmma's register operand and V read
// transposed from shared memory, and release the stage on its `empty`
// barrier (one arrival per consumer warp). No thread copies a tile and no
// tile is transposed: TMA writes the 32-byte-swizzled layout that wgmma
// reads (hopper_common.cuh). TMA's zero fill covers the rows past S and the
// columns past D. Keys come in tiles of 128.
//
// Registers: each of the SM's four register files (16,384 registers) holds
// every fourth warp, so a block of 9 or 12 warps gets 168 registers a thread
// (ptxas' cap for a first version of 288 threads: B spilled 156 bytes at
// DP = 128). With three warpgroups the producer gives its registers up
// (setmaxnreg 40) and the consumers take them (232): 40 + 2 x 232 = 504 of
// the 512 a lane has per register file. A consumer holds a 64 x 128 score
// tile (64 fp32), P as bf16 (32) and O (DP / 2, 64 at DP = 128).
//
// Two kernels:
//  * `stream_kernel` owns 128 query rows of one (batch, q head) and streams
//    K and V through a ring of kStages stages; the producer also stages each
//    tile's 128 key-mask bytes (0 past S; its 32 lanes read them from the
//    [B, S] mask). Online mode (kTwoPass = false, kernel B): per tile the
//    running row max and sum, the rescale of O by alpha, p rounded to bf16
//    into P V; masked keys (key mask, causal, key >= S) are -inf scores, a
//    row with no visible key keeps max -inf and takes base 0, so its p and
//    alpha are 0. Two-pass mode (kTwoPass = true, kernel A beyond
//    `resident_tiles`): P is divided by its exact row sum before it is
//    rounded to bf16, so pass 1 walks K for the row max and sum (online) and
//    pass 2 walks K and V again; the producer loads K alone in pass 1.
//  * `resident_kernel` (kernel A): one block owns a (frame, head), stages its
//    whole K once, and walks its query tiles with two Q buffers; per query
//    tile pass 1 reads K from shared memory only and pass 2 streams V through
//    a ring of 2 stages. A (frame, head)'s K is read from L2 once instead of
//    twice per query tile.
#pragma once

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace videoitg {
namespace hattn {

using namespace hopper;

constexpr int kBlockM = 128;              // query rows per block or query tile
constexpr int kBlockN = 128;              // keys per tile
constexpr int kStages = 3;                // stream_kernel's ring depth
constexpr int kConsumerWarps = 8;         // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr int kSub = kBlockN * 32;        // bytes of one 16-column sub-tile of K or V
constexpr int kSmemLimit = 232448 - 1024 - 256;  // dynamic bytes less alignment slack and barriers

template <int DP>
__host__ __device__ constexpr int tile_bytes() {
  return DP / 16 * kSub;
}

template <int DP>
__host__ __device__ constexpr int q_bytes() {
  return DP / 16 * kBlockM * 32;
}

template <int DP>
constexpr int stream_smem_bytes() {
  // Q, K and V stages, key-mask stages, and slack to align the base to 1024.
  return q_bytes<DP>() + 2 * kStages * tile_bytes<DP>() + kStages * kBlockN + 1024;
}

// K tiles that fit beside resident_kernel's two Q buffers and two V stages
// (7 at DP = 80: S up to 896; 3 at DP = 128).
template <int DP>
constexpr int resident_tiles() {
  return (kSmemLimit - 2 * q_bytes<DP>() - 2 * tile_bytes<DP>()) / tile_bytes<DP>();
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// ------------------------------------------------- consumer tile steps --

// s = Q K^T for this warpgroup's 64 rows (Q at q_addr, a [128][16] sub-tile
// every kBlockM * 32 bytes) and a K tile at k_addr.
template <int DP>
__device__ __forceinline__ void tile_scores(float (&s)[kBlockN / 2], uint32_t q_addr,
                                            uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    wgmma_ss<kBlockN>(s, desc_b32(q_addr + c * kBlockM * 32, 16, 256),
                      desc_b32(k_addr + c * kSub, 16, 256), c > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s);
}

// -inf where the key is masked (the tile's `mask` bytes in shared memory,
// read only if `use_mask`), at or past S, or (causal) after the row. The
// pointer is always a shared one: a select against null would turn the
// byte loads into generic ones (B with its key mask: 6.3 against 5.2 ms).
__device__ __forceinline__ void mask_scores(float (&s)[kBlockN / 2], const uint8_t* mask,
                                            bool use_mask, int k0, int S, bool causal, int row0,
                                            int row1, int t) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    const int local = 8 * j + 2 * t;
    const uint32_t pair =
        use_mask ? *reinterpret_cast<const uint16_t*>(mask + local) : 0x0101u;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + local + c;
      const bool ok = key < S && ((pair >> (8 * c)) & 0xFFu) != 0u;
      if (!ok || (causal && key > row0)) s[4 * j + c] = -INFINITY;
      if (!ok || (causal && key > row1)) s[4 * j + 2 + c] = -INFINITY;
    }
  }
}

// The online step of a tile: new row max m, alpha = exp2((m_old - m) *
// scale), s -> p = exp2(s * scale - m * scale), l = l * alpha + sum p. A row
// with nothing visible yet keeps max -inf; subtracting 0 then keeps every p
// (and alpha) at exp2(-inf) = 0 instead of NaN.
__device__ __forceinline__ void online_softmax(float (&s)[kBlockN / 2], float& m0, float& m1,
                                               float& l0, float& l1, float& alpha0,
                                               float& alpha1, float scale_log2) {
  float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    tm0 = fmaxf(tm0, fmaxf(s[4 * j], s[4 * j + 1]));
    tm1 = fmaxf(tm1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float mn0 = fmaxf(m0, quad_max(tm0));
  const float mn1 = fmaxf(m1, quad_max(tm1));
  const float base0 = mn0 == -INFINITY ? 0.f : mn0;
  const float base1 = mn1 == -INFINITY ? 0.f : mn1;
  alpha0 = ex2((m0 - base0) * scale_log2);
  alpha1 = ex2((m1 - base1) * scale_log2);
  m0 = mn0;
  m1 = mn1;
  const float bs0 = base0 * scale_log2, bs1 = base1 * scale_log2;
  float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      s[4 * j + c] = ex2(fmaf(s[4 * j + c], scale_log2, -bs0));
      s[4 * j + 2 + c] = ex2(fmaf(s[4 * j + 2 + c], scale_log2, -bs1));
      ts0 += s[4 * j + c];
      ts1 += s[4 * j + 2 + c];
    }
  }
  l0 = l0 * alpha0 + ts0;
  l1 = l1 * alpha1 + ts1;
}

// Pass 2 of the two-pass mode: p = exp2(s * scale - max * scale) times the
// row's 1 / sum, normalised before it is rounded.
__device__ __forceinline__ void normalised_p(float (&s)[kBlockN / 2], float m0, float m1,
                                             float r0, float r1, float scale_log2) {
  const float bs0 = m0 * scale_log2, bs1 = m1 * scale_log2;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      s[4 * j + c] = ex2(fmaf(s[4 * j + c], scale_log2, -bs0)) * r0;
      s[4 * j + 2 + c] = ex2(fmaf(s[4 * j + 2 + c], scale_log2, -bs1)) * r1;
    }
  }
}

// acc += P V with P = bf16(p): two 8-key chunks of the score accumulator are
// one A fragment; V is the tile at v_addr, read MN-major.
template <int DP>
__device__ __forceinline__ void tile_pv(float (&acc)[DP / 2], const float (&p)[kBlockN / 2],
                                        uint32_t v_addr) {
  uint32_t pa[kBlockN / 16][4];
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(p[8 * kk], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(p[8 * kk + 6], p[8 * kk + 7]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_rs<DP>(acc, pa[kk], desc_b32(v_addr + kk * 16 * 32, kSub, 256));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
}

// out rows = acc / l (1 for normalised P), or 0 where `zero`; rows >= S and
// columns >= D are not stored.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[DP / 2],
                                           int row0, int row1, float l0, float l1, bool zero0,
                                           bool zero1, int S, int D, int t) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= D) continue;
    if (row0 < S) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row0) * D + col) =
          zero0 ? 0u : pack_bf16x2(acc[4 * j] / l0, acc[4 * j + 1] / l0);
    }
    if (row1 < S) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row1) * D + col) =
          zero1 ? 0u : pack_bf16x2(acc[4 * j + 2] / l1, acc[4 * j + 3] / l1);
    }
  }
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int n_stages) {
  if (++stage == n_stages) {
    stage = 0;
    phase ^= 1;
  }
}

// ------------------------------------------------------------ kernels --

template <int DP, bool kTwoPass>
__global__ void __launch_bounds__(kThreads, 1)
stream_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, const uint8_t* __restrict__ valid,
              __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int S, int D, int causal,
              float scale_log2) {
  constexpr int kTile = tile_bytes<DP>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ __align__(8) uint64_t q_full;
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* ks = qs + q_bytes<DP>();
  uint8_t* vs = ks + kStages * kTile;
  uint8_t* ms = vs + kStages * kTile;

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  // Causal blocks with the most tiles start first.
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBlockM;
  const int bh_q = b * Hq + h;
  const int bh_kv = b * Hkv + h / (Hq / Hkv);
  const bool has_mask = valid != nullptr;
  int n_tiles = (S + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlockM, S) - 1) / kBlockN + 1);
  const int n_iters = kTwoPass ? 2 * n_tiles : n_tiles;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], has_mask ? 2 : 1);  // TMA bytes (+ the mask)
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(&q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------------ producer --
    setmaxnreg_dec<40>();
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&q_full, q_bytes<DP>());
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        tma_load_3d(qs + c * kBlockM * 32, &q_map, &q_full, 16 * c, q0, bh_q);
      }
    }
    const uint8_t* vrow = has_mask ? valid + static_cast<size_t>(b) * S : nullptr;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_iters; ++it) {
      const bool with_v = !kTwoPass || it >= n_tiles;
      const int k0 = (kTwoPass && it >= n_tiles ? it - n_tiles : it) * kBlockN;
      uint32_t word = 0;  // this lane's 4 mask bytes, read before the wait
      if (has_mask) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 4 * lane + i;
          if (key < S && vrow[key] != 0) word |= 1u << (8 * i);
        }
      }
      mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], kTile * (with_v ? 2 : 1));
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          tma_load_3d(ks + stage * kTile + c * kSub, &k_map, &full[stage], 16 * c, k0, bh_kv);
        }
        if (with_v) {
#pragma unroll
          for (int c = 0; c < DP / 16; ++c) {
            tma_load_3d(vs + stage * kTile + c * kSub, &v_map, &full[stage], 16 * c, k0, bh_kv);
          }
        }
      }
      if (has_mask) {
        *reinterpret_cast<uint32_t*>(ms + stage * kBlockN + 4 * lane) = word;
        __syncwarp();  // every lane's bytes are written before lane 0 arrives
        if (lane == 0) mbar_arrive(&full[stage]);
      }
      advance(stage, phase, kStages);
    }
    return;
  }

  // -------------------------------------------------------------- consumers --
  setmaxnreg_inc<232>();
  const int wg = warp / 4;
  const int t = lane % 4;
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + (warp % 4) * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 32;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  float r0 = 0.f, r1 = 0.f;              // two passes: 1 / row sum

  mbar_wait(&q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_iters; ++it) {
    const bool first_pass = kTwoPass && it < n_tiles;
    const int k0 = (kTwoPass && !first_pass ? it - n_tiles : it) * kBlockN;
    mbar_wait(&full[stage], phase);
    float s[kBlockN / 2];
    tile_scores<DP>(s, q_addr, smem_u32(ks + stage * kTile));
    if (has_mask || k0 + kBlockN > S || (causal && k0 + kBlockN - 1 > wg_row0)) {
      mask_scores(s, ms + stage * kBlockN, has_mask, k0, S, causal, row0, row1, t);
    }
    if (first_pass || !kTwoPass) {
      float alpha0, alpha1;
      online_softmax(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2);
      if (first_pass) {
        if (it == n_tiles - 1) {
          r0 = 1.f / quad_sum(l0);
          r1 = 1.f / quad_sum(l1);
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        advance(stage, phase, kStages);
        continue;
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
    } else {
      normalised_p(s, m0, m1, r0, r1, scale_log2);
    }
    tile_pv<DP>(acc, s, smem_u32(vs + stage * kTile));
    if (lane == 0) mbar_arrive(&empty[stage]);
    advance(stage, phase, kStages);
  }

  // out row = acc / l (online) or acc (P already normalised); 0 for an
  // invalid query row or a row with no visible valid key.
  float inv0 = 1.f, inv1 = 1.f;
  bool zero0 = false, zero1 = false;
  if (!kTwoPass) {
    inv0 = quad_sum(l0);
    inv1 = quad_sum(l1);
    const uint8_t* vrow = has_mask ? valid + static_cast<size_t>(b) * S : nullptr;
    zero0 = !(row0 < S && (vrow == nullptr || vrow[row0] != 0) && inv0 > 0.f);
    zero1 = !(row1 < S && (vrow == nullptr || vrow[row1] != 0) && inv1 > 0.f);
  }
  store_rows<DP>(o + static_cast<size_t>(bh_q) * S * D, acc, row0, row1, inv0, inv1, zero0,
                 zero1, S, D, t);
}

// Kernel A with the (frame, head)'s K resident: grid (H, 1, B), S at most
// resident_tiles<DP>() * kBlockN.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
resident_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, int H,
                int S, int D, float scale_log2) {
  constexpr int kTile = tile_bytes<DP>();
  constexpr int kQ = q_bytes<DP>();
  constexpr int kVStages = 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kVStages];
  __shared__ __align__(8) uint64_t empty[kVStages];
  __shared__ __align__(8) uint64_t q_full[2];
  __shared__ __align__(8) uint64_t q_empty[2];
  __shared__ __align__(8) uint64_t k_full;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;  // key tiles = query tiles
  uint8_t* qs = align_1024(smem_raw);               // two Q buffers
  uint8_t* kres = qs + 2 * kQ;                      // n_tiles K tiles
  uint8_t* vs = kres + n_tiles * kTile;             // kVStages V tiles
  const int bh = blockIdx.z * H + blockIdx.x;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumerWarps);
    }
    mbar_init(&k_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------------ producer --
    setmaxnreg_dec<40>();
    if (warp != kConsumerWarps || lane != 0) return;
    mbar_arrive_expect_tx(&q_full[0], kQ);
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      tma_load_3d(qs + c * kBlockM * 32, &q_map, &q_full[0], 16 * c, 0, bh);
    }
    mbar_arrive_expect_tx(&k_full, n_tiles * kTile);
    for (int kt = 0; kt < n_tiles; ++kt) {
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        tma_load_3d(kres + kt * kTile + c * kSub, &k_map, &k_full, 16 * c, kt * kBlockN, bh);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = 0; qt < n_tiles; ++qt) {
      if (qt + 1 < n_tiles) {  // the next query tile, once its buffer is free
        const int qb = (qt + 1) & 1;
        mbar_wait(&q_empty[qb], (((qt + 1) >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], kQ);
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          tma_load_3d(qs + qb * kQ + c * kBlockM * 32, &q_map, &q_full[qb], 16 * c,
                      (qt + 1) * kBlockM, bh);
        }
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], kTile);
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          tma_load_3d(vs + stage * kTile + c * kSub, &v_map, &full[stage], 16 * c,
                      kt * kBlockN, bh);
        }
        advance(stage, phase, kVStages);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers --
  setmaxnreg_inc<232>();
  const int wg = warp / 4;
  const int t = lane % 4;
  const int row_in_tile = wg * 64 + (warp % 4) * 16 + lane / 4;
  const uint32_t k_addr = smem_u32(kres);
  __nv_bfloat16* out = o + static_cast<size_t>(bh) * S * D;

  mbar_wait(&k_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int qb = qt & 1;
    const int row0 = qt * kBlockM + row_in_tile;
    const int row1 = row0 + 8;
    const uint32_t q_addr = smem_u32(qs + qb * kQ) + wg * 64 * 32;
    mbar_wait(&q_full[qb], (qt >> 1) & 1);

    // Pass 1: the row max and sum, K from shared memory only.
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      float s[kBlockN / 2];
      tile_scores<DP>(s, q_addr, k_addr + kt * kTile);
      if (kt * kBlockN + kBlockN > S) {
        mask_scores(s, qs, false, kt * kBlockN, S, false, 0, 0, t);
      }
      float alpha0, alpha1;
      online_softmax(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2);
    }
    const float r0 = 1.f / quad_sum(l0);
    const float r1 = 1.f / quad_sum(l1);

    // Pass 2: P normalised before it is rounded, into P V.
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      float s[kBlockN / 2];
      tile_scores<DP>(s, q_addr, k_addr + kt * kTile);
      if (kt == n_tiles - 1 && lane == 0) mbar_arrive(&q_empty[qb]);  // Q read for the last time
      if (kt * kBlockN + kBlockN > S) {
        mask_scores(s, qs, false, kt * kBlockN, S, false, 0, 0, t);
      }
      normalised_p(s, m0, m1, r0, r1, scale_log2);
      mbar_wait(&full[stage], phase);
      tile_pv<DP>(acc, s, smem_u32(vs + stage * kTile));
      if (lane == 0) mbar_arrive(&empty[stage]);
      advance(stage, phase, kVStages);
    }
    store_rows<DP>(out, acc, row0, row1, 1.f, 1.f, false, false, S, D, t);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;  // [B, S] or null
  void* o;
  int B, Hq, Hkv, S, D, causal;
  float scale_log2;
  cudaStream_t stream;
};

// Encodes the tensor maps of this call (a few microseconds each): Q in boxes
// of q_rows rows, K and V in boxes of kBlockN.
inline cudaError_t make_maps(const Args& a, CUtensorMap* q_map, CUtensorMap* k_map,
                             CUtensorMap* v_map) {
  cudaError_t err = make_rows_map(q_map, a.q, a.B * a.Hq, a.S, a.D, kBlockM);
  if (err == cudaSuccess) err = make_rows_map(k_map, a.k, a.B * a.Hkv, a.S, a.D, kBlockN);
  if (err == cudaSuccess) err = make_rows_map(v_map, a.v, a.B * a.Hkv, a.S, a.D, kBlockN);
  return err;
}

template <int DP, bool kTwoPass>
cudaError_t launch_stream(const Args& a) {
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_maps(a, &q_map, &k_map, &v_map);
  if (err != cudaSuccess) return err;
  constexpr int smem = stream_smem_bytes<DP>();
  err = cudaFuncSetAttribute(stream_kernel<DP, kTwoPass>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hq, (a.S + kBlockM - 1) / kBlockM, a.B);
  stream_kernel<DP, kTwoPass><<<grid, kThreads, smem, a.stream>>>(
      q_map, k_map, v_map, a.valid, static_cast<__nv_bfloat16*>(a.o), a.Hq, a.Hkv, a.S, a.D,
      a.causal, a.scale_log2);
  return cudaGetLastError();
}

// Kernel A: K resident where the (frame, head)'s K fits, else streamed.
template <int DP>
cudaError_t launch_two_pass(const Args& a) {
  const int n_tiles = (a.S + kBlockN - 1) / kBlockN;
  if (n_tiles > resident_tiles<DP>()) return launch_stream<DP, true>(a);
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_maps(a, &q_map, &k_map, &v_map);
  if (err != cudaSuccess) return err;
  const int smem = 2 * q_bytes<DP>() + (n_tiles + 2) * tile_bytes<DP>() + 1024;
  err = cudaFuncSetAttribute(resident_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * q_bytes<DP>() + (resident_tiles<DP>() + 2) * tile_bytes<DP>() +
                                 1024);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hq, 1, a.B);
  resident_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(a.o), a.Hq, a.S, a.D, a.scale_log2);
  return cudaGetLastError();
}

}  // namespace hattn
}  // namespace videoitg
