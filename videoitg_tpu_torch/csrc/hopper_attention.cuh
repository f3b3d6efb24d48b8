// The TMA + wgmma attention kernels behind kernels A (flash_attention_short.cu),
// B (flash_attention.cu), C (flash_attention_train.cu), K
// (splash_attention.cu) and J's forward (flash_attention_segment.cu). sm_90a.
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
// The mask is a policy, a template parameter of the kernels here and of
// dq_kernel and dkv_kernel (hopper_attention_dq.cuh, hopper_attention_dkv.cuh):
//  * `KeyMask` (A, B, C, D, E): a key-valid byte per key, 0 past S (every key
//    below S when the mask is null); the forward zeroes invalid query rows.
//  * `SegmentIds` (K, J's forward, dQ and dK/dV): int32 ids for the queries
//    and for the keys; a key is seen iff it lies below S and its id equals
//    the row's. Every row is computed, whatever its id; only a row that saw
//    no key is 0.
// The side that streams (keys here and in dQ, query rows in dK/dV) has its
// words staged per tile by the producer's lanes; the stationary side keeps
// its own in registers. With segment ids stream_kernel also stages a
// summary per tile: whether every key below S carries one id (then a thread
// skips the per-key test), and whether, besides, the block's rows below S
// carry one other id. No row of the block sees such a tile: the producer
// loads nothing for it and every consumer thread passes it by, since a tile
// with every key hidden leaves m, l and O as they are (alpha 1, p 0). Padding
// to a multiple of 512 gives J whole tiles of id 0: 4.4% of the tile pairs at
// the grounding LM's shape, 31% at the tower's.
//
// Two kernels:
//  * `stream_kernel` owns 128 query rows of one (batch, q head) and streams
//    K and V through a ring of kStages stages; the producer also stages each
//    tile's 128 policy words (key-mask bytes or key ids, read by its 32
//    lanes). Online mode (kTwoPass = false, kernels B, C, K, J's forward):
//    per tile the running row max and sum, the rescale of O by alpha, p
//    rounded to bf16 into P V; hidden keys (policy, causal, key >= S) are
//    -inf scores, a row with no visible key keeps max -inf and takes base 0,
//    so its p and alpha are 0. With kLse (kernel C, J's forward) it also
//    stores each row's logsumexp lse = sm_scale m + ln l in nats, +inf for a
//    row with no visible valid key. Two-pass mode (kTwoPass = true, kernel A
//    beyond `resident_tiles`): P is divided by its exact row sum before it
//    is rounded to bf16, so pass 1 walks K for the row max and sum (online)
//    and pass 2 walks K and V again; the producer loads K alone in pass 1.
//    The grid is (Hq, query tiles, B), or with kQueryTilesFirst (J's
//    forward, 28 heads after its caller's KV repeat) (query tiles, Hq, B),
//    so that a wave's blocks read one head's K and V from L2.
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

// Kernels A, B, C, D and E's policy: a key is seen iff it lies below S and
// its valid byte is set (every key below S when `valid` is null). Rows carry
// no id. The forward zeroes an invalid query row; the backward's caller
// zeroes dO there, so its delta, ds and dq are exactly 0.
struct KeyMask {
  using Word = uint8_t;
  static constexpr bool kRowIds = false;
  const uint8_t* valid;  // [B, S] or null

  __device__ __forceinline__ bool has_mask() const { return valid != nullptr; }
  // The word of key `key` of batch row b.
  __device__ __forceinline__ Word stage(int b, int key, int S) const {
    return key < S && (valid == nullptr || valid[static_cast<size_t>(b) * S + key] != 0);
  }
  // The id of query row `row` (none here).
  __device__ __forceinline__ int row_key(int, int, int) const { return 0; }
  // Whether a row may see the key at all (w folds in key < S), whether the
  // row's id admits it, and both.
  __device__ __forceinline__ static bool key_ok(Word w, int, int) { return w != 0; }
  __device__ __forceinline__ static bool same(Word, int) { return true; }
  __device__ __forceinline__ static bool sees(Word w, int key, int S, int id) {
    return key_ok(w, key, S) && same(w, id);
  }
  // Whether the forward stores row `row` as computed (else 0).
  __device__ __forceinline__ bool keeps_row(int b, int row, int S) const {
    return row < S && (valid == nullptr || valid[static_cast<size_t>(b) * S + row] != 0);
  }
};

// Kernels K's and J's policy: a key is seen iff it lies below S and its
// segment id equals the row's. An id-0 row is computed like any other.
struct SegmentIds {
  using Word = int;
  static constexpr bool kRowIds = true;
  const int* q_ids;   // [B, S]
  const int* kv_ids;  // [B, S]

  __device__ __forceinline__ bool has_mask() const { return true; }
  __device__ __forceinline__ Word stage(int b, int key, int S) const {
    return key < S ? kv_ids[static_cast<size_t>(b) * S + key] : 0;
  }
  __device__ __forceinline__ int row_key(int b, int row, int S) const {
    return row < S ? q_ids[static_cast<size_t>(b) * S + row] : 0;
  }
  __device__ __forceinline__ static bool key_ok(Word, int key, int S) { return key < S; }
  __device__ __forceinline__ static bool same(Word w, int id) { return w == id; }
  __device__ __forceinline__ static bool sees(Word w, int key, int S, int id) {
    return key_ok(w, key, S) && same(w, id);
  }
  __device__ __forceinline__ bool keeps_row(int, int, int) const { return true; }
};

// The two words of a thread's pair (8 j + 2 t, + 1) in one shared load, or
// `fill` twice where `use` is false: a select of the value, not a branch
// around the load (a branch doubled B's branches and took it from 5.2 to 6.6
// ms).
__device__ __forceinline__ void load_word_pair(uint8_t (&w)[2], const uint8_t* p,
                                               bool use = true, uint8_t fill = 1) {
  const uint32_t pair =
      use ? *reinterpret_cast<const uint16_t*>(p) : fill | (static_cast<uint32_t>(fill) << 8);
  w[0] = static_cast<uint8_t>(pair & 0xFFu);
  w[1] = static_cast<uint8_t>(pair >> 8);
}

__device__ __forceinline__ void load_word_pair(int (&w)[2], const int* p, bool use = true,
                                               int fill = 1) {
  const int2 pair = use ? *reinterpret_cast<const int2*>(p) : make_int2(fill, fill);
  w[0] = pair.x;
  w[1] = pair.y;
}

// A producer lane's four words (keys 4 lane .. 4 lane + 3) in one shared store.
__device__ __forceinline__ void store_words(uint8_t* p, const uint8_t (&w)[4]) {
  *reinterpret_cast<uint32_t*>(p) = static_cast<uint32_t>(w[0]) |
                                    (static_cast<uint32_t>(w[1]) << 8) |
                                    (static_cast<uint32_t>(w[2]) << 16) |
                                    (static_cast<uint32_t>(w[3]) << 24);
}

__device__ __forceinline__ void store_words(int* p, const int (&w)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(w[0], w[1], w[2], w[3]);
}

template <int DP, class Policy>
constexpr int stream_smem_bytes() {
  // Q, K and V stages, the policy's words per stage (with row ids also a
  // tile summary of two ints per stage), and slack to align the base to 1024
  // (231,960 bytes at DP = 128 with segment ids).
  return q_bytes<DP>() + 2 * kStages * tile_bytes<DP>() +
         kStages * kBlockN * static_cast<int>(sizeof(typename Policy::Word)) +
         (Policy::kRowIds ? kStages * 8 : 0) + 1024;
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

// -inf where the policy hides the key from the row (the tile's `words` in
// shared memory, read only if `use_words`, else `fill` for every key; rows'
// ids id0 / id1), at or past S, or (causal) after the row. The pointer is
// always a shared one: a select against null would turn the word loads into
// generic ones (B with its key mask: 6.3 against 5.2 ms).
template <class Policy>
__device__ __forceinline__ void mask_scores(float (&s)[kBlockN / 2],
                                            const typename Policy::Word* words, bool use_words,
                                            typename Policy::Word fill, int k0, int S,
                                            bool causal, int row0, int row1, int id0, int id1,
                                            int t) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    const int local = 8 * j + 2 * t;
    typename Policy::Word w[2];
    load_word_pair(w, words + local, use_words, fill);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // Bitwise tests and selects: with `&&` and `if` K's instance branched
      // on every key.
      const int key = k0 + local + c;
      const bool ok = (key < S) & Policy::key_ok(w[c], key, S);
      const bool see0 = ok & Policy::same(w[c], id0) & !(causal & (key > row0));
      const bool see1 = ok & Policy::same(w[c], id1) & !(causal & (key > row1));
      s[4 * j + c] = see0 ? s[4 * j + c] : -INFINITY;
      s[4 * j + 2 + c] = see1 ? s[4 * j + 2 + c] : -INFINITY;
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

template <int DP, bool kTwoPass, bool kLse, class Policy, bool kQueryTilesFirst>
__global__ void __launch_bounds__(kThreads, 1)
stream_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, const Policy policy,
              __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int S, int D, int causal,
              float scale_log2, float* __restrict__ lse) {
  static_assert(!(kTwoPass && kLse), "the logsumexp is stored in online mode only");
  static_assert(!(kTwoPass && Policy::kRowIds), "segment ids run in online mode only");
  using Word = typename Policy::Word;
  constexpr int kTile = tile_bytes<DP>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ __align__(8) uint64_t q_full;
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* ks = qs + q_bytes<DP>();
  uint8_t* vs = ks + kStages * kTile;
  Word* words = reinterpret_cast<Word*>(vs + kStages * kTile);
  // With row ids, per stage: 1 where every key of the tile lies below S and
  // carries one id, 2 where besides no row of the block has that id (the
  // tile is skipped), else 0; and that id.
  int2* summary = reinterpret_cast<int2*>(words + kStages * kBlockN);

  const int h = kQueryTilesFirst ? blockIdx.y : blockIdx.x;
  const int b = blockIdx.z;
  // Causal blocks with the most tiles start first.
  const int qt = kQueryTilesFirst ? (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x)
                                  : (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y);
  const int q0 = qt * kBlockM;
  const int bh_q = b * Hq + h;
  const int bh_kv = b * Hkv + h / (Hq / Hkv);
  const bool has_mask = policy.has_mask();
  int n_tiles = (S + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlockM, S) - 1) / kBlockN + 1);
  const int n_iters = kTwoPass ? 2 * n_tiles : n_tiles;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], has_mask ? 2 : 1);  // TMA bytes (+ the words)
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
    // With row ids: whether the block's rows below S carry one id, and that
    // id (row q0's), decided once.
    int rows_uniform = 0;
    int row_id = 0;
    if constexpr (Policy::kRowIds) {
      row_id = __shfl_sync(0xffffffffu, policy.row_key(b, q0 + 4 * lane, S), 0);
      bool same = true;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * lane + i;
        same &= (row >= S) | (policy.row_key(b, row, S) == row_id);
      }
      rows_uniform = __all_sync(0xffffffffu, same);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_iters; ++it) {
      const bool with_v = !kTwoPass || it >= n_tiles;
      const int k0 = (kTwoPass && it >= n_tiles ? it - n_tiles : it) * kBlockN;
      Word w[4] = {};  // this lane's 4 words, read before the wait
      if (has_mask) {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = policy.stage(b, k0 + 4 * lane + i, S);
      }
      int uniform = 0;
      Word u = 0;
      if constexpr (Policy::kRowIds) {
        u = __shfl_sync(0xffffffffu, w[0], 0);
        uniform = __all_sync(0xffffffffu, k0 + 4 * lane + 3 < S && w[0] == u && w[1] == u &&
                                              w[2] == u && w[3] == u);
        if (uniform && rows_uniform && u != row_id) uniform = 2;
      }
      mbar_wait(&empty[stage], phase ^ 1);
      if (Policy::kRowIds && uniform > 1) {
        if (lane == 0) mbar_arrive(&full[stage]);  // no bytes: the tile is skipped
      } else if (lane == 0) {
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
        store_words(words + stage * kBlockN + 4 * lane, w);
        if constexpr (Policy::kRowIds) {
          if (lane == 0) summary[stage] = make_int2(uniform, u);
        }
        __syncwarp();  // every lane's words are written before lane 0 arrives
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
  const int id0 = policy.row_key(b, row0, S);
  const int id1 = policy.row_key(b, row1, S);
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
    if constexpr (Policy::kRowIds) {
      if (summary[stage].x > 1) {  // seen by no row of the block: nothing was loaded
        if (lane == 0) mbar_arrive(&empty[stage]);
        advance(stage, phase, kStages);
        continue;
      }
    }
    float s[kBlockN / 2];
    tile_scores<DP>(s, q_addr, smem_u32(ks + stage * kTile));
    bool mask = has_mask || k0 + kBlockN > S || (causal && k0 + kBlockN - 1 > wg_row0);
    bool use_words = has_mask;
    Word fill = 1;
    if constexpr (Policy::kRowIds) {
      // A tile whose keys all lie below S and carry one id: a row sees all of
      // them or none, and no word is loaded; a thread whose two rows have
      // that id and no causal cut skips the masking (K's main path: most
      // tiles).
      const int2 sum = summary[stage];
      if (sum.x) {
        use_words = false;
        fill = sum.y;
        mask = id0 != fill || id1 != fill || (causal && k0 + kBlockN - 1 > row0);
      }
    }
    if (mask) {
      mask_scores<Policy>(s, words + stage * kBlockN, use_words, fill, k0, S, causal, row0, row1,
                          id0, id1, t);
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

  // out row = acc / l (online) or acc (P already normalised); 0 for a row
  // with no visible key and for a row the policy does not keep (an invalid
  // query row of the key mask; segment ids keep every row).
  float inv0 = 1.f, inv1 = 1.f;
  bool zero0 = false, zero1 = false;
  if (!kTwoPass) {
    inv0 = quad_sum(l0);
    inv1 = quad_sum(l1);
    zero0 = !(policy.keeps_row(b, row0, S) && inv0 > 0.f);
    zero1 = !(policy.keeps_row(b, row1, S) && inv1 > 0.f);
  }
  store_rows<DP>(o + static_cast<size_t>(bh_q) * S * D, acc, row0, row1, inv0, inv1, zero0,
                 zero1, S, D, t);
  if constexpr (kLse) {
    // lse = sm_scale m + ln l = (scale_log2 m + log2 l) ln 2, also for an
    // invalid query row; +inf where no valid key was visible (l = 0), which
    // makes every p of the row exp(-inf) = 0 in the backward.
    if (t == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lrow = lse + static_cast<size_t>(bh_q) * S;
      if (row0 < S) lrow[row0] = inv0 > 0.f ? (m0 * scale_log2 + log2f(inv0)) * kLn2 : INFINITY;
      if (row1 < S) lrow[row1] = inv1 > 0.f ? (m1 * scale_log2 + log2f(inv1)) * kLn2 : INFINITY;
    }
  }
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
        mask_scores<KeyMask>(s, qs, false, 1, kt * kBlockN, S, false, 0, 0, 0, 0, t);
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
        mask_scores<KeyMask>(s, qs, false, 1, kt * kBlockN, S, false, 0, 0, 0, 0, t);
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
  const uint8_t* valid;  // [B, S] or null: the KeyMask of A, B, C
  void* o;
  int B, Hq, Hkv, S, D, causal;
  float scale_log2;
  cudaStream_t stream;
  float* lse = nullptr;  // [B, Hq, S] fp32, stream_kernel<DP, false, true, ...> (C, J) only
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

// Grid (Hq, ceil(S / 128), B): the q heads of a KV group are adjacent blocks
// and read the same K and V tiles from L2. With kQueryTilesFirst (ceil(S /
// 128), Hq, B): a head's query tiles are adjacent blocks.
template <int DP, bool kTwoPass, bool kLse = false, class Policy = KeyMask,
          bool kQueryTilesFirst = false>
cudaError_t launch_stream(const Args& a, const Policy& policy) {
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_maps(a, &q_map, &k_map, &v_map);
  if (err != cudaSuccess) return err;
  constexpr int smem = stream_smem_bytes<DP, Policy>();
  err = cudaFuncSetAttribute(stream_kernel<DP, kTwoPass, kLse, Policy, kQueryTilesFirst>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (a.S + kBlockM - 1) / kBlockM;
  const dim3 grid = kQueryTilesFirst ? dim3(q_tiles, a.Hq, a.B) : dim3(a.Hq, q_tiles, a.B);
  stream_kernel<DP, kTwoPass, kLse, Policy, kQueryTilesFirst>
      <<<grid, kThreads, smem, a.stream>>>(q_map, k_map, v_map, policy,
                                           static_cast<__nv_bfloat16*>(a.o), a.Hq, a.Hkv, a.S,
                                           a.D, a.causal, a.scale_log2, a.lse);
  return cudaGetLastError();
}

// Kernel A: K resident where the (frame, head)'s K fits, else streamed.
template <int DP>
cudaError_t launch_two_pass(const Args& a) {
  const int n_tiles = (a.S + kBlockN - 1) / kBlockN;
  if (n_tiles > resident_tiles<DP>()) return launch_stream<DP, true>(a, KeyMask{a.valid});
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
