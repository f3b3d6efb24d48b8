// Trainable multi-head attention with a segment-id mask (sm_90a): forward
// with the per-row logsumexp, dQ, and dK/dV.
//
// Replaces the TPU kernels behind `mha_trainable` in
// videoitg_tpu/ops/attention.py (the `use_flash="train-jax"` arm): jax's
// library flash attention for the TPU (jax/experimental/pallas/ops/tpu/
// flash_attention.py), its forward, dkv and dq Pallas kernels under one custom
// VJP. Contract, as that arm uses them: MHA (as many KV heads as query heads;
// the caller repeats the KV heads of a GQA model), int32 segment ids [B, S]
// for the queries and for the keys, a query attends a key iff their ids are
// equal (and, when causal, key <= query); the scores are scaled by sm_scale in
// fp32; fp32 softmax statistics.
//
// What differs from flash_attention_train.cu (kernels C, D, E), and why these
// are kernels of their own:
// * The mask is id equality for both sides, not a key-valid mask. A query at
//   a position the caller calls invalid (id 0) is computed like any other
//   row: it attends the other id-0 keys (the caller's zero padding included),
//   its o is not zeroed, its dO is not ignored and it gets a dq; an id-0 key
//   gets dk and dv from the id-0 queries.
// * MHA: a block of dK/dV owns 64 keys of ONE head and walks that head's query
//   tiles. There is no group to sum over, so no atomics: two runs give the
//   same bits.
// * A query whose id matches no visible key (it cannot occur when both id
//   arrays are the same tensor and the mask is not causal-cut below the row
//   itself: a row always sees itself) outputs 0, stores lse = +inf and has
//   zero gradient. The TPU kernel masks with a large finite value and gives
//   such a row the mean of V; `mha_trainable` reaches neither.
//
// Arithmetic (bf16 operands, fp32 accumulation), the same rounding points as
// C, D, E:
//   forward   s = q k^T, p = exp(sm_scale (s - m)) rounded to bf16 into p v,
//             o = acc / l, lse = sm_scale m + log l (natural log)
//   backward  p = exp(sm_scale s - lse), dp = dO v^T, ds = p (dp - delta)
//             dv = sum_q bf16(p)^T dO
//             dq = sm_scale * sum_k bf16(ds) k
//             dk = sm_scale * sum_q bf16(ds)^T q
// with delta = rowsum(dO * o) in fp32, computed by the caller.
//
// What bounds them on an H100, at the LM's training shape after the KV repeat
// and the padding to 512, q/k/v [1, 28, 16896, 128] bf16: S^2 D H = 1.02 TMAC
// per product, 4 / 6 / 8 TFLOP for forward / dQ / dK,dV against under 1 GB
// of operands: thousands of operations per byte, far above the ~295 bf16
// ridge. The tensor cores bound all three. Causal calls skip every tile that
// lies wholly above the diagonal, in all three kernels, so they do about half
// the work.
//
// Design. One block of 4 warps per 64-row tile, mma.sync m16n8k16 bf16, one
// tile in flight, as C, D, E (whose fragment helpers these share through
// attention_common.cuh).
// * forward: the block owns 64 query rows of one head, holds Q as A
//   fragments, streams 64-key tiles of K and V (V transposed in shared
//   memory) and the tile's 64 key ids.
// * dQ: the same ownership; Q and dO stay in registers; per key tile K, V and
//   K^T are staged; scores and dp are formed 16 keys at a time so that ds
//   never leaves registers.
// * dK/dV: the block owns 64 keys of one head; K and V stay in shared memory;
//   each query tile (from the diagonal on when causal) is staged once in both
//   layouts with its ids, lse and delta; it works on the transposed scores,
//   whose accumulators are already the A fragments of p^T dO and ds^T Q.
// Lengths need not be a multiple of 64 (or of the caller's 512): rows beyond
// S are staged as zeros and masked. D is any multiple of 8 up to 128, padded
// to a multiple of 16 in shared memory only (72 -> 80).
#include "attention_common.cuh"

namespace videoitg {

// ---------------------------------------------------------------- forward --

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_segment_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_ids,
                         const int* __restrict__ kv_ids, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int H, int S, int D, int causal,
                         float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * (DP + kPad);
  __nv_bfloat16* vt = ks + kBlockK * (DP + kPad);
  __shared__ int kid_s[kBlockK];

  const float scale_log2 = sm_scale * kLog2e;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t stat_base = (static_cast<size_t>(b) * H + h) * S;
  const int* qid_b = q_ids + static_cast<size_t>(b) * S;
  const int* kid_b = kv_ids + static_cast<size_t>(b) * S;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int row1 = row0 + 8;
  const int qid0 = row0 < S ? qid_b[row0] : 0;
  const int qid1 = row1 < S ? qid_b[row1] : 0;

  load_rows<kBlockQ, DP>(qs, q + base, q0, S, D);
  __syncthreads();
  uint32_t qa[DP / 16][4];
  load_q_fragments<DP>(qa, qs, warp, g, t);

  int n_tiles = (S + kBlockK - 1) / kBlockK;
  // Causal: key tiles wholly above this query tile's diagonal are skipped.
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlockQ, S) - 1) / kBlockK + 1);

  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float acc[DP / 8][4];
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float s[kBlockK / 8][4];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_rows<kBlockK, DP>(ks, k + base, k0, S, D);
    load_rows_transposed<kBlockK, DP>(vt, v + base, k0, S, D);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      kid_s[threadIdx.x] = key < S ? kid_b[key] : 0;
    }
    __syncthreads();
    tile_scores<DP>(s, qa, ks, g, t);

    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int local = nb * 8 + 2 * t + j;
        const int key = k0 + local;
        const int kid = kid_s[local];
        const bool in = key < S;
        if (!(in && kid == qid0 && !(causal && key > row0))) s[nb][j] = -INFINITY;
        if (!(in && kid == qid1 && !(causal && key > row1))) s[nb][2 + j] = -INFINITY;
        tm0 = fmaxf(tm0, s[nb][j]);
        tm1 = fmaxf(tm1, s[nb][2 + j]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(tm0));
    const float mn1 = fmaxf(m1, quad_max(tm1));
    // A row with nothing visible yet keeps max -inf; subtracting 0 then keeps
    // every p (and alpha) at exp2(-inf) = 0 instead of NaN.
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2f((m0 - base0) * scale_log2);
    const float alpha1 = exp2f((m1 - base1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nb][j] = exp2f((s[nb][j] - base0) * scale_log2);
        s[nb][2 + j] = exp2f((s[nb][2 + j] - base1) * scale_log2);
        ts0 += s[nb][j];
        ts1 += s[nb][2 + j];
      }
    }
    l0 = l0 * alpha0 + ts0;
    l1 = l1 * alpha1 + ts1;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      acc[nb][0] *= alpha0;
      acc[nb][1] *= alpha0;
      acc[nb][2] *= alpha1;
      acc[nb][3] *= alpha1;
    }
    tile_pv<DP>(acc, s, vt, g, t);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // Every row is stored as computed, whatever its id; only a row that saw no
  // key at all is 0 (and +inf in lse, which zeroes its p in the backward).
  store_rows<DP>(o + base, acc, row0, l0, !(l0 > 0.f), row1, l1, !(l1 > 0.f), S, D, t);
  if (t == 0) {
    if (row0 < S) lse[stat_base + row0] = l0 > 0.f ? m0 * sm_scale + logf(l0) : INFINITY;
    if (row1 < S) lse[stat_base + row1] = l1 > 0.f ? m1 * sm_scale + logf(l1) : INFINITY;
  }
}

// --------------------------------------------------------------------- dQ --

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_segment_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_ids,
                        const int* __restrict__ kv_ids, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int S, int D, int causal,
                        float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Q, then dO
  __nv_bfloat16* ks = xs + kBlockQ * (DP + kPad);
  __nv_bfloat16* vs = ks + kBlockK * (DP + kPad);
  __nv_bfloat16* kts = vs + kBlockK * (DP + kPad);
  __shared__ int kid_s[kBlockK];

  const float scale_log2 = sm_scale * kLog2e;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t stat_base = (static_cast<size_t>(b) * H + h) * S;
  const int* qid_b = q_ids + static_cast<size_t>(b) * S;
  const int* kid_b = kv_ids + static_cast<size_t>(b) * S;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const int qid0 = row0 < S ? qid_b[row0] : 0;
  const int qid1 = row1 < S ? qid_b[row1] : 0;

  uint32_t qa[DP / 16][4], doa[DP / 16][4];
  load_rows<kBlockQ, DP>(xs, q + base, q0, S, D);
  __syncthreads();
  load_q_fragments<DP>(qa, xs, warp, g, t);
  __syncthreads();
  load_rows<kBlockQ, DP>(xs, dout + base, q0, S, D);
  __syncthreads();
  load_q_fragments<DP>(doa, xs, warp, g, t);

  // lse in log2 units; rows beyond S behave like rows that saw nothing.
  const float lse0 = row0 < S ? lse[stat_base + row0] * kLog2e : INFINITY;
  const float lse1 = row1 < S ? lse[stat_base + row1] * kLog2e : INFINITY;
  const float delta0 = row0 < S ? delta[stat_base + row0] : 0.f;
  const float delta1 = row1 < S ? delta[stat_base + row1] : 0.f;

  int n_tiles = (S + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlockQ, S) - 1) / kBlockK + 1);

  float acc[DP / 8][4];
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_rows_both<kBlockK, DP>(ks, kts, k + base, k0, S, D);
    load_rows<kBlockK, DP>(vs, v + base, k0, S, D);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      kid_s[threadIdx.x] = key < S ? kid_b[key] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {  // 16 keys at a time
      float s[2][4], dp[2][4];
      fragments_times_rows<DP, 2>(s, qa, ks + kc * 16 * (DP + kPad), g, t);
      fragments_times_rows<DP, 2>(dp, doa, vs + kc * 16 * (DP + kPad), g, t);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int local = kc * 16 + nb * 8 + 2 * t + j;
          const int key = k0 + local;
          const int kid = kid_s[local];
          const bool in = key < S;
          const bool see0 = in && kid == qid0 && !(causal && key > row0);
          const bool see1 = in && kid == qid1 && !(causal && key > row1);
          const float p0 = see0 ? exp2f(s[nb][j] * scale_log2 - lse0) : 0.f;
          const float p1 = see1 ? exp2f(s[nb][2 + j] * scale_log2 - lse1) : 0.f;
          s[nb][j] = p0 * (dp[nb][j] - delta0);
          s[nb][2 + j] = p1 * (dp[nb][2 + j] - delta1);
        }
      }
      uint32_t dsa[4];
      dsa[0] = pack_bf16(s[0][0], s[0][1]);
      dsa[1] = pack_bf16(s[0][2], s[0][3]);
      dsa[2] = pack_bf16(s[1][0], s[1][1]);
      dsa[3] = pack_bf16(s[1][2], s[1][3]);
      fragment_times_transposed<DP>(acc, dsa, kts + kc * 16, g, t);
    }
  }
  store_scaled_rows<DP>(dq + base, acc, sm_scale, row0, row1, S, D, t);
}

// ------------------------------------------------------------------ dK/dV --

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_segment_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_ids,
                         const int* __restrict__ kv_ids, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                         int S, int D, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlockK * (DP + kPad);
  __nv_bfloat16* qs = vs + kBlockK * (DP + kPad);
  __nv_bfloat16* dos = qs + kBlockQ * (DP + kPad);
  __nv_bfloat16* qts = dos + kBlockQ * (DP + kPad);
  __nv_bfloat16* dots = qts + DP * (kBlockQ + kPad);
  __shared__ float lse_s[kBlockQ];    // log2 units, +inf beyond S
  __shared__ float delta_s[kBlockQ];
  __shared__ int qid_s[kBlockQ];

  const float scale_log2 = sm_scale * kLog2e;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t stat_base = (static_cast<size_t>(b) * H + h) * S;
  const int* qid_b = q_ids + static_cast<size_t>(b) * S;
  const int* kid_b = kv_ids + static_cast<size_t>(b) * S;
  const int k0 = blockIdx.x * kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
  const int key1 = key0 + 8;
  const bool in0 = key0 < S;
  const bool in1 = key1 < S;
  const int kid0 = in0 ? kid_b[key0] : 0;
  const int kid1 = in1 ? kid_b[key1] : 0;

  load_rows<kBlockK, DP>(ks, k + base, k0, S, D);
  load_rows<kBlockK, DP>(vs, v + base, k0, S, D);

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    dk_acc[nb][0] = dk_acc[nb][1] = dk_acc[nb][2] = dk_acc[nb][3] = 0.f;
    dv_acc[nb][0] = dv_acc[nb][1] = dv_acc[nb][2] = dv_acc[nb][3] = 0.f;
  }

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  // Causal: query tiles before this key tile see none of its keys
  // (kBlockQ == kBlockK, so tile indices compare directly).
  const int qt_begin = causal ? static_cast<int>(blockIdx.x) : 0;

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();
    load_rows_both<kBlockQ, DP>(qs, qts, q + base, q0, S, D);
    load_rows_both<kBlockQ, DP>(dos, dots, dout + base, q0, S, D);
    if (threadIdx.x < kBlockQ) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < S ? lse[stat_base + row] * kLog2e : INFINITY;
      delta_s[threadIdx.x] = row < S ? delta[stat_base + row] : 0.f;
      qid_s[threadIdx.x] = row < S ? qid_b[row] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int qc = 0; qc < kBlockQ / 32; ++qc) {  // 32 queries at a time
      // Transposed scores and dp: rows are this warp's keys, columns queries.
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        st[nb][0] = st[nb][1] = st[nb][2] = st[nb][3] = 0.f;
        dpt[nb][0] = dpt[nb][1] = dpt[nb][2] = dpt[nb][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        load_a_fragment<DP>(a, ks, warp * 16, kk, g, t);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const __nv_bfloat16* row = qs + (qc * 32 + nb * 8 + g) * (DP + kPad) + kk * 16;
          mma_16816(st[nb], a, ld_pair(row + 2 * t), ld_pair(row + 8 + 2 * t));
        }
        load_a_fragment<DP>(a, vs, warp * 16, kk, g, t);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const __nv_bfloat16* row = dos + (qc * 32 + nb * 8 + g) * (DP + kPad) + kk * 16;
          mma_16816(dpt[nb], a, ld_pair(row + 2 * t), ld_pair(row + 8 + 2 * t));
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int local = qc * 32 + nb * 8 + 2 * t + j;
          const int qrow = q0 + local;
          const int qid = qid_s[local];
          const float l2 = lse_s[local];  // +inf for rows beyond S: p = 0
          const float dl = delta_s[local];
          const bool see0 = in0 && kid0 == qid && !(causal && key0 > qrow);
          const bool see1 = in1 && kid1 == qid && !(causal && key1 > qrow);
          const float p0 = see0 ? exp2f(st[nb][j] * scale_log2 - l2) : 0.f;
          const float p1 = see1 ? exp2f(st[nb][2 + j] * scale_log2 - l2) : 0.f;
          st[nb][j] = p0;
          st[nb][2 + j] = p1;
          dpt[nb][j] = p0 * (dpt[nb][j] - dl);
          dpt[nb][2 + j] = p1 * (dpt[nb][2 + j] - dl);
        }
      }
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {  // two 16-query steps of the chunk
        uint32_t pa[4], dsa[4];
        pa[0] = pack_bf16(st[2 * kq][0], st[2 * kq][1]);
        pa[1] = pack_bf16(st[2 * kq][2], st[2 * kq][3]);
        pa[2] = pack_bf16(st[2 * kq + 1][0], st[2 * kq + 1][1]);
        pa[3] = pack_bf16(st[2 * kq + 1][2], st[2 * kq + 1][3]);
        dsa[0] = pack_bf16(dpt[2 * kq][0], dpt[2 * kq][1]);
        dsa[1] = pack_bf16(dpt[2 * kq][2], dpt[2 * kq][3]);
        dsa[2] = pack_bf16(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]);
        dsa[3] = pack_bf16(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3]);
        fragment_times_transposed<DP>(dv_acc, pa, dots + qc * 32 + kq * 16, g, t);
        fragment_times_transposed<DP>(dk_acc, dsa, qts + qc * 32 + kq * 16, g, t);
      }
    }
  }
  store_scaled_rows<DP>(dv + base, dv_acc, 1.0f, key0, key1, S, D, t);
  store_scaled_rows<DP>(dk + base, dk_acc, sm_scale, key0, key1, S, D, t);
}

// --------------------------------------------------------------- launches --

struct SegmentArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const int *q_ids, *kv_ids;
  const float *lse_in, *delta;
  __nv_bfloat16 *o, *dq, *dk, *dv;
  float* lse_out;
  int B, H, S, D, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <int DP>
cudaError_t launch_segment_fwd(const SegmentArgs& a) {
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_segment_fwd_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.H, a.B);
  flash_segment_fwd_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.q_ids, a.kv_ids, a.o, a.lse_out, a.H, a.S, a.D, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_segment_dq(const SegmentArgs& a) {
  constexpr int smem = dq_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_segment_dq_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.H, a.B);
  flash_segment_dq_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.q_ids, a.kv_ids, a.dout, a.lse_in, a.delta, a.dq, a.H, a.S, a.D,
      a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_segment_dkv(const SegmentArgs& a) {
  constexpr int smem = dkv_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_segment_dkv_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kBlockK - 1) / kBlockK, a.H, a.B);
  flash_segment_dkv_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.q_ids, a.kv_ids, a.dout, a.lse_in, a.delta, a.dk, a.dv, a.H, a.S, a.D,
      a.causal, a.sm_scale);
  return cudaGetLastError();
}

static bool segment_shapes_ok(const SegmentArgs& a) {
  return a.B > 0 && a.H > 0 && a.S > 0 && a.D > 0 && a.D <= 128 && a.D % 8 == 0 &&
         a.B <= 65535 && a.H <= 65535;
}

}  // namespace videoitg

// Shapes for all three: q, k, v, out, dout, dq, dk, dv contiguous bf16
// [B, H, S, D]; lse, delta contiguous fp32 [B, H, S]; q_ids, kv_ids
// contiguous int32 [B, S]. D a multiple of 8 and at most 128. Each launches
// on `stream` and returns cudaGetLastError().

extern "C" int videoitg_flash_segment_fwd_bf16(const void* q, const void* k, const void* v,
                                               const void* q_ids, const void* kv_ids, void* out,
                                               void* lse, int B, int H, int S, int D, int causal,
                                               float sm_scale, void* stream) {
  using namespace videoitg;
  SegmentArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_ids = static_cast<const int*>(q_ids);
  a.kv_ids = static_cast<const int*>(kv_ids);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.lse_out = static_cast<float*>(lse);
  a.B = B; a.H = H; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!segment_shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_segment_fwd, a)
}

extern "C" int videoitg_flash_segment_dq_bf16(const void* q, const void* k, const void* v,
                                              const void* q_ids, const void* kv_ids,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dq, int B, int H, int S,
                                              int D, int causal, float sm_scale, void* stream) {
  using namespace videoitg;
  SegmentArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_ids = static_cast<const int*>(q_ids);
  a.kv_ids = static_cast<const int*>(kv_ids);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.B = B; a.H = H; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!segment_shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_segment_dq, a)
}

extern "C" int videoitg_flash_segment_dkv_bf16(const void* q, const void* k, const void* v,
                                               const void* q_ids, const void* kv_ids,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv, int B,
                                               int H, int S, int D, int causal, float sm_scale,
                                               void* stream) {
  using namespace videoitg;
  SegmentArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_ids = static_cast<const int*>(q_ids);
  a.kv_ids = static_cast<const int*>(kv_ids);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.B = B; a.H = H; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!segment_shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_segment_dkv, a)
}
