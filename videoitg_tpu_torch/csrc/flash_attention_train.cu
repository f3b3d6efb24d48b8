// Trainable streaming attention with native GQA (sm_90a): forward with the
// per-row logsumexp, and the two backward kernels.
//
// Replaces the three TPU kernels of videoitg_tpu/ops/flash_attention_train.py:
// `_fwd_kernel` (forward + lse), `_dq_kernel` (dQ) and `_dkv_kernel` (dK, dV
// summed over the GQA group). Query head h reads KV head h / (Hq / Hkv) in
// place in both directions; K and V are never repeated in device memory.
//
// Arithmetic (bf16 operands, fp32 accumulation, fp32 softmax statistics):
//   forward   s = q k^T, p = exp(sm_scale (s - m)) rounded to bf16 into p v,
//             o = acc / l, lse = sm_scale m + log l (natural log)
//   backward  p = exp(sm_scale s - lse), dp = dO v^T, ds = p (dp - delta)
//             dv += bf16(p)^T dO
//             dq  = sm_scale * sum_k bf16(ds) k
//             dk  = sm_scale * sum_q bf16(ds)^T q
// with delta = rowsum(dO * o) in fp32, computed by the caller. Masking uses
// the contract of flash_attention.cu: a masked key (invalid, beyond S, or in
// a causal row's future) has probability exactly 0, so an invalid key gets
// dk = dv = 0; a row with no visible valid key outputs 0 and stores
// lse = +inf, which makes every p of that row exp(-inf) = 0 in the backward.
// The backward kernels read `valid` as a key mask only: the caller zeroes dO
// on invalid query rows, which zeroes their delta, ds and dq and keeps them
// out of dk and dv.
//
// What bounds them on an H100, at the training shape q [1, 28, 16640, 128],
// k/v [1, 4, 16640, 128] (1024 frames x 16 image slots + 256 text slots):
// S^2 D Hq = 0.992 TFLOP per product pair, so the forward does 3.97 TFLOP, dQ
// 5.95 and dK/dV 7.94 against a few hundred MB of operands: thousands of
// operations per byte, far above the ~295 bf16 ridge. All three are bound by
// the tensor cores; none of the S x S matrices leaves registers.
//
// Design. One block of 4 warps per 64-row tile, mma.sync m16n8k16 bf16.
// * forward: the block owns 64 query rows of one q head, holds Q as A
//   fragments and streams 64-key tiles of K and V (V transposed in shared
//   memory), exactly as flash_attention.cu does, and stores lse beside o.
// * dQ: the same ownership; Q and dO stay in registers as A fragments; per
//   key tile K, V (row-major) and K^T are staged; scores and dp are formed 16
//   keys at a time so that ds (the A fragment of ds K) never leaves
//   registers and the live accumulators stay under the register limit.
// * dK/dV: the block owns 64 keys of one KV head and walks every query head
//   of the group and every query tile itself, so the sums over the group need
//   no atomics and are the same from run to run. It works on the transposed
//   scores (K Q^T, V dO^T), whose accumulators are already the A fragments of
//   p^T dO and ds^T Q. K and V stay in shared memory; each query tile is
//   staged once in both layouts (row-major for the scores, transposed for
//   the two accumulating products).
// Lengths need not be a multiple of 64: rows beyond S are staged as zeros and
// masked (keys) or given lse = +inf (queries). D is any multiple of 8 up to
// 128 and is padded to a multiple of 16 in shared memory only (72 -> 80).
// Causal blocks skip the tiles wholly above the diagonal.
#include "attention_common.cuh"

namespace videoitg {

// ---------------------------------------------------------------- forward --

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_train_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv,
                       int S, int D, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * (DP + kPad);
  __nv_bfloat16* vt = ks + kBlockK * (DP + kPad);
  __shared__ bool key_ok[kBlockK];

  const float scale_log2 = sm_scale * kLog2e;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const size_t stat_base = (static_cast<size_t>(b) * Hq + h) * S;
  const uint8_t* vrow = valid == nullptr ? nullptr : valid + static_cast<size_t>(b) * S;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int row1 = row0 + 8;

  load_rows<kBlockQ, DP>(qs, q + q_base, q0, S, D);
  __syncthreads();
  uint32_t qa[DP / 16][4];
  load_q_fragments<DP>(qa, qs, warp, g, t);

  int n_tiles = (S + kBlockK - 1) / kBlockK;
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
    load_rows<kBlockK, DP>(ks, k + kv_base, k0, S, D);
    load_rows_transposed<kBlockK, DP>(vt, v + kv_base, k0, S, D);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      key_ok[threadIdx.x] = key < S && (vrow == nullptr || vrow[key] != 0);
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
        const bool ok = key_ok[local];
        if (!ok || (causal && key > row0)) s[nb][j] = -INFINITY;
        if (!ok || (causal && key > row1)) s[nb][2 + j] = -INFINITY;
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

  const bool q_ok0 = row0 < S && (vrow == nullptr || vrow[row0] != 0);
  const bool q_ok1 = row1 < S && (vrow == nullptr || vrow[row1] != 0);
  store_rows<DP>(o + q_base, acc, row0, l0, !(q_ok0 && l0 > 0.f), row1, l1,
                 !(q_ok1 && l1 > 0.f), S, D, t);
  if (t == 0) {
    // A dead row (no visible valid key) stores +inf: exp(s - lse) is then 0
    // for every key in the backward.
    if (row0 < S) lse[stat_base + row0] = l0 > 0.f ? m0 * sm_scale + logf(l0) : INFINITY;
    if (row1 < S) lse[stat_base + row1] = l1 > 0.f ? m1 * sm_scale + logf(l1) : INFINITY;
  }
}

// --------------------------------------------------------------------- dQ --

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_train_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Hq,
                      int Hkv, int S, int D, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Q, then dO
  __nv_bfloat16* ks = xs + kBlockQ * (DP + kPad);
  __nv_bfloat16* vs = ks + kBlockK * (DP + kPad);
  __nv_bfloat16* kts = vs + kBlockK * (DP + kPad);
  __shared__ bool key_ok[kBlockK];

  const float scale_log2 = sm_scale * kLog2e;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const size_t stat_base = (static_cast<size_t>(b) * Hq + h) * S;
  const uint8_t* vrow = valid == nullptr ? nullptr : valid + static_cast<size_t>(b) * S;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  uint32_t qa[DP / 16][4], doa[DP / 16][4];
  load_rows<kBlockQ, DP>(xs, q + q_base, q0, S, D);
  __syncthreads();
  load_q_fragments<DP>(qa, xs, warp, g, t);
  __syncthreads();
  load_rows<kBlockQ, DP>(xs, dout + q_base, q0, S, D);
  __syncthreads();
  load_q_fragments<DP>(doa, xs, warp, g, t);

  // lse in log2 units; rows beyond S behave like dead rows.
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
    load_rows_both<kBlockK, DP>(ks, kts, k + kv_base, k0, S, D);
    load_rows<kBlockK, DP>(vs, v + kv_base, k0, S, D);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      key_ok[threadIdx.x] = key < S && (vrow == nullptr || vrow[key] != 0);
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
          const bool ok = key_ok[local];
          const bool see0 = ok && !(causal && key > row0);
          const bool see1 = ok && !(causal && key > row1);
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
  store_scaled_rows<DP>(dq + q_base, acc, sm_scale, row0, row1, S, D, t);
}

// ------------------------------------------------------------------ dK/dV --

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_train_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int S, int D,
                       int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlockK * (DP + kPad);
  __nv_bfloat16* qs = vs + kBlockK * (DP + kPad);
  __nv_bfloat16* dos = qs + kBlockQ * (DP + kPad);
  __nv_bfloat16* qts = dos + kBlockQ * (DP + kPad);
  __nv_bfloat16* dots = qts + DP * (kBlockQ + kPad);
  __shared__ float lse_s[kBlockQ];    // log2 units, +inf beyond S
  __shared__ float delta_s[kBlockQ];

  const float scale_log2 = sm_scale * kLog2e;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const uint8_t* vrow = valid == nullptr ? nullptr : valid + static_cast<size_t>(b) * S;
  const int k0 = blockIdx.x * kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
  const int key1 = key0 + 8;
  const bool kok0 = key0 < S && (vrow == nullptr || vrow[key0] != 0);
  const bool kok1 = key1 < S && (vrow == nullptr || vrow[key1] != 0);

  load_rows<kBlockK, DP>(ks, k + kv_base, k0, S, D);
  load_rows<kBlockK, DP>(vs, v + kv_base, k0, S, D);

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    dk_acc[nb][0] = dk_acc[nb][1] = dk_acc[nb][2] = dk_acc[nb][3] = 0.f;
    dv_acc[nb][0] = dv_acc[nb][1] = dv_acc[nb][2] = dv_acc[nb][3] = 0.f;
  }

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  // Causal: query tiles before this key tile see none of its keys.
  const int qt_begin = causal ? static_cast<int>(blockIdx.x) : 0;

  for (int hg = 0; hg < group; ++hg) {
    const int h = hk * group + hg;
    const size_t q_base = (static_cast<size_t>(b) * Hq + h) * S * D;
    const size_t stat_base = (static_cast<size_t>(b) * Hq + h) * S;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();
      load_rows_both<kBlockQ, DP>(qs, qts, q + q_base, q0, S, D);
      load_rows_both<kBlockQ, DP>(dos, dots, dout + q_base, q0, S, D);
      if (threadIdx.x < kBlockQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lse[stat_base + row] * kLog2e : INFINITY;
        delta_s[threadIdx.x] = row < S ? delta[stat_base + row] : 0.f;
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
            const float l2 = lse_s[local];
            const float dl = delta_s[local];
            const bool see0 = kok0 && !(causal && key0 > qrow);
            const bool see1 = kok1 && !(causal && key1 > qrow);
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
  }
  store_scaled_rows<DP>(dv + kv_base, dv_acc, 1.0f, key0, key1, S, D, t);
  store_scaled_rows<DP>(dk + kv_base, dk_acc, sm_scale, key0, key1, S, D, t);
}

// --------------------------------------------------------------- launches --

struct TrainArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const uint8_t* valid;
  const float *lse_in, *delta;
  __nv_bfloat16 *o, *dq, *dk, *dv;
  float* lse_out;
  int B, Hq, Hkv, S, D, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <int DP>
cudaError_t launch_fwd(const TrainArgs& a) {
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_train_fwd_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
  flash_train_fwd_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.valid, a.o, a.lse_out, a.Hq, a.Hkv, a.S, a.D, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const TrainArgs& a) {
  constexpr int smem = dq_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_train_dq_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
  flash_train_dq_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.valid, a.dout, a.lse_in, a.delta, a.dq, a.Hq, a.Hkv, a.S, a.D, a.causal,
      a.sm_scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const TrainArgs& a) {
  constexpr int smem = dkv_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_train_dkv_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kBlockK - 1) / kBlockK, a.Hkv, a.B);
  flash_train_dkv_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.valid, a.dout, a.lse_in, a.delta, a.dk, a.dv, a.Hq, a.Hkv, a.S, a.D,
      a.causal, a.sm_scale);
  return cudaGetLastError();
}

static bool shapes_ok(const TrainArgs& a) {
  return a.B > 0 && a.Hq > 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.S > 0 && a.D > 0 &&
         a.D <= 128 && a.D % 8 == 0 && a.B <= 65535 && a.Hq <= 65535;
}

}  // namespace videoitg

// Shapes for all three: q, out, dout, dq contiguous bf16 [B, Hq, S, D]; k, v,
// dk, dv contiguous bf16 [B, Hkv, S, D]; lse, delta contiguous fp32
// [B, Hq, S]; valid contiguous uint8/bool [B, S] or null (every key valid).
// Hq % Hkv == 0, D a multiple of 8 and at most 128. Each launches on `stream`
// and returns cudaGetLastError().

extern "C" int videoitg_flash_train_fwd_bf16(const void* q, const void* k, const void* v,
                                             const void* valid, void* out, void* lse, int B,
                                             int Hq, int Hkv, int S, int D, int causal,
                                             float sm_scale, void* stream) {
  using namespace videoitg;
  TrainArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.valid = static_cast<const uint8_t*>(valid);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.lse_out = static_cast<float*>(lse);
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_fwd, a)
}

extern "C" int videoitg_flash_train_dq_bf16(const void* q, const void* k, const void* v,
                                            const void* valid, const void* dout,
                                            const void* lse, const void* delta, void* dq, int B,
                                            int Hq, int Hkv, int S, int D, int causal,
                                            float sm_scale, void* stream) {
  using namespace videoitg;
  TrainArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.valid = static_cast<const uint8_t*>(valid);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_dq, a)
}

extern "C" int videoitg_flash_train_dkv_bf16(const void* q, const void* k, const void* v,
                                             const void* valid, const void* dout,
                                             const void* lse, const void* delta, void* dk,
                                             void* dv, int B, int Hq, int Hkv, int S, int D,
                                             int causal, float sm_scale, void* stream) {
  using namespace videoitg;
  TrainArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.valid = static_cast<const uint8_t*>(valid);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_dkv, a)
}
