// Streaming (flash) attention with native GQA for the grounding LM (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in videoitg_tpu/ops/flash_attention.py
// (entry `flash_mha`): online-softmax attention over K/V tiles, query head h
// reading KV head h / (Hq / Hkv) in place, non-causal or causal, a [B, S] key
// mask. Contract (the same as ops/attention.mha_reference): masked keys get
// exactly zero probability, a row with no visible valid key outputs 0, and
// invalid query rows output 0 (so a causal row whose visible prefix is all
// invalid gives future keys no weight either). fp32 scores, running max and
// sum; p rounded to bf16 into P V; fp32 accumulation.
//
// What bounds it on an H100, at the main-path shape q [1, 28, 13056, 128],
// k/v [1, 4, 13056, 128] bf16 (512 frames x 25 image slots + 256 text slots):
// the products are 4*S^2*D*Hq = 2.44 TFLOP per call against 214 MB of
// q/k/v/o, ~11,000 FLOP per byte: far above the ~295 bf16 ridge, so the
// tensor cores bound it and HBM traffic does not matter. The O(S^2) score
// matrix (19 GB in fp32 per layer if materialised) never leaves registers.
//
// Design: one block per (64-query tile, q head, batch); 4 warps of 16 query
// rows hold Q as MMA fragments in registers and loop over 64-key tiles of
// K and V staged in shared memory, with mma.sync m16n8k16 bf16 for Q K^T and
// P V. The score fragment of Q K^T is reused as the A fragment of P V, so P
// never touches shared memory. Running max and sum live in registers (two
// rows per thread, reduced across the 4 threads of a row with shuffles).
// GQA reads the shared KV head in place; its 6.7 MB of K/V per layer stay
// in L2 for the 7 q heads x 204 query tiles that read them. S = 13056 is
// 204 x 64, but other lengths need not be a multiple of 64: the ragged edge
// of the last tile is masked in the kernel, never padded in device memory.
// Causal blocks stop at their last visible tile.
#include "attention_common.cuh"

namespace videoitg {

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                       __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int S, int D,
                       int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * (DP + kPad);
  __nv_bfloat16* vt = ks + kBlockK * (DP + kPad);
  __shared__ bool key_ok[kBlockK];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * S * D;
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
}

template <int DP>
cudaError_t launch_flash(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const uint8_t* valid, __nv_bfloat16* o,
                         int B, int Hq, int Hkv, int S, int D, int causal, float scale_log2,
                         cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_attention_kernel<DP><<<grid, kThreads, smem, stream>>>(q, k, v, valid, o, Hq, Hkv, S,
                                                               D, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace videoitg

// q, out: contiguous bf16 [B, Hq, S, D]; k, v: contiguous bf16 [B, Hkv, S, D];
// valid: contiguous uint8/bool [B, S] or null (every key valid). Hq % Hkv == 0,
// D a multiple of 8 and at most 128. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int videoitg_flash_mha_bf16(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, int B, int Hq, int Hkv,
                                       int S, int D, int causal, float sm_scale,
                                       void* stream) {
  using namespace videoitg;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || B > 65535 || Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const uint8_t*>(valid);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const float sl = sm_scale * 1.4426950408889634f;
  auto st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return static_cast<int>(launch_flash<16>(qp, kp, vp, mp, op, B, Hq, Hkv, S, D, causal, sl, st));
    case 2: return static_cast<int>(launch_flash<32>(qp, kp, vp, mp, op, B, Hq, Hkv, S, D, causal, sl, st));
    case 3: return static_cast<int>(launch_flash<48>(qp, kp, vp, mp, op, B, Hq, Hkv, S, D, causal, sl, st));
    case 4: return static_cast<int>(launch_flash<64>(qp, kp, vp, mp, op, B, Hq, Hkv, S, D, causal, sl, st));
    case 5: return static_cast<int>(launch_flash<80>(qp, kp, vp, mp, op, B, Hq, Hkv, S, D, causal, sl, st));
    case 6: return static_cast<int>(launch_flash<96>(qp, kp, vp, mp, op, B, Hq, Hkv, S, D, causal, sl, st));
    case 7: return static_cast<int>(launch_flash<112>(qp, kp, vp, mp, op, B, Hq, Hkv, S, D, causal, sl, st));
    default: return static_cast<int>(launch_flash<128>(qp, kp, vp, mp, op, B, Hq, Hkv, S, D, causal, sl, st));
  }
}
