// Short-sequence attention for the SigLIP vision tower (sm_90a).
//
// Replaces the TPU kernel `_short_kernel` in
// videoitg_tpu/ops/flash_attention_short.py (entry `flash_mha_short`):
// non-causal, unmasked multi-head attention with Hq == Hkv, fp32 scores, the
// exact softmax (max, exp2, sum, divide) with the scale folded into exp2,
// the normalised P rounded to bf16 into P V, fp32 accumulation.
//
// What bounds it on an H100, at the main-path shape q/k/v [128 frames, 16
// heads, 729, 72] bf16: the attention products are 4*S^2*D = 153 MFLOP per
// (frame, head), 313 GFLOP per call, against 4 x 215 MB = 860 MB of q/k/v/o.
// That is ~364 FLOP per byte, above the card's ~295 bf16 ridge, so the
// tensor cores are the limit, not HBM.
//
// Design: one block per (frame x head, 64-query tile), 4 warps of 16 query
// rows, mma.sync m16n8k16 in bf16 with fp32 accumulation for both products.
// The TPU kernel divides P by its row sum before rounding P to bf16, so each
// row's max and sum are needed before any P V: the kernel walks the keys
// twice. Pass 1 computes Q K^T, the row max and the fp32 sum of
// exp2((s - max) * scale * log2 e) online (the sum rescaled when the max
// grows); pass 2 recomputes Q K^T, takes p = exp2((s - max) * scale * log2 e)
// times the row's 1 / sum, rounds p to bf16 and accumulates P V. Two
// departures from the TPU arithmetic, both at fp32 rounding level before p
// is rounded to bf16: the online sum rounds differently from a sum taken
// after the max is known, and p is multiplied by the reciprocal (the TPU
// kernel's `recip` arm) where `exact` divides; a divide per score cost 10%
// more time. The second Q K^T costs 50% more MMA work than one pass but keeps
// the score row out of shared memory (729 fp32 scores x 64 rows would take
// 187 KB and leave one block per SM). The online sum lifts the kernel to 143
// registers and 3 blocks per SM; the launch bound holds it to 128 registers
// (an 8-byte spill) and 4 blocks, which took the call from 8.30 to 6.68 ms
// on an H100 80GB HBM3 at 700 W. D = 72 is zero-padded to 80 in shared memory for
// the k16 MMA step (exact: the zero columns add nothing to Q K^T); S = 729
// is masked at the ragged tile edge; padded rows are never stored. K tiles
// of one (frame, head) are re-read by its 12 query tiles from L2.
#include "attention_common.cuh"

namespace videoitg {

template <int DP>
__global__ void __launch_bounds__(kThreads, 4)
short_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       int S, int D, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * (DP + kPad);
  __nv_bfloat16* vt = ks + kBlockK * (DP + kPad);

  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;  // (frame, head)
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_rows<kBlockQ, DP>(qs, q + base, q0, S, D);
  __syncthreads();
  uint32_t qa[DP / 16][4];
  load_q_fragments<DP>(qa, qs, warp, g, t);

  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  float s[kBlockK / 8][4];

  // Pass 1: the row max of the raw scores and the row sum of exp2, online.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_rows<kBlockK, DP>(ks, k + base, kt * kBlockK, S, D);
    __syncthreads();
    tile_scores<DP>(s, qa, ks, g, t);
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kt * kBlockK + nb * 8 + 2 * t + j < S) {
          t0 = fmaxf(t0, s[nb][j]);
          t1 = fmaxf(t1, s[nb][2 + j]);
        }
      }
    }
    // Every tile holds at least one key < S, so the new max is finite.
    const float n0 = fmaxf(m0, quad_max(t0));
    const float n1 = fmaxf(m1, quad_max(t1));
    l0 *= exp2f((m0 - n0) * scale_log2);
    l1 *= exp2f((m1 - n1) * scale_log2);
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kt * kBlockK + nb * 8 + 2 * t + j < S) {
          l0 += exp2f((s[nb][j] - m0) * scale_log2);
          l1 += exp2f((s[nb][2 + j] - m1) * scale_log2);
        }
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // Pass 2: p = exp2((s - max) * scale) / sum, rounded to bf16 into P V.
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  float acc[DP / 8][4];
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_rows<kBlockK, DP>(ks, k + base, kt * kBlockK, S, D);
    load_rows_transposed<kBlockK, DP>(vt, v + base, kt * kBlockK, S, D);
    __syncthreads();
    tile_scores<DP>(s, qa, ks, g, t);
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool key_ok = kt * kBlockK + nb * 8 + 2 * t + j < S;
        s[nb][j] = key_ok ? exp2f((s[nb][j] - m0) * scale_log2) * r0 : 0.f;
        s[nb][2 + j] = key_ok ? exp2f((s[nb][2 + j] - m1) * scale_log2) * r1 : 0.f;
      }
    }
    tile_pv<DP>(acc, s, vt, g, t);
  }

  const int row = q0 + warp * 16 + g;
  store_rows<DP>(o + base, acc, row, 1.f, false, row + 8, 1.f, false, S, D, t);  // P is normalised
}

template <int DP>
cudaError_t launch_short(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, int BH, int S, int D,
                         float scale_log2, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        short_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(BH, (S + kBlockQ - 1) / kBlockQ);
  short_attention_kernel<DP><<<grid, kThreads, smem, stream>>>(q, k, v, o, S, D, scale_log2);
  return cudaGetLastError();
}

}  // namespace videoitg

// q, k, v, out: contiguous bf16 [B, H, S, D] on the current device, D a
// multiple of 8 and at most 128. Launches on `stream`; returns cudaGetLastError().
extern "C" int videoitg_flash_mha_short_bf16(const void* q, const void* k, const void* v,
                                             void* out, int B, int H, int S, int D,
                                             float sm_scale, void* stream) {
  using namespace videoitg;
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > 128 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  auto st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  switch ((D + 15) / 16) {
    case 1: return static_cast<int>(launch_short<16>(qp, kp, vp, op, BH, S, D, scale_log2, st));
    case 2: return static_cast<int>(launch_short<32>(qp, kp, vp, op, BH, S, D, scale_log2, st));
    case 3: return static_cast<int>(launch_short<48>(qp, kp, vp, op, BH, S, D, scale_log2, st));
    case 4: return static_cast<int>(launch_short<64>(qp, kp, vp, op, BH, S, D, scale_log2, st));
    case 5: return static_cast<int>(launch_short<80>(qp, kp, vp, op, BH, S, D, scale_log2, st));
    case 6: return static_cast<int>(launch_short<96>(qp, kp, vp, op, BH, S, D, scale_log2, st));
    case 7: return static_cast<int>(launch_short<112>(qp, kp, vp, op, BH, S, D, scale_log2, st));
    default: return static_cast<int>(launch_short<128>(qp, kp, vp, op, BH, S, D, scale_log2, st));
  }
}

extern "C" const char* videoitg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
