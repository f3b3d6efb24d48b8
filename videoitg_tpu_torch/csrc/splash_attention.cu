// Non-causal multi-query attention with a segment-id mask, for the grounding
// LM's serving prefill (sm_90a).
//
// Replaces the TPU kernel behind `_splash_lm` in videoitg_tpu/ops/attention.py:
// jax's library splash MQA forward kernel (made by `_make_splash_kernel`,
// `make_splash_mqa_single_device` with a full mask), vmapped over KV heads and
// batch. Contract, as that kernel has it: q arrives ALREADY SCALED (the kernel
// multiplies the scores by nothing); q_seg and kv_seg are int32 [B, S]
// segment ids and a query attends a key iff their ids are equal; fp32 scores,
// running max and sum, natural exp; one KV head serves the `group` query
// heads of its group. P is rounded to bf16 into P V (the tensor cores take
// bf16 operands); fp32 accumulation; out = acc / l. A query whose id matches
// no key outputs 0 (it cannot occur when q_seg and kv_seg are the same
// array, as in `splash_lm`: a query always matches itself). There is no
// padding in device memory: the ragged edge of the last tile is masked here,
// rows beyond S are never written.
//
// What bounds it on an H100, at the main-path shape q [1, 28, 13056, 128],
// k/v [1, 4, 13056, 128] bf16: the same work as flash_attention.cu,
// 4*S^2*D*Hq = 2.44 TFLOP against 214 MB of q/k/v/o, so the tensor cores
// bound it, not HBM.
//
// How it differs from flash_attention.cu (kernel B). B gives one block one
// query head: 4 warps x 16 rows of that head, so every K/V tile is staged in
// shared memory once per query head, 7 times per KV head and query tile.
// Here one block owns (batch, KV head, a query tile) for the WHOLE group:
// warp w holds 16 query rows of query head w / kSplashRowGroups, and each
// K/V tile is staged once for all of them (7 heads x 32 rows = 14 warps read
// one 64-key tile: 3.5x fewer global -> shared copies than B for the same
// products). Seven heads' accumulators (7 x [rows x 128] fp32) cannot live in
// one warp's registers, so the group is spread over warps, not looped. To fit
// 448 threads' registers (at most 146 each) the scores are formed 32 keys at
// a time, and Q fragments come straight from global memory (no Q tile in
// shared memory). V stays row-major in shared memory and reaches the MMA's
// B operand through ldmatrix.trans: no transposed 2-byte scatter as in B.
// Groups above 7 heads are split over several blocks.
//
// ptxas (CUDA 12.8, sm_90a) at D = 128: 128 registers a thread under the
// 448-thread bound, 112 bytes of spill stores and 236 of loads, 35 KB of
// shared memory, so one block (14 warps) an SM. With 16 rows a head in a block
// (7 warps, 181 registers, no spill) the same call took 24.5 ms against 17.1
// ms with 32, and kernel B 27.4 ms, on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py).
#include "attention_common.cuh"

namespace videoitg {

constexpr int kSplashMaxHeads = 7;   // query heads per block, one warp per 16 rows each
constexpr int kSplashRowGroups = 2;  // 16-row groups per query head in a block
constexpr int kSplashSub = 32;        // keys per online-softmax step

// Four 8x8 bf16 matrices, transposed on the way: lanes 8i..8i+7 give the row
// addresses of matrix i; thread (g, t) receives M_i[2t..2t+1][g] in r[i].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int DP>
__global__ void __launch_bounds__(kSplashMaxHeads * kSplashRowGroups * 32)
splash_mqa_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_seg,
                  const int* __restrict__ kv_seg, __nv_bfloat16* __restrict__ o, int Hq,
                  int Hkv, int S, int D, int heads_per_block, int chunks) {
  constexpr int RG = kSplashRowGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBlockK][DP + kPad]
  __nv_bfloat16* vs = ks + kBlockK * (DP + kPad);                  // [kBlockK][DP + kPad]
  __shared__ int key_seg[kBlockK];

  const int group = Hq / Hkv;
  const int hk = blockIdx.y / chunks;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int head_in_group = (blockIdx.y % chunks) * heads_per_block + warp / RG;
  // A warp beyond the group (the last chunk of a group that does not divide)
  // takes part in the loads and barriers only.
  const bool active = head_in_group < group;
  const int h = hk * group + min(head_in_group, group - 1);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const int* qseg_b = q_seg + static_cast<size_t>(b) * S;
  const int* kseg_b = kv_seg + static_cast<size_t>(b) * S;
  const int row0 = blockIdx.x * (16 * RG) + (warp % RG) * 16 + g;  // and row0 + 8
  const int row1 = row0 + 8;
  const int qid0 = row0 < S ? qseg_b[row0] : 0;
  const int qid1 = row1 < S ? qseg_b[row1] : 0;

  // Q as A fragments, read once from global memory; rows >= S and columns
  // >= D read as zeros.
  uint32_t qa[DP / 16][4];
  {
    const __nv_bfloat16* r0 = q + q_base + static_cast<size_t>(row0) * D;
    const __nv_bfloat16* r1 = q + q_base + static_cast<size_t>(row1) * D;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      const int c1 = c0 + 8;
      qa[kk][0] = (row0 < S && c0 < D) ? ld_pair(r0 + c0) : 0u;
      qa[kk][1] = (row1 < S && c0 < D) ? ld_pair(r1 + c0) : 0u;
      qa[kk][2] = (row0 < S && c1 < D) ? ld_pair(r0 + c1) : 0u;
      qa[kk][3] = (row1 < S && c1 < D) ? ld_pair(r1 + c1) : 0u;
    }
  }

  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the scores
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float acc[DP / 8][4];
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;

  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_rows<kBlockK, DP>(ks, k + kv_base, k0, S, D);
    load_rows<kBlockK, DP>(vs, v + kv_base, k0, S, D);  // rows >= S are zeros
    for (int i = threadIdx.x; i < kBlockK; i += blockDim.x) {
      key_seg[i] = k0 + i < S ? kseg_b[k0 + i] : 0;
    }
    __syncthreads();
    if (!active) continue;

#pragma unroll
    for (int sub = 0; sub < kBlockK / kSplashSub; ++sub) {
      const int sub0 = sub * kSplashSub;
      float s[kSplashSub / 8][4];
#pragma unroll
      for (int nb = 0; nb < kSplashSub / 8; ++nb) {
        s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
        const __nv_bfloat16* krow = ks + (sub0 + nb * 8 + g) * (DP + kPad);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          mma_16816(s[nb], qa[kk], ld_pair(krow + kk * 16 + 2 * t),
                    ld_pair(krow + kk * 16 + 8 + 2 * t));
        }
      }

      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < kSplashSub / 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int local = sub0 + nb * 8 + 2 * t + j;
          const bool in_range = k0 + local < S;
          const int kid = key_seg[local];
          if (!(in_range && kid == qid0)) s[nb][j] = -INFINITY;
          if (!(in_range && kid == qid1)) s[nb][2 + j] = -INFINITY;
          tm0 = fmaxf(tm0, s[nb][j]);
          tm1 = fmaxf(tm1, s[nb][2 + j]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(tm0));
      const float mn1 = fmaxf(m1, quad_max(tm1));
      // A row with no matching key yet keeps max -inf; subtracting 0 then
      // keeps every p (and alpha) at exp2(-inf) = 0 instead of NaN.
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float alpha0 = exp2f((m0 - base0) * kLog2e);
      const float alpha1 = exp2f((m1 - base1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < kSplashSub / 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[nb][j] = exp2f((s[nb][j] - base0) * kLog2e);
          s[nb][2 + j] = exp2f((s[nb][2 + j] - base1) * kLog2e);
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

      // acc += P V. The score fragments are already the A layout of P; V's
      // B fragments (k = key, n = d) come transposed out of the row-major
      // tile: matrices 0, 1 are keys 0..7, 8..15 at d block 2*nb2, matrices
      // 2, 3 the same keys at d block 2*nb2 + 1.
#pragma unroll
      for (int kk = 0; kk < kSplashSub / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const __nv_bfloat16* vrow =
            vs + (sub0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * (DP + kPad) +
            (lane >> 4) * 8;
#pragma unroll
        for (int nb2 = 0; nb2 < DP / 16; ++nb2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + nb2 * 16);
          mma_16816(acc[2 * nb2], pa, vb[0], vb[1]);
          mma_16816(acc[2 * nb2 + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows<DP>(o + q_base, acc, row0, l0, !(l0 > 0.f), row1, l1, !(l1 > 0.f), S, D, t);
}

template <int DP>
cudaError_t launch_splash(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int* q_seg, const int* kv_seg,
                          __nv_bfloat16* o, int B, int Hq, int Hkv, int S, int D,
                          cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(__nv_bfloat16)) * 2 * kBlockK * (DP + kPad);
  constexpr int rows = 16 * kSplashRowGroups;
  const int group = Hq / Hkv;
  const int chunks = (group + kSplashMaxHeads - 1) / kSplashMaxHeads;
  const int heads_per_block = (group + chunks - 1) / chunks;
  if (static_cast<long long>(Hkv) * chunks > 65535) return cudaErrorInvalidValue;
  dim3 grid((S + rows - 1) / rows, Hkv * chunks, B);
  splash_mqa_kernel<DP><<<grid, heads_per_block * kSplashRowGroups * 32, smem, stream>>>(
      q, k, v, q_seg, kv_seg, o, Hq, Hkv, S, D, heads_per_block, chunks);
  return cudaGetLastError();
}

}  // namespace videoitg

// q (already scaled), out: contiguous bf16 [B, Hq, S, D]; k, v: contiguous bf16
// [B, Hkv, S, D]; q_seg, kv_seg: contiguous int32 [B, S]. Hq % Hkv == 0, D a
// multiple of 8 and at most 128. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int videoitg_splash_mqa_bf16(const void* q, const void* k, const void* v,
                                        const void* q_seg, const void* kv_seg, void* out,
                                        int B, int Hq, int Hkv, int S, int D, void* stream) {
  using namespace videoitg;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* qs = static_cast<const int*>(q_seg);
  const auto* ss = static_cast<const int*>(kv_seg);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return static_cast<int>(launch_splash<16>(qp, kp, vp, qs, ss, op, B, Hq, Hkv, S, D, st));
    case 2: return static_cast<int>(launch_splash<32>(qp, kp, vp, qs, ss, op, B, Hq, Hkv, S, D, st));
    case 3: return static_cast<int>(launch_splash<48>(qp, kp, vp, qs, ss, op, B, Hq, Hkv, S, D, st));
    case 4: return static_cast<int>(launch_splash<64>(qp, kp, vp, qs, ss, op, B, Hq, Hkv, S, D, st));
    case 5: return static_cast<int>(launch_splash<80>(qp, kp, vp, qs, ss, op, B, Hq, Hkv, S, D, st));
    case 6: return static_cast<int>(launch_splash<96>(qp, kp, vp, qs, ss, op, B, Hq, Hkv, S, D, st));
    case 7: return static_cast<int>(launch_splash<112>(qp, kp, vp, qs, ss, op, B, Hq, Hkv, S, D, st));
    default: return static_cast<int>(launch_splash<128>(qp, kp, vp, qs, ss, op, B, Hq, Hkv, S, D, st));
  }
}
