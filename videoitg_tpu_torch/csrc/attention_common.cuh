// Shared pieces of the attention kernels (flash_attention.cu,
// flash_attention_short.cu, splash_attention.cu, flash_attention_train.cu,
// flash_attention_segment.cu): the bf16 tensor-core MMA, bf16 packing, the
// global -> shared tile loaders, and the fragment products of the two
// backward kernels.
//
// The kernels give each warp 16 query rows and use mma.sync m16n8k16
// (bf16 operands, fp32 accumulation). Fragment ownership, with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                         a3 = (g+8, 2t+8..)
//   B (16x8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// so a thread owns two query rows (g and g+8) of its warp's 16, and the
// score fragment of S = Q K^T is already the A fragment of P for P V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace videoitg {

constexpr int kBlockQ = 64;   // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 elements of row padding in shared memory
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + ROWS) of a [S, D] bf16 matrix -> smem [ROWS][DP + kPad].
// Rows >= S and columns >= D are written as zeros (D % 8 == 0, so every
// 16-byte chunk is either all data or all padding).
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int S, int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && c < D) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (DP + kPad) + c) = val;
  }
}

// rows [row0, row0 + ROWS) of a [S, D] bf16 matrix -> transposed smem
// [DP][ROWS + kPad], zero-filled like load_rows. P V reads V as the MMA's
// B operand (k = key, n = d): transposed, a thread's key pair is contiguous.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows_transposed(__nv_bfloat16* dst,
                                                     const __nv_bfloat16* src,
                                                     int row0, int S, int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += blockDim.x) {
    const int r = idx % ROWS;  // neighbouring threads take neighbouring keys
    const int c = (idx / ROWS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && c < D) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    }
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * (ROWS + kPad) + r] = e[i];
  }
}

// The Q tile as A fragments held in registers for the whole key loop.
template <int DP>
__device__ __forceinline__ void load_q_fragments(uint32_t qa[DP / 16][4],
                                                 const __nv_bfloat16* qs, int warp,
                                                 int g, int t) {
  const __nv_bfloat16* r0 = qs + (warp * 16 + g) * (DP + kPad);
  const __nv_bfloat16* r1 = r0 + 8 * (DP + kPad);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    qa[kk][0] = ld_pair(r0 + kk * 16 + 2 * t);
    qa[kk][1] = ld_pair(r1 + kk * 16 + 2 * t);
    qa[kk][2] = ld_pair(r0 + kk * 16 + 8 + 2 * t);
    qa[kk][3] = ld_pair(r1 + kk * 16 + 8 + 2 * t);
  }
}

// s[nb] = Q K^T for this warp's 16 rows and the tile's keys nb*8 .. nb*8+7.
template <int DP>
__device__ __forceinline__ void tile_scores(float s[kBlockK / 8][4],
                                            const uint32_t qa[DP / 16][4],
                                            const __nv_bfloat16* ks, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < kBlockK / 8; ++nb) {
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    const __nv_bfloat16* krow = ks + (nb * 8 + g) * (DP + kPad);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_16816(s[nb], qa[kk], ld_pair(krow + kk * 16 + 2 * t),
                ld_pair(krow + kk * 16 + 8 + 2 * t));
    }
  }
}

// acc += P V with P = bf16(p) taken from the score fragments (already in the
// A layout) and V from the transposed tile.
template <int DP>
__device__ __forceinline__ void tile_pv(float acc[DP / 8][4], const float p[kBlockK / 8][4],
                                        const __nv_bfloat16* vt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const __nv_bfloat16* vrow = vt + (nb * 8 + g) * (kBlockK + kPad) + kk * 16;
      mma_16816(acc[nb], pa, ld_pair(vrow + 2 * t), ld_pair(vrow + 8 + 2 * t));
    }
  }
}

// Reductions over the 4 threads (t = 0..3) that share a query row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// out row = acc / l, or 0 where `zero` (no valid key, or an invalid query
// row); rows >= S and columns >= D are not stored.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float acc[DP / 8][4],
                                           int row_g, float l_g, bool zero_g, int row_g8,
                                           float l_g8, bool zero_g8, int S, int D, int t) {
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    const int col = nb * 8 + 2 * t;
    if (col >= D) continue;
    if (row_g < S) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_g) * D + col) =
          zero_g ? 0u : pack_bf16(acc[nb][0] / l_g, acc[nb][1] / l_g);
    }
    if (row_g8 < S) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_g8) * D + col) =
          zero_g8 ? 0u : pack_bf16(acc[nb][2] / l_g8, acc[nb][3] / l_g8);
    }
  }
}

template <int DP>
constexpr int smem_bytes() {
  // Q tile, K tile, transposed V tile.
  return static_cast<int>(sizeof(__nv_bfloat16)) *
         ((kBlockQ + kBlockK) * (DP + kPad) + DP * (kBlockK + kPad));
}

// ------------------------------------------------- pieces of the backward --

// c[nb] = A B^T for one warp: A is 16 x DP as fragments, B the NB * 8 rows of
// a row-major [.][DP + kPad] tile that start at `rows`.
template <int DP, int NB>
__device__ __forceinline__ void fragments_times_rows(float c[NB][4], const uint32_t a[DP / 16][4],
                                                     const __nv_bfloat16* rows, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    c[nb][0] = c[nb][1] = c[nb][2] = c[nb][3] = 0.f;
    const __nv_bfloat16* row = rows + (nb * 8 + g) * (DP + kPad);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_16816(c[nb], a[kk], ld_pair(row + kk * 16 + 2 * t), ld_pair(row + kk * 16 + 8 + 2 * t));
    }
  }
}

// acc += A B for one warp: A is one 16 x 16 fragment, B[k][n] = tt[n][k], with
// `tt` pointing at column k = 0 of a transposed tile [DP][kBlockK + kPad].
template <int DP>
__device__ __forceinline__ void fragment_times_transposed(float acc[DP / 8][4],
                                                          const uint32_t a[4],
                                                          const __nv_bfloat16* tt, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    const __nv_bfloat16* row = tt + (nb * 8 + g) * (kBlockK + kPad);
    mma_16816(acc[nb], a, ld_pair(row + 2 * t), ld_pair(row + 8 + 2 * t));
  }
}

// The A fragment (16 rows from `row_base`, columns kk * 16 ..) of a row-major
// [.][DP + kPad] tile.
template <int DP>
__device__ __forceinline__ void load_a_fragment(uint32_t a[4], const __nv_bfloat16* tile,
                                                int row_base, int kk, int g, int t) {
  const __nv_bfloat16* r0 = tile + (row_base + g) * (DP + kPad) + kk * 16;
  const __nv_bfloat16* r1 = r0 + 8 * (DP + kPad);
  a[0] = ld_pair(r0 + 2 * t);
  a[1] = ld_pair(r1 + 2 * t);
  a[2] = ld_pair(r0 + 8 + 2 * t);
  a[3] = ld_pair(r1 + 8 + 2 * t);
}

// rows [row0, row0 + ROWS) of a [S, D] matrix into both layouts at once:
// `dst` [ROWS][DP + kPad] and `dst_t` [DP][ROWS + kPad], zero-filled beyond S
// and D like load_rows.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows_both(__nv_bfloat16* dst, __nv_bfloat16* dst_t,
                                               const __nv_bfloat16* src, int row0, int S,
                                               int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += blockDim.x) {
    const int r = idx % ROWS;  // neighbouring threads take neighbouring rows
    const int c = (idx / ROWS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && c < D) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (DP + kPad) + c) = val;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst_t[(c + i) * (ROWS + kPad) + r] = e[i];
  }
}

// out rows = acc * scale as bf16; rows >= S and columns >= D are not stored.
template <int DP>
__device__ __forceinline__ void store_scaled_rows(__nv_bfloat16* out, const float acc[DP / 8][4],
                                                  float scale, int row_g, int row_g8, int S,
                                                  int D, int t) {
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    const int col = nb * 8 + 2 * t;
    if (col >= D) continue;
    if (row_g < S) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_g) * D + col) =
          pack_bf16(acc[nb][0] * scale, acc[nb][1] * scale);
    }
    if (row_g8 < S) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_g8) * D + col) =
          pack_bf16(acc[nb][2] * scale, acc[nb][3] * scale);
    }
  }
}

// Shared memory of the dQ kernels and of the dK/dV kernels.
template <int DP>
constexpr int dq_smem_bytes() {
  // Q / dO staging tile, K, V (row-major), K transposed.
  return static_cast<int>(sizeof(__nv_bfloat16)) *
         (3 * kBlockK * (DP + kPad) + DP * (kBlockK + kPad));
}

template <int DP>
constexpr int dkv_smem_bytes() {
  // K, V, Q, dO (row-major), Q and dO transposed.
  return static_cast<int>(sizeof(__nv_bfloat16)) *
         (4 * kBlockK * (DP + kPad) + 2 * DP * (kBlockQ + kPad));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// One instantiation per head dim padded to a multiple of 16.
#define VIDEOITG_DISPATCH_DP(launch, args)                     \
  switch (((args).D + 15) / 16) {                              \
    case 1: return static_cast<int>(launch<16>(args));         \
    case 2: return static_cast<int>(launch<32>(args));         \
    case 3: return static_cast<int>(launch<48>(args));         \
    case 4: return static_cast<int>(launch<64>(args));         \
    case 5: return static_cast<int>(launch<80>(args));         \
    case 6: return static_cast<int>(launch<96>(args));         \
    case 7: return static_cast<int>(launch<112>(args));        \
    default: return static_cast<int>(launch<128>(args));       \
  }

}  // namespace videoitg
