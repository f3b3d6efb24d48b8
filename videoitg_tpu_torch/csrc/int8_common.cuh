// Shared core of the two int8 kernels of the act8 serving tier that still
// run on mma.sync (fused_encoder.cu: G, I; F and H run on the TMA + s8 wgmma
// GEMM of hopper_int8_gemm.cuh and use the quantisers here): the s8
// tensor-core product of a warp tile, the weight-tile loader, per-row
// quantisation, and the loop that streams a weight matrix past an activation
// tile held in shared memory.
//
// Operands. Activations are int8 [rows][k] in shared memory and weights are
// int8 [n][k] in device memory, both with k contiguous: that is what
// mma.sync m16n8k32 (s8 x s8 -> s32, A row-major, B column-major) reads
// without a byte transpose. Fragment ownership, g = lane / 4, t = lane % 4:
//   A (16 x 32 int8): a0 = (row g,   k 4t..4t+3), a1 = (row g+8, k 4t..4t+3),
//                     a2 = (row g,   k 16+4t..),  a3 = (row g+8, k 16+4t..)
//   B (32 x 8 int8):  b0 = (k 4t..4t+3, n g),     b1 = (k 16+4t.., n g)
//   C (16 x 8 int32): c0, c1 = (row g, n 2t, 2t+1), c2, c3 = (row g+8, same n)
// Integer sums are exact, so the order of the k loop does not matter.
//
// Shared-memory rows are padded by 16 bytes. With k tiles of 128 bytes every
// row stride is 16 (mod 128) bytes, i.e. 4 words (mod 32): the 8 x 4 words of
// a fragment load fall into 32 different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace videoitg {

constexpr int kI8Threads = 256;   // 8 warps
constexpr int kI8Pad = 16;        // bytes of row padding in shared memory

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Loader of weight tiles: rows [n0, n0 + BN) x bytes [k0, k0 + BK) of w [N][K]
// -> smem [BN][BK + kI8Pad], one ring stage. Rows >= N and bytes >= K arrive
// as zeros (K % 16 == 0, so each 16-byte chunk is all data or all padding): a
// ragged last n tile and a K that is no multiple of BK are masked here and
// never padded in memory. A thread copies one 16-byte chunk of a row per
// pass, BN * BK / 16 / 256 passes a tile. Its source pointers and row masks
// are set once per n tile and its shared-memory addresses once per kernel,
// so that a tile costs a few instructions per chunk: with the addresses
// worked out per tile, this arithmetic alone took a third of kernel G's time
// (8 warps a block cannot hide it).
template <int BN, int BK>
struct WeightTileLoader {
  static constexpr int kRowChunks = BK / 16;                      // chunks of a tile row
  static constexpr int kPassRows = kI8Threads / kRowChunks;       // rows copied per pass
  static constexpr int kChunks = BN / kPassRows;                  // passes = chunks a thread
  static constexpr int kStride = BK + kI8Pad;
  const int8_t* src[kChunks];  // the chunk's address at k0 = 0 (w itself where the row is masked)
  bool row_ok[kChunks];
  uint32_t dst;                // shared address of this thread's first chunk in stage 0
  int c;                       // byte offset of the chunk within the k tile

  __device__ __forceinline__ WeightTileLoader(int8_t* ring) {
    c = (threadIdx.x % kRowChunks) * 16;
    dst = static_cast<uint32_t>(__cvta_generic_to_shared(ring)) +
          (threadIdx.x / kRowChunks) * kStride + c;
  }

  __device__ __forceinline__ void set_n_tile(const int8_t* __restrict__ w, int n0, int N, int K) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int row = n0 + threadIdx.x / kRowChunks + kPassRows * i;
      row_ok[i] = row < N;
      src[i] = row_ok[i] ? w + static_cast<size_t>(row) * K + c : w;
    }
  }

  // Start the copies of the tile at byte k0 into ring stage `stage`.
  __device__ __forceinline__ void fetch(int stage, int k0, int K) const {
    const bool k_ok = k0 + c < K;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const bool valid = row_ok[i] && k_ok;
      const int bytes = valid ? 16 : 0;  // 0: write zeros, read nothing
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(dst + (stage * BN + kPassRows * i) * kStride),
                      "l"(valid ? src[i] + k0 : src[i]), "r"(bytes));
    }
  }
};

// acc[mt][nt] += A(16*MT rows x BK k) * B(BK k x 8*NT n) for one warp.
// a: the warp's first row at the tile's first k, rows `a_stride` bytes apart;
// b: the warp's first n row of the weight tile (rows BK + kI8Pad bytes apart).
template <int MT, int NT, int BK>
__device__ __forceinline__ void warp_mma(int acc[MT][NT][4], const int8_t* a, int a_stride,
                                         const int8_t* b, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* p = a + (mt * 16 + g) * a_stride + ks * 32 + 4 * t;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * a_stride);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * a_stride + 16);
    }
    // B fragments in groups of at most 4 n tiles, to bound the registers.
    constexpr int NG = NT < 4 ? NT : 4;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      uint32_t bf[NG][2];
#pragma unroll
      for (int nt = 0; nt < NG; ++nt) {
        const int8_t* p = b + ((n0 + nt) * 8 + g) * (BK + kI8Pad) + ks * 32 + 4 * t;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NG; ++nt) mma_s8_16832(acc[mt][n0 + nt], af[mt], bf[nt]);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack4_s8(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// Eight values quantised as the JAX package quantises, round(y[e] / s) with a
// true IEEE division, round-half-to-even and clipped to +-127, given inv_s =
// 1 / s, without a division for almost every chunk. p = y * inv_s is within 3
// ulp of the true quotient (|quotient| <= 127, so within 2.3e-5), and p -
// rint(p) is exact;
// unless p lies within 1e-4 of a rounding boundary it rounds to the integer
// the true quotient rounds to. If any of the eight does lie that close (or p
// is not finite), the true division decides for the chunk: one rarely taken
// branch per chunk, and the int8 values are those of round(y / s) bit for bit.
__device__ __forceinline__ uint2 quant8_chunk(const float y[8], float s, float inv_s) {
  float n[8];
  bool near = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float p = __fmul_rn(y[e], inv_s);
    n[e] = rintf(p);
    near |= !(fabsf(__fsub_rn(p, n[e])) <= 0.4999f);
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < 8; ++e) n[e] = rintf(__fdiv_rn(y[e], s));
  }
  int q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) q[e] = static_cast<int>(fminf(fmaxf(n[e], -127.f), 127.f));
  return make_uint2(pack4_s8(q[0], q[1], q[2], q[3]), pack4_s8(q[4], q[5], q[6], q[7]));
}

// The scale of a row whose largest magnitude is amax: amax / 127, 1 for 0.
__device__ __forceinline__ float row_scale_of(float amax) {
  return amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
}

// acc * (row_scale * col_scale) + bias with every product and the sum rounded
// on its own (no fused multiply-add), the order of the plain versions.
__device__ __forceinline__ float scale_bias(int acc, float row_scale, float col_scale,
                                            float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(row_scale, col_scale)), bias);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& raw, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

constexpr int kMaxRowChunks = 8;            // 16-byte chunks of a row a lane may hold
constexpr int kMaxRowK = kMaxRowChunks * 256;  // so rows of at most 2048 values

// One block's rows [row0, row0 + BM) of x [rows][K] (bf16) -> per-row int8 in
// shared memory `as` ([BM][a_stride]) and the row scales in `rs` ([BM]).
// With LN, the row first goes through a two-pass fp32 LayerNorm
// (y = (x - mean) * rsqrt(var + eps) * lns + lnb). One warp per row; a lane
// loads its chunks of the row once, all loads in flight together, and keeps
// them in registers for the mean, variance, amax and quantise passes. Rows
// past the end become zeros with scale 1; bytes [K, k_pad) are zeroed.
// K % 8 == 0 and K <= kMaxRowK.
template <bool LN>
__device__ __forceinline__ void quantize_rows(int8_t* as, int a_stride, float* rs,
                                              const __nv_bfloat16* __restrict__ x,
                                              const float* __restrict__ lns,
                                              const float* __restrict__ lnb, float eps, int row0,
                                              int BM, int rows, int K, int k_pad) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = K / 8;
  for (int r = warp; r < BM; r += kI8Threads / 32) {
    int8_t* arow = as + r * a_stride;
    const int grow = row0 + r;
    if (grow >= rows) {
      for (int c = lane; c < k_pad / 8; c += 32) *reinterpret_cast<uint2*>(arow + c * 8) = make_uint2(0u, 0u);
      if (lane == 0) rs[r] = 1.f;
      continue;
    }
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(grow) * K);
    uint4 raw[kMaxRowChunks];
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i) {
      const int c = lane + 32 * i;
      raw[i] = c < chunks ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
    }
    float mean = 0.f, rstd = 1.f;
    if (LN) {
      float sum = 0.f;  // chunks past the end hold zeros
#pragma unroll
      for (int i = 0; i < kMaxRowChunks; ++i) {
        float v[8];
        unpack_bf16x8(raw[i], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += v[e];
      }
      mean = __fdiv_rn(warp_sum(sum), static_cast<float>(K));
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxRowChunks; ++i) {
        if (lane + 32 * i < chunks) {
          float v[8];
          unpack_bf16x8(raw[i], v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = __fsub_rn(v[e], mean);
            sq += __fmul_rn(d, d);
          }
        }
      }
      rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), static_cast<float>(K)), eps));
    }
    // y of one chunk, the same expression in the amax pass and the quantise pass.
    auto chunk_y = [&](int i, float y[8]) {
      unpack_bf16x8(raw[i], y);
      if (LN) {
        const int c = lane + 32 * i;
        const float4 s0 = *reinterpret_cast<const float4*>(lns + c * 8);
        const float4 s1 = *reinterpret_cast<const float4*>(lns + c * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(lnb + c * 8);
        const float4 b1 = *reinterpret_cast<const float4*>(lnb + c * 8 + 4);
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float n = __fmul_rn(__fsub_rn(y[e], mean), rstd);
          y[e] = __fadd_rn(__fmul_rn(n, sc[e]), bi[e]);
        }
      }
    };
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i) {
      if (lane + 32 * i < chunks) {
        float y[8];
        chunk_y(i, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(y[e]));
      }
    }
    const float s = row_scale_of(warp_max(amax));
    const float inv_s = __fdiv_rn(1.f, s);
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i) {
      if (lane + 32 * i < chunks) {
        float y[8];
        chunk_y(i, y);
        *reinterpret_cast<uint2*>(arow + (lane + 32 * i) * 8) = quant8_chunk(y, s, inv_s);
      }
    }
    for (int c = chunks + lane; c < k_pad / 8; c += 32) *reinterpret_cast<uint2*>(arow + c * 8) = make_uint2(0u, 0u);
    if (lane == 0) rs[r] = s;
  }
}

// out[BM rows][N] = A (int8 [BM][a_stride] in shared memory, K bytes deep) x
// w^T (int8 [N][K] in device memory), streamed as [BN][BK] tiles through a
// ring of STAGES cp.async buffers `bs` (STAGES x BN x (BK + kI8Pad) bytes),
// one barrier per tile; A's rows are padded to a multiple of BK. The block's 8 warps form a WM x WN grid of (16 MT) x
// (8 NT) warp tiles; BM = 16 MT WM, BN = 8 NT WN.
// `epi(row, col, v0, v1, slot)` receives the finished int32 sums of block row
// `row` and global columns `col`, `col + 1` (col even, < N); `slot` numbers
// the 2 MT rows a thread meets (a compile-time value after unrolling, so it
// can index registers). Blocks start at different n tiles (`first_n_tile`),
// so that they do not all ask L2 for the same weight lines at once. The
// caller has synchronised after writing A; the function ends on a barrier.
template <int WM, int WN, int MT, int NT, int STAGES, int BK, class Epi>
__device__ __forceinline__ void stream_gemm(const int8_t* as, int a_stride,
                                            const int8_t* __restrict__ w, int N, int K,
                                            int8_t* bs, int first_n_tile, Epi epi) {
  static_assert(WM * WN * 32 == kI8Threads, "8 warps");
  constexpr int BN = WN * NT * 8;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / WN;
  const int wn = warp % WN;
  constexpr int kBStride = BK + kI8Pad;
  const int nk = (K + BK - 1) / BK;
  const int nn = (N + BN - 1) / BN;
  const int total = nn * nk;
  int acc[MT][NT][4];

  // Tile j is (n tile, k tile) = (first + j / nk, j % nk); the positions of
  // the tile to fetch and of the tile to consume advance by counters, since an
  // integer division per tile is a long dependent chain for the 2 warps a
  // scheduler has.
  int nt_blk = first_n_tile % nn, kt = 0;     // the tile to consume
  int f_nt = nt_blk, f_kt = 0, f_j = 0, f_stage = 0;  // the tile to fetch
  WeightTileLoader<BN, BK> loader(bs);
  loader.set_n_tile(w, f_nt * BN, N, K);
  auto fetch = [&]() {
    if (f_j < total) {
      loader.fetch(f_stage, f_kt * BK, K);
      if (++f_kt == nk) {
        f_kt = 0;
        if (++f_nt == nn) f_nt = 0;
        loader.set_n_tile(w, f_nt * BN, N, K);
      }
    }
    ++f_j;
    if (++f_stage == STAGES) f_stage = 0;
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) fetch();
  int stage = 0;
  for (int j = 0; j < total; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed
    __syncthreads();              // ... for every thread, and tile j - 1 is consumed
    fetch();                      // tile j + STAGES - 1, into the buffer of tile j - 1
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
    }
    warp_mma<MT, NT, BK>(acc, as + wm * MT * 16 * a_stride + kt * BK, a_stride,
                         bs + stage * BN * kBStride + wn * NT * 8 * kBStride, g, t);
    if (++stage == STAGES) stage = 0;
    if (kt == nk - 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int row = wm * MT * 16 + mt * 16 + g;
          const int col = nt_blk * BN + wn * NT * 8 + nt * 8 + 2 * t;
          if (col < N) {
            epi(row, col, acc[mt][nt][0], acc[mt][nt][1], 2 * mt);
            epi(row + 8, col, acc[mt][nt][2], acc[mt][nt][3], 2 * mt + 1);
          }
        }
      }
      kt = 0;
      if (++nt_blk == nn) nt_blk = 0;
    } else {
      ++kt;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring may be refilled, and what `epi` wrote to shared memory read
}

}  // namespace videoitg
