// Row quantisation and epilogue arithmetic shared by the int8 kernels of the
// act8 serving tier (quant_gemm.cu: F; fused_encoder.cu: G, H, I), all of
// whose products run on the TMA + s8 wgmma GEMM of hopper_int8_gemm.cuh: the
// exact int8 quantiser of 8 values (`quant8_chunk`), the row scale
// (`row_scale_of`), the epilogue's `acc * (row_scale * col_scale) + bias`
// (`scale_bias`), warp reductions, bf16 packing, the LayerNorm of whole rows
// held in registers (`load_row`, `row_stats`, `normalise8`; also the add +
// LayerNorm kernel's, layer_norm.cu) and the LN + quantisation of such rows
// (`quantize_rows`).
//
// Numerics are the JAX package's: scales are true divisions, values round
// half to even and clip to +-127, and every product and sum is rounded on its
// own in the order of the plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace videoitg {

constexpr int kI8Threads = 256;   // 8 warps: a block of `quantize_rows`, a warp a row

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

// A row of K bf16 values (`xrow`, 16-byte aligned, K = 8 * chunks) into the
// registers of a warp: lane `lane` holds chunks lane + 32 i, zeros past the
// row's end, all loads in flight together.
template <int NC>
__device__ __forceinline__ void load_row(uint4 (&raw)[NC], const __nv_bfloat16* __restrict__ xrow,
                                         int lane, int chunks) {
  const uint4* xr = reinterpret_cast<const uint4*>(xrow);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    raw[i] = c < chunks ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The LayerNorm statistics of a row a warp holds as `load_row` leaves it:
// (mean, rsqrt(var + eps)), fp32, the variance in a second pass over the
// centred values, each product and sum rounded on its own. Every lane gets
// both.
template <int NC>
__device__ __forceinline__ float2 row_stats(const uint4 (&raw)[NC], int lane, int chunks, int K,
                                            float eps) {
  float sum = 0.f;  // chunks past the end hold zeros
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float v[8];
    unpack_bf16x8(raw[i], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = __fadd_rn(sum, v[e]);
  }
  const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(K));
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (lane + 32 * i < chunks) {
      float v[8];
      unpack_bf16x8(raw[i], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __fsub_rn(v[e], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
  }
  return make_float2(mean, rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), static_cast<float>(K)), eps)));
}

// y = (v - mean) * rstd * scale + shift on eight values, each product and
// sum rounded on its own (no fused multiply-add), the order of `layer_norm`.
__device__ __forceinline__ void normalise8(float v[8], float2 stats, const float scale[8],
                                           const float shift[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float n = __fmul_rn(__fsub_rn(v[e], stats.x), stats.y);
    v[e] = __fadd_rn(__fmul_rn(n, scale[e]), shift[e]);
  }
}

// Rows [row0, row0 + nrows) of x [rows][K] (bf16) through a two-pass fp32
// LayerNorm (y = (x - mean) * rsqrt(var + eps) * lns + lnb), then quantised
// per row: int8 into yq ([nrows][K]) and the row scales into ys ([nrows]).
// One warp per row; a lane loads its chunks of the row once (`load_row`) and
// keeps them in registers for the statistics (`row_stats`), amax and
// quantise passes. K % 8 == 0 and K <= kMaxRowK.
__device__ __forceinline__ void quantize_rows(int8_t* yq, float* ys,
                                              const __nv_bfloat16* __restrict__ x,
                                              const float* __restrict__ lns,
                                              const float* __restrict__ lnb, float eps, int row0,
                                              int nrows, int K) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = K / 8;
  for (int r = warp; r < nrows; r += kI8Threads / 32) {
    int8_t* yrow = yq + static_cast<size_t>(r) * K;
    uint4 raw[kMaxRowChunks];
    load_row(raw, x + static_cast<size_t>(row0 + r) * K, lane, chunks);
    const float2 stats = row_stats(raw, lane, chunks, K, eps);
    // y of one chunk, the same expression in the amax pass and the quantise pass.
    auto chunk_y = [&](int i, float y[8]) {
      unpack_bf16x8(raw[i], y);
      const int c = lane + 32 * i;
      const float4 s0 = *reinterpret_cast<const float4*>(lns + c * 8);
      const float4 s1 = *reinterpret_cast<const float4*>(lns + c * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(lnb + c * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(lnb + c * 8 + 4);
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      normalise8(y, stats, sc, bi);
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
        *reinterpret_cast<uint2*>(yrow + (lane + 32 * i) * 8) = quant8_chunk(y, s, inv_s);
      }
    }
    if (lane == 0) ys[r] = s;
  }
}

}  // namespace videoitg
