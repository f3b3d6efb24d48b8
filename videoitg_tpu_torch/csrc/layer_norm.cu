// Residual add + LayerNorm of a vision tower's bf16 stream in one pass (sm_90a).
//
// Replaces no TPU kernel: the JAX package's LayerNorm and residual adds
// (videoitg_tpu/models/common.py `layer_norm`, models/siglip.py
// `_encoder_layer`) are plain jnp, which XLA fuses on the TPU. Run as PyTorch
// ops they are ~10 full passes over the rows in fp32 a norm (cast, mean,
// centre, square, mean, scale, shift, cast) and two more for the bias add and
// the residual add of the product before it; this kernel is all of it in one
// read of its inputs and one write of its outputs.
//
// For each row of x [rows][H] (bf16), with delta [rows][H] a product's output
// whose bias b [H] was held back (both optional):
//   r = bf16(x + bf16(delta + b))   the new residual stream, rounded where
//                                   PyTorch's two bf16 adds round: bit-equal
//   y = bf16((r - mean) * rsqrt(var + eps) * s + t)
//                                   fp32 mean and two-pass variance over the
//                                   row, each product and sum rounded on its
//                                   own in the order of `layer_norm`
// Without delta, r is x and only y is written.
//
// What bounds it: bytes. At SigLIP's chunk of 128 frames (93,312 rows, H =
// 1152) it reads x and delta and writes r and y: 860 MB, 0.257 ms at 3.35
// TB/s (430 MB, 0.128 ms without delta). The arithmetic, ~10 operations an
// element, is far below the card's rate.
//
// Design: one warp a row, as `quantize_rows`, on the same row helpers
// (int8_common.cuh: `load_row`, `row_stats`, `normalise8`). A lane loads its
// NC 16-byte chunks of x (and of delta) at once, all loads in flight
// together, forms r in registers and stores it, and keeps r there for the
// statistics and the normalise pass, so each input byte is read once and
// each output byte written once. NC = ceil(H / 256) is a template constant
// (at most 8, so H <= 2048), so the chunks live in registers; the ragged last
// chunk of a row (1152 = 4.5 x 256) is masked. The small vectors (b, s, t)
// are read per chunk through L1.
#include "int8_common.cuh"

namespace videoitg {

constexpr int kAddLnThreads = 256;  // 8 warps, a row each

__device__ __forceinline__ uint4 pack_bf16x8(const float v[8]) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                    pack_bf16x2(v[6], v[7]));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int NC>
__global__ void __launch_bounds__(kAddLnThreads)
add_layer_norm_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ delta,
                      const __nv_bfloat16* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ lns,
                      const __nv_bfloat16* __restrict__ lnb, __nv_bfloat16* __restrict__ r_out,
                      __nv_bfloat16* __restrict__ y_out, int rows, int H, float eps) {
  const int row = blockIdx.x * (kAddLnThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int chunks = H / 8;
  const size_t off = static_cast<size_t>(row) * H;
  uint4 raw[NC];
  load_row(raw, x + off, lane, chunks);
  if (delta != nullptr) {
    uint4 draw[NC];
    load_row(draw, delta + off, lane, chunks);
    uint4* rr = reinterpret_cast<uint4*>(r_out + off);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float xv[8], dv[8];
        unpack_bf16x8(raw[i], xv);
        unpack_bf16x8(draw[i], dv);
        if (bias != nullptr) {
          float bv[8];
          unpack_bf16x8(reinterpret_cast<const uint4*>(bias)[c], bv);
#pragma unroll
          for (int e = 0; e < 8; ++e) dv[e] = round_bf16(__fadd_rn(dv[e], bv[e]));
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = __fadd_rn(xv[e], dv[e]);
        raw[i] = pack_bf16x8(xv);
        rr[c] = raw[i];
      }
    }
  }
  const float2 stats = row_stats(raw, lane, chunks, H, eps);
  uint4* yr = reinterpret_cast<uint4*>(y_out + off);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      float v[8], sc[8], sh[8];
      unpack_bf16x8(raw[i], v);
      unpack_bf16x8(reinterpret_cast<const uint4*>(lns)[c], sc);
      unpack_bf16x8(reinterpret_cast<const uint4*>(lnb)[c], sh);
      normalise8(v, stats, sc, sh);
      yr[c] = pack_bf16x8(v);
    }
  }
}

template <int NC>
cudaError_t launch_add_layer_norm(const void* x, const void* delta, const void* bias,
                                  const void* lns, const void* lnb, void* r, void* y, int rows,
                                  int H, float eps, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kAddLnThreads / 32;
  add_layer_norm_kernel<NC><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kAddLnThreads, 0,
                              stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(delta),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(lns),
      static_cast<const __nv_bfloat16*>(lnb), static_cast<__nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(y), rows, H, eps);
  return cudaGetLastError();
}

}  // namespace videoitg

// x, delta (nullable), r (written when delta is given): contiguous bf16
// [rows][H]; bias (nullable, only with delta), lns, lnb: bf16 [H]; y: bf16
// [rows][H]. Every pointer 16-byte aligned, H a multiple of 8 and at most
// 2048. Launches on `stream`; returns cudaGetLastError().
extern "C" int videoitg_add_layer_norm_bf16(const void* x, const void* delta, const void* bias,
                                            const void* lns, const void* lnb, void* r, void* y,
                                            int rows, int H, float eps, void* stream) {
  using namespace videoitg;
  if (rows <= 0 || H <= 0 || H % 8 || H > kMaxRowK || (delta != nullptr && r == nullptr) ||
      (delta == nullptr && bias != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const void*, const void*,
                                 void*, void*, int, int, float, cudaStream_t);
  constexpr Launch launches[] = {launch_add_layer_norm<1>, launch_add_layer_norm<2>,
                                 launch_add_layer_norm<3>, launch_add_layer_norm<4>,
                                 launch_add_layer_norm<5>, launch_add_layer_norm<6>,
                                 launch_add_layer_norm<7>, launch_add_layer_norm<8>};
  const int nc = (H / 8 + 31) / 32;  // 16-byte chunks a lane holds
  return static_cast<int>(launches[nc - 1](x, delta, bias, lns, lnb, r, y, rows, H, eps,
                                           static_cast<cudaStream_t>(stream)));
}
