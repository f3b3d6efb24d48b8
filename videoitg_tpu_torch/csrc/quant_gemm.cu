// act8 GEMM: dynamic per-row int8 quantisation of x, then an int8 GEMM
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` in videoitg_tpu/ops/quant_gemm.py (entry
// `act8_gemm`): out[m][n] = (sum_k q(x[m][k]) * w[n][k]) * xs[m] * ws[n] with
// q(v) = clip(round(v / xs[m]), +-127), xs[m] = max_k |x[m][k]| / 127 (1 for
// a zero row) unless the caller gives it, an exact int32 sum, the product
// `(acc * xs) * ws` in fp32 and one rounding to bf16.
//
// What bounds it on an H100, at the LM's shapes (M = 13,056 tokens; (K, N) =
// (3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)): 2 M K N is 0.34
// to 1.77 TOP against 0.1 to 0.9 GB of x, w and out, 1,900 to 3,300 int8
// operations per byte, far above the card's ~590 ridge (1,979 TOP/s over
// 3.35 TB/s). The tensor cores bound it, not device memory.
//
// Design. Two launches. `row_quant_kernel` reads x once (a block per row: a
// pass for the row's amax, a pass that quantises it from L1 / L2) and writes
// the int8 copy and the row scale: 47 MB at K = 3584, 247 MB at K = 18,944.
// Then the TMA + s8 wgmma GEMM of hopper_int8_gemm.cuh with the `Act8Out`
// epilogue, 128 x 256 output tiles. The first versions quantised x on its way
// into shared memory, inside the GEMM, so that every one of the N / 256
// blocks of a row tile quantised the same x tile again, on mma.sync fed by
// cp.async with one block of 8 warps per SM (~212 TOP/s, 28.64 ms for the 7
// products of one LM layer, NVIDIA H100 80GB HBM3 at 700 W); quantising once
// costs a pass over x and its int8 copy (0.66 of the layer's 5.3 ms now, the
// GEMM 1,190 to 1,570 TOP/s at the large shapes).
#include "hopper_int8_gemm.cuh"
#include "int8_common.cuh"

namespace videoitg {

constexpr int kRowQuantThreads = 256;

// One block per row of x [M][K] (bf16): xs[row] = row_scale_of(amax) when
// `compute_scale`, else read; xq[row] = round(x / xs) clipped to +-127, bit
// for bit (`quant8_chunk`). K % 8 == 0.
__global__ void __launch_bounds__(kRowQuantThreads)
row_quant_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ xs,
                 int8_t* __restrict__ xq, int K, int compute_scale) {
  __shared__ float warp_amax[kRowQuantThreads / 32];
  const int row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * K);
  const int chunks = K / 8;
  float s;
  if (compute_scale) {
    float amax = 0.f;
    for (int c = threadIdx.x; c < chunks; c += kRowQuantThreads) {
      float v[8];
      unpack_bf16x8(xr[c], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = warp_max(amax);
    if (threadIdx.x % 32 == 0) warp_amax[threadIdx.x / 32] = amax;
    __syncthreads();
    amax = warp_amax[0];
#pragma unroll
    for (int w = 1; w < kRowQuantThreads / 32; ++w) amax = fmaxf(amax, warp_amax[w]);
    s = row_scale_of(amax);
    if (threadIdx.x == 0) xs[row] = s;
  } else {
    s = xs[row];
  }
  const float inv_s = __fdiv_rn(1.f, s);
  uint2* qr = reinterpret_cast<uint2*>(xq + static_cast<size_t>(row) * K);
  for (int c = threadIdx.x; c < chunks; c += kRowQuantThreads) {
    float v[8];
    unpack_bf16x8(xr[c], v);
    qr[c] = quant8_chunk(v, s, inv_s);
  }
}

// F's epilogue: out = bf16((acc * xs) * ws), each product rounded on its own.
struct Act8Out {
  const float* xs;  // [M]
  const float* ws;  // [N]
  __nv_bfloat16* out;  // [M][N]
  int M, N;
  static constexpr bool kStaged = true;

  __device__ __forceinline__ void chunk(int row, int col, const int (&v)[8]) const {
    if (row >= M || col >= N) return;
    const float s = xs[row];
    const float4 w0 = *reinterpret_cast<const float4*>(ws + col);
    const float4 w1 = *reinterpret_cast<const float4*>(ws + col + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 2 * e;
      packed[e] = pack_bf16x2(__fmul_rn(__fmul_rn(__int2float_rn(v[i]), s), w[i]),
                              __fmul_rn(__fmul_rn(__int2float_rn(v[i + 1]), s), w[i + 1]));
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * N + col) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

}  // namespace videoitg

// x: bf16 [M][K]; xs: fp32 [M] row scales, written when compute_scale != 0,
// else read; xq: int8 [M][K]. Contiguous, 16-byte aligned, K a multiple of
// 16. Launches on `stream`; returns cudaGetLastError().
extern "C" int videoitg_row_quant_int8_bf16(const void* x, void* xs, void* xq, int M, int K,
                                            int compute_scale, void* stream) {
  using namespace videoitg;
  if (M <= 0 || K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  row_quant_kernel<<<M, kRowQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(xs), static_cast<int8_t*>(xq),
      K, compute_scale);
  return static_cast<int>(cudaGetLastError());
}

// xq: int8 [M][K]; xs: fp32 [M]; w: int8 [N][K]; ws: fp32 [N]; out: bf16
// [M][N]; contiguous and 16-byte aligned on the current device, K a multiple
// of 16, N of 8. Launches on `stream`; returns cudaGetLastError().
extern "C" int videoitg_act8_gemm_s8(const void* xq, const void* xs, const void* w,
                                     const void* ws, void* out, int M, int K, int N,
                                     void* stream) {
  using namespace videoitg;
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Act8Out epi{static_cast<const float*>(xs), static_cast<const float*>(ws),
                    static_cast<__nv_bfloat16*>(out), M, N};
  return static_cast<int>(
      hgemm::launch(xq, w, epi, M, N, K, static_cast<cudaStream_t>(stream)));
}
