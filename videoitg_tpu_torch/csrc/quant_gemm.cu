// act8 GEMM with the activation quantisation fused in (sm_90a).
//
// Replaces the TPU kernel `_kernel` in videoitg_tpu/ops/quant_gemm.py (entry
// `act8_gemm`): out[m][n] = (sum_k q(x[m][k]) * w[n][k]) * xs[m] * ws[n] with
// q(v) = clip(round(v / xs[m]), +-127), an exact int32 sum, the product
// `(acc * xs) * ws` in fp32 and one rounding to bf16. The row scales xs come
// from outside (one reduction over the full row), so quantising a k tile at a
// time equals quantising the whole row.
//
// What bounds it on an H100, at the LM's shapes (M = 13,056 tokens; (K, N) =
// (3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)): 2 M K N is 0.34
// to 1.77 TOP against 0.1 to 0.9 GB of x, w and out, 1,900 to 3,300 int8
// operations per byte, far above the card's ~590 ridge (1,979 TOP/s over
// 3.35 TB/s). The tensor cores bound it, not device memory.
//
// Design. A 128 x 256 output tile per block, 8 warps of 64 x 64, mma.sync
// m16n8k32 s8 with int32 accumulators. The weight is stored [N][K] (k
// contiguous), the operand layout of the s8 MMA, so weight tiles go global ->
// shared with cp.async (a three-stage ring, one barrier per k tile of 64) and
// no byte transpose; x tiles go through registers, where they are quantised
// and packed to int8 before they reach shared memory (double-buffered; the
// global loads of the next tile are in flight during the products). Every
// one of the N / 256 blocks of a row tile quantises the same x tile again,
// and that, not the MMA pipe, was the first version's limit (128 x 128
// tiles, a true division per element: ~110 TOP/s; this version ~212 TOP/s,
// NVIDIA H100 80GB HBM3 at 700 W). Hence the wide tile, and
// `quant8_chunk`: a multiply by 1 / xs that is checked against the rounding
// boundary and falls back to the true division where the two could differ,
// so the int8 values are those of `round(x / xs)` bit for bit. The
// last row tile is masked (rows >= M quantise to zeros and are never
// stored), so nothing is padded in device memory. Left on the table: no TMA,
// wgmma or persistent scheduling yet, one block (8 warps) per SM.
#include "int8_common.cuh"

namespace videoitg {

constexpr int kFBM = 128;
constexpr int kFBN = 256;
constexpr int kFStages = 3;
constexpr int kFSmem = 2 * kFBM * kI8BStride + kFStages * kFBN * kI8BStride;

// This thread's share of the x tile [kFBM][64] at k0: 4 chunks of 8 bf16,
// rows (tid / 8) + 32 i, columns (tid % 8) * 8.
__device__ __forceinline__ void load_x_chunks(uint4 regs[4], const __nv_bfloat16* __restrict__ x,
                                              int m0, int k0, int M, int K) {
  const int r = threadIdx.x / 8;
  const int c = (threadIdx.x % 8) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + r + 32 * i;
    regs[i] = make_uint4(0u, 0u, 0u, 0u);
    if (row < M && k0 + c < K) {
      regs[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * K + k0 + c);
    }
  }
}

__device__ __forceinline__ void store_x_chunks(int8_t* as, const uint4 regs[4],
                                               const float scale[4], const float inv[4]) {
  const int r = threadIdx.x / 8;
  const int c = (threadIdx.x % 8) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[8];
    unpack_bf16x8(regs[i], v);
    *reinterpret_cast<uint2*>(as + (r + 32 * i) * kI8BStride + c) = quant8_chunk(v, scale[i], inv[i]);
  }
}

__global__ void __launch_bounds__(kI8Threads)
act8_gemm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xs,
                 const int8_t* __restrict__ w, const float* __restrict__ ws,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* as = reinterpret_cast<int8_t*>(smem_raw);   // [2][kFBM][kI8BStride]
  int8_t* bs = as + 2 * kFBM * kI8BStride;            // [kFStages][kFBN][kI8BStride]
  constexpr int kATile = kFBM * kI8BStride;
  constexpr int kBTile = kFBN * kI8BStride;

  const int m0 = blockIdx.y * kFBM;
  const int n0 = blockIdx.x * kFBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / 4;  // 2 x 4 warps of 64 x 64
  const int wn = warp % 4;
  const int nk = (K + kI8BK - 1) / kI8BK;

  float scale[4], inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + threadIdx.x / 8 + 32 * i;
    scale[i] = row < M ? xs[row] : 1.f;
    inv[i] = __fdiv_rn(1.f, scale[i]);
  }

  int acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  WeightTileLoader<kFBN> loader(bs);
  loader.set_n_tile(w, n0, N, K);
  auto fetch_w = [&](int kt) {
    if (kt < nk) loader.fetch(kt % kFStages, kt * kI8BK, K);
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  uint4 regs[4];
#pragma unroll
  for (int kt = 0; kt < kFStages - 1; ++kt) fetch_w(kt);
  load_x_chunks(regs, x, m0, 0, M, K);
  store_x_chunks(as, regs, scale, inv);

  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    cp_async_wait<kFStages - 2>();  // weight tile kt has landed
    __syncthreads();  // ... for every thread; x tile kt is stored; tile kt - 1 is consumed
    fetch_w(kt + kFStages - 1);
    if (more) load_x_chunks(regs, x, m0, (kt + 1) * kI8BK, M, K);
    warp_mma<4, 8>(acc, as + (kt & 1) * kATile + wm * 64 * kI8BStride, kI8BStride,
                       bs + (kt % kFStages) * kBTile + wn * 64 * kI8BStride, g, t);
    if (more) store_x_chunks(as + ((kt + 1) & 1) * kATile, regs, scale, inv);
  }
  cp_async_wait<0>();

  // (acc * xs) * ws -> bf16; rows >= M and columns >= N are not stored.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r0 = m0 + wm * 64 + mt * 16 + g;
    const int r1 = r0 + 8;
    const float s0 = r0 < M ? xs[r0] : 1.f;
    const float s1 = r1 < M ? xs[r1] : 1.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + wn * 64 + nt * 8 + 2 * t;
      if (col >= N) continue;
      const float w0 = ws[col], w1 = ws[col + 1];
      if (r0 < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0) * N + col) = pack_bf16x2(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][0]), s0), w0),
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][1]), s0), w1));
      }
      if (r1 < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r1) * N + col) = pack_bf16x2(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2]), s1), w0),
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][3]), s1), w1));
      }
    }
  }
}

}  // namespace videoitg

// x: bf16 [M][K]; xs: fp32 [M] row scales; w: int8 [N][K]; ws: fp32 [N];
// out: bf16 [M][N]; all contiguous and 16-byte aligned on the current device,
// K a multiple of 16, N of 8. Launches on `stream`; returns cudaGetLastError().
extern "C" int videoitg_act8_gemm_bf16(const void* x, const void* xs, const void* w,
                                       const void* ws, void* out, int M, int K, int N,
                                       void* stream) {
  using namespace videoitg;
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(act8_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
  act8_gemm_kernel<<<grid, kI8Threads, kFSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
