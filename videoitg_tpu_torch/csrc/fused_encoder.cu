// Fused int8 kernels of a vision encoder layer under the act8 tier (sm_90a).
//
// Replace the TPU kernels of videoitg_tpu/ops/fused_encoder.py:
//   G `_ln_qkv_kernel`   (entry `fused_ln_qkv_int8`):        LN -> row quant ->
//     packed [dq+dk+dv][H] product -> acc * (ys * s) + b -> q, k, v
//   H `_ln_mlp_kernel`   (entry `fused_ln_mlp_int8`):        LN -> row quant ->
//     fc1 -> + b -> GELU -> quant of the whole intermediate row -> fc2 -> + b
//     -> + x
//   I `_proj_res_kernel` (entry `fused_proj_residual_int8`): row quant ->
//     o_proj -> acc * (as * s) + b -> + residual
// LN is two-pass in fp32, activations are quantised from fp32 with a true
// division and round-half-to-even, sums are exact int32, the epilogues run
// in fp32 and round once to bf16. All work is row-local.
//
// What bounds them on an H100, at the tower's shape (93,312 rows = 128 frames
// x 729 patches, H = 1152, M = 4304): G does 0.74 TOP against 0.86 GB of x,
// q, k, v (~860 operations per byte), I 0.25 TOP against 0.65 GB (~380), H
// 1.85 TOP (2.78 as run here, see below) against 0.44 GB. The card's int8
// ridge is ~590 operations per byte: G and H are bound by the tensor cores,
// I by device memory.
//
// Design. Every product runs on the TMA + s8 wgmma GEMM of
// hopper_int8_gemm.cuh (128 x 256 tiles) with an epilogue policy, after a
// launch that quantises the rows once and writes their int8 copy and fp32
// scales (the GEMM's blocks of one row tile would otherwise each quantise
// it again):
//   G: 1. `ln_quant_kernel`: LN + row quantisation of x into yq [rows][H], ys.
//      2. the packed QKV product with `QkvOut`, which writes each chunk of 8
//         columns to q, k or v. dq and dk are multiples of 8, so a chunk lies
//         in one output; a 256-column tile does not (1152 / 256 = 4.5: tiles
//         cross q|k and k|v). TMA's zero fill covers the last tile's half
//         past 3456, which the policy skips.
//   H: 1. `ln_quant_kernel`, as G's.
//      2. fc1 with `RowAmax`: act(acc * (ys * s1) + b1), each row's max |.|
//         into amax [rows] by one atomicMax per row and block.
//      3. fc1 again with `QuantStore`: the same values, quantised with the
//         full row's scale, stored as int8 gq [rows][4304] (402 MB at the
//         tower's shape, written and read once).
//      4. fc2 with `BiasResidual<ScaleOfAmax>`: x + acc * (gs * s2) + b2.
//   I: 1. F's `row_quant_kernel` (quant_gemm.cu): aq [rows][D], as.
//      2. o_proj with `BiasResidual<ScaleGiven>`: res + acc * (as * s) + b.
// H's second quantisation needs the amax of the whole 4304-wide row before
// any of it is quantised, and a block cannot hold 128 rows of its
// intermediate (550 KB in int8): hence fc1 twice (1.5x the MLP's tensor-core
// work), and its activation, computed in two epilogues while the tensor
// cores wait, is most of H's gap to its bound. TMA's zero fill covers the 48
// columns past 4304 of fc1's last tile (skipped by both fc1 policies) and
// the half k32 step past 4304 of fc2.
//
// History (NVIDIA H100 80GB HBM3 at 700 W, the tower's shape): G and I ran
// on mma.sync fed by a cp.async ring, 8 warps a block with rows quantised
// into shared memory, at 124 to 311 TOP/s (G 2.47, I 0.96 ms; the bare
// mma.sync loop reaches ~1,080 TOP/s); H held 32 rows of its intermediate
// in shared memory on mma.sync (14.9 ms) before its four launches (4.8 ms).
// PERF.md, section 6, has the steps and their times.
#include "hopper_int8_gemm.cuh"
#include "int8_common.cuh"

namespace videoitg {

constexpr int kLnRows = 64;  // rows per block of `ln_quant_kernel` (8 per warp)

// G and H, launch 1: LN + row quantisation of x into yq [rows][H] and ys [rows].
__global__ void __launch_bounds__(kI8Threads)
ln_quant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lns,
                const float* __restrict__ lnb, int8_t* __restrict__ yq, float* __restrict__ ys,
                int rows, int H, float eps) {
  const int row0 = blockIdx.x * kLnRows;
  quantize_rows(yq + static_cast<size_t>(row0) * H, ys + row0, x, lns, lnb, eps, row0,
                min(kLnRows, rows - row0), H);
}

// Eight consecutive fp32 values from p (16-byte aligned).
__device__ __forceinline__ void load_f32x8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// ---- G ----
// Launch 2: the packed product's 8 columns col..col + 7 of row `row`,
// acc * (ys * s) + b rounded once to bf16, stored as 16 bytes into q, k or v.
struct QkvOut {
  const float* ys;  // [M]
  const float* s;   // [dq + dk + dv]
  const float* b;   // [dq + dk + dv]
  __nv_bfloat16* q;
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  int M, dq, dk, dv;
  static constexpr bool kStaged = true;

  __device__ __forceinline__ void chunk(int row, int col, const int (&acc)[8]) const {
    if (row >= M || col >= dq + dk + dv) return;
    __nv_bfloat16* dst = q;
    int c = col, ld = dq;
    if (col >= dq + dk) {
      dst = v; c = col - dq - dk; ld = dv;
    } else if (col >= dq) {
      dst = k; c = col - dq; ld = dk;
    }
    const float scale = ys[row];
    float sc[8], bi[8];
    load_f32x8(s + col, sc);
    load_f32x8(b + col, bi);
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 2 * e;
      packed[e] = pack_bf16x2(scale_bias(acc[i], scale, sc[i], bi[i]),
                              scale_bias(acc[i + 1], scale, sc[i + 1], bi[i + 1]));
    }
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * ld + c) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

// ---- H ----
// Every product and sum rounded on its own, so that fc1's two passes
// (`RowAmax`, `QuantStore`) compute the same bits whatever the compiler does
// around them.
__device__ __forceinline__ float activation(float h, int act) {
  if (act == 0) {  // gelu, tanh form: 0.5 h (1 + tanh(sqrt(2/pi) (h + 0.044715 h^3)))
    const float cube = __fmul_rn(__fmul_rn(h, h), h);
    const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, __fmul_rn(0.044715f, cube)));
    return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, tanhf(inner)));
  }
  // quick_gelu: h * sigmoid(1.702 h)
  return __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h)))));
}

// fc1's value of (row, col): act(acc * (ys * s1) + b1).
template <int ACT>
__device__ __forceinline__ float fc1_value(int acc, float ys, float s, float b) {
  return activation(scale_bias(acc, ys, s, b), ACT);
}

// The intermediate row scale of a row whose max |act(fc1)| has these bits.
__device__ __forceinline__ float mlp_scale(const unsigned int* amax_bits, int row) {
  return row_scale_of(__uint_as_float(amax_bits[row]));
}

// fc1's 8 values of (row, col..col + 7): act(acc * (ys * s1) + b1).
template <int ACT>
__device__ __forceinline__ void fc1_values(float (&g)[8], const int (&v)[8], float ys,
                                           const float* s1, const float* b1, int col) {
  const float4 s0 = *reinterpret_cast<const float4*>(s1 + col);
  const float4 s4 = *reinterpret_cast<const float4*>(s1 + col + 4);
  const float4 c0 = *reinterpret_cast<const float4*>(b1 + col);
  const float4 c4 = *reinterpret_cast<const float4*>(b1 + col + 4);
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s4.x, s4.y, s4.z, s4.w};
  const float b[8] = {c0.x, c0.y, c0.z, c0.w, c4.x, c4.y, c4.z, c4.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) g[e] = fc1_value<ACT>(v[e], ys, s[e], b[e]);
}

// H, launch 2 (fc1, first pass): each row's max |act(fc1)| over the tile's
// columns below N, taken in registers where wgmma left the sums, reduced
// over the quad that holds the row, then one atomicMax on the float's bits
// per row and block into amax_bits [rows] (zeroed by the caller).
// Non-negative floats order like their bits and max does not depend on
// order: the result is deterministic. The columns past N of the last tile
// (act of the bias of no channel) are skipped. (Staged through shared memory
// it took 1.63 against 1.35 ms at the tower's shape, int8_gemm_probe.py on
// an NVIDIA H100 80GB HBM3 at 700 W: a row reduction stores nothing to
// coalesce.)
template <int ACT>
struct RowAmax {
  const float* ys;
  const float* s1;
  const float* b1;
  unsigned int* amax_bits;
  int M, N;
  static constexpr bool kStaged = false;

  __device__ __forceinline__ void apply(const int (&acc)[hgemm::kBN / 2], int row0, int n0,
                                        int t) const {
    const int row1 = row0 + 8;
    const float ys0 = row0 < M ? ys[row0] : 1.f;
    const float ys1 = row1 < M ? ys[row1] : 1.f;
    float m0 = 0.f, m1 = 0.f;
#pragma unroll
    for (int j = 0; j < hgemm::kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) continue;  // N % 8 == 0: col + 1 < N too
      const float2 s = *reinterpret_cast<const float2*>(s1 + col);
      const float2 b = *reinterpret_cast<const float2*>(b1 + col);
      m0 = fmaxf(m0, fmaxf(fabsf(fc1_value<ACT>(acc[4 * j], ys0, s.x, b.x)),
                           fabsf(fc1_value<ACT>(acc[4 * j + 1], ys0, s.y, b.y))));
      m1 = fmaxf(m1, fmaxf(fabsf(fc1_value<ACT>(acc[4 * j + 2], ys1, s.x, b.x)),
                           fabsf(fc1_value<ACT>(acc[4 * j + 3], ys1, s.y, b.y))));
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    if (t == 0) {
      if (row0 < M) atomicMax(&amax_bits[row0], __float_as_uint(m0));
      if (row1 < M) atomicMax(&amax_bits[row1], __float_as_uint(m1));
    }
  }
};

// H, launch 3 (fc1, second pass): the same values again, quantised with the
// full row's scale and stored as int8 gq [rows][N].
template <int ACT>
struct QuantStore {
  const float* ys;
  const float* s1;
  const float* b1;
  const unsigned int* amax_bits;
  int8_t* gq;
  int M, N;
  static constexpr bool kStaged = true;

  __device__ __forceinline__ void chunk(int row, int col, const int (&v)[8]) const {
    if (row >= M || col >= N) return;
    float g[8];
    fc1_values<ACT>(g, v, ys[row], s1, b1, col);
    const float scale = mlp_scale(amax_bits, row);
    *reinterpret_cast<uint2*>(gq + static_cast<size_t>(row) * N + col) =
        quant8_chunk(g, scale, __fdiv_rn(1.f, scale));
  }
};

// H, launch 4 (fc2), and I, launch 2: out = bf16(x + (acc * (scale * s2) +
// b2)), the row's scale from `RowScale`: H's from the bits of the row's
// amax of launch 2 (`ScaleOfAmax`), I's as its row quantisation wrote it
// (`ScaleGiven`).
struct ScaleOfAmax {
  const unsigned int* amax_bits;
  __device__ __forceinline__ float operator()(int row) const { return mlp_scale(amax_bits, row); }
};

struct ScaleGiven {
  const float* scales;
  __device__ __forceinline__ float operator()(int row) const { return scales[row]; }
};

template <class RowScale>
struct BiasResidual {
  RowScale row_scale;
  const float* s2;
  const float* b2;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  int M, N;
  static constexpr bool kStaged = true;

  __device__ __forceinline__ void chunk(int row, int col, const int (&v)[8]) const {
    if (row >= M || col >= N) return;
    const float scale = row_scale(row);
    const size_t at = static_cast<size_t>(row) * N + col;
    float xf[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(x + at), xf);
    const float4 s0 = *reinterpret_cast<const float4*>(s2 + col);
    const float4 s4 = *reinterpret_cast<const float4*>(s2 + col + 4);
    const float4 c0 = *reinterpret_cast<const float4*>(b2 + col);
    const float4 c4 = *reinterpret_cast<const float4*>(b2 + col + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s4.x, s4.y, s4.z, s4.w};
    const float b[8] = {c0.x, c0.y, c0.z, c0.w, c4.x, c4.y, c4.z, c4.w};
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 2 * e;
      packed[e] =
          pack_bf16x2(__fadd_rn(xf[i], scale_bias(v[i], scale, s[i], b[i])),
                      __fadd_rn(xf[i + 1], scale_bias(v[i + 1], scale, s[i + 1], b[i + 1])));
    }
    *reinterpret_cast<uint4*>(out + at) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

}  // namespace videoitg

// LN + row quantisation, launch 1 of G and of H. x: bf16 [rows][H]; lns,
// lnb: fp32 [H]; yq: int8 [rows][H]; ys: fp32 [rows]. Contiguous, 16-byte
// aligned, H a multiple of 16 and at most 2048 (a warp holds a row in
// registers). Launches on `stream`; returns cudaGetLastError().
extern "C" int videoitg_ln_row_quant_int8_bf16(const void* x, const void* lns, const void* lnb,
                                               void* yq, void* ys, int rows, int H, float eps,
                                               void* stream) {
  using namespace videoitg;
  if (rows <= 0 || H <= 0 || H % 16 || H > kMaxRowK) return static_cast<int>(cudaErrorInvalidValue);
  ln_quant_kernel<<<(rows + kLnRows - 1) / kLnRows, kI8Threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<int8_t*>(yq), static_cast<float*>(ys), rows,
      H, eps);
  return static_cast<int>(cudaGetLastError());
}

// G, launch 2. yq: int8 [rows][H]; ys: fp32 [rows]; w: int8 [dq+dk+dv][H];
// s, b: fp32 [dq+dk+dv]; q, k, v: bf16 [rows][dq], [rows][dk], [rows][dv].
// Contiguous, 16-byte aligned, H a multiple of 16, dq, dk, dv of 8.
extern "C" int videoitg_qkv_gemm_s8(const void* yq, const void* ys, const void* w, const void* s,
                                    const void* b, void* q, void* k, void* v, int rows, int H,
                                    int dq, int dk, int dv, void* stream) {
  using namespace videoitg;
  if (dq <= 0 || dk <= 0 || dv <= 0 || dq % 8 || dk % 8 || dv % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QkvOut epi{static_cast<const float*>(ys), static_cast<const float*>(s),
                   static_cast<const float*>(b), static_cast<__nv_bfloat16*>(q),
                   static_cast<__nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(v),
                   rows, dq, dk, dv};
  return static_cast<int>(
      hgemm::launch(yq, w, epi, rows, dq + dk + dv, H, static_cast<cudaStream_t>(stream)));
}

// H's launches 2 to 4, each on `stream`, each returning cudaGetLastError()
// (launch 1 is `videoitg_ln_row_quant_int8_bf16`). yq int8 [rows][H], ys
// fp32 [rows]; w1: int8 [M][H]; s1, b1: fp32 [M]; w2: int8 [H][M]; s2, b2:
// fp32 [H]; act 0 = gelu (tanh form), 1 = quick_gelu. Scratch (the
// caller's): amax (fp32 bits) [rows], zeroed before launch 2; gq int8
// [rows][M]. All contiguous and 16-byte aligned, H and M multiples of 16.
extern "C" int videoitg_mlp_fc1_amax_s8(const void* yq, const void* ys, const void* w1,
                                        const void* s1, const void* b1, void* amax, int rows,
                                        int H, int M, int act, void* stream) {
  using namespace videoitg;
  if (M % 16 || act < 0 || act > 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ysf = static_cast<const float*>(ys);
  const auto* s = static_cast<const float*>(s1);
  const auto* b = static_cast<const float*>(b1);
  auto* bits = static_cast<unsigned int*>(amax);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      act == 0 ? hgemm::launch(yq, w1, RowAmax<0>{ysf, s, b, bits, rows, M}, rows, M, H, st)
               : hgemm::launch(yq, w1, RowAmax<1>{ysf, s, b, bits, rows, M}, rows, M, H, st);
  return static_cast<int>(err);
}

extern "C" int videoitg_mlp_fc1_quant_s8(const void* yq, const void* ys, const void* w1,
                                         const void* s1, const void* b1, const void* amax,
                                         void* gq, int rows, int H, int M, int act,
                                         void* stream) {
  using namespace videoitg;
  if (M % 16 || act < 0 || act > 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ysf = static_cast<const float*>(ys);
  const auto* s = static_cast<const float*>(s1);
  const auto* b = static_cast<const float*>(b1);
  const auto* bits = static_cast<const unsigned int*>(amax);
  auto* q = static_cast<int8_t*>(gq);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      act == 0 ? hgemm::launch(yq, w1, QuantStore<0>{ysf, s, b, bits, q, rows, M}, rows, M, H, st)
               : hgemm::launch(yq, w1, QuantStore<1>{ysf, s, b, bits, q, rows, M}, rows, M, H, st);
  return static_cast<int>(err);
}

extern "C" int videoitg_mlp_fc2_residual_s8(const void* gq, const void* amax, const void* w2,
                                            const void* s2, const void* b2, const void* x,
                                            void* out, int rows, int M, int H, void* stream) {
  using namespace videoitg;
  if (H % 16 || M % 16) return static_cast<int>(cudaErrorInvalidValue);
  const BiasResidual<ScaleOfAmax> epi{{static_cast<const unsigned int*>(amax)},
                                      static_cast<const float*>(s2),
                                      static_cast<const float*>(b2),
                                      static_cast<const __nv_bfloat16*>(x),
                                      static_cast<__nv_bfloat16*>(out), rows, H};
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(hgemm::launch(gq, w2, epi, rows, H, M, st));
}

// I, launch 2 (launch 1 is F's row quantisation,
// `videoitg_row_quant_int8_bf16`, with the scale made). aq: int8 [rows][D];
// a_scale: fp32 [rows]; w: int8 [H][D]; s, b: fp32 [H]; res, out: bf16
// [rows][H]. Contiguous, 16-byte aligned, D a multiple of 16, H of 8.
extern "C" int videoitg_proj_residual_s8(const void* aq, const void* a_scale, const void* w,
                                         const void* s, const void* b, const void* res, void* out,
                                         int rows, int D, int H, void* stream) {
  using namespace videoitg;
  if (H % 8) return static_cast<int>(cudaErrorInvalidValue);
  const BiasResidual<ScaleGiven> epi{{static_cast<const float*>(a_scale)},
                                     static_cast<const float*>(s), static_cast<const float*>(b),
                                     static_cast<const __nv_bfloat16*>(res),
                                     static_cast<__nv_bfloat16*>(out), rows, H};
  return static_cast<int>(
      hgemm::launch(aq, w, epi, rows, H, D, static_cast<cudaStream_t>(stream)));
}
