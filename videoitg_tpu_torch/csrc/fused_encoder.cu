// Fused int8 kernels of a vision encoder layer under the act8 tier (sm_90a).
//
// Replace the TPU kernels of videoitg_tpu/ops/fused_encoder.py:
//   G `_ln_qkv_kernel`   (entry `fused_ln_qkv_int8`):        LN -> row quant ->
//     packed [H][dq+dk+dv] product -> acc * (ys * s) + b -> q, k, v
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
// I by device memory. The unfused path writes and re-reads the LN output,
// the int8 copies and the [rows][4304] intermediate (0.8 GB in bf16 alone);
// G and I read x and write the outputs, nothing else; H writes and reads
// int8 copies of its two activations besides (0.5 GB).
//
// Design of G and I. A block takes a tile of rows, quantises them once into
// an int8 tile in shared memory (one warp per row, the row held in registers for the
// mean, variance, amax and quantise passes), and streams the whole [N][K]
// weight past it in [128][128] tiles through a two-stage cp.async ring with
// one barrier per tile, i.e. per 4 MMA k steps (int8_common.cuh,
// `stream_gemm`); weights are stored [N][K], the operand layout of mma.sync
// m16n8k32 s8, and stay in L2 across blocks, which start at different n
// tiles so that they do not all ask for the same lines at once. G and I hold
// 64 rows (75 KB) and use 32 x 32 warp tiles, two blocks to an SM, so that
// one block's row quantisation overlaps the other's products.
//
// How G and I got here (NVIDIA H100 80GB HBM3, 700 W, the tower's shape). The
// first version (128-row tiles, [128][64] weight tiles in a two-stage ring
// with two barriers a tile, every address worked out per tile, rows re-read
// from L1/L2 in four passes, a division per quantised value) took G 3.43,
// I 1.61, H 21.80 ms. With 8 warps a block (2 per scheduler) every dependent
// chain is paid in full: an ablation of G on the card
// (scripts/torch_probes/ln_qkv_ablation.cu; 3.86 ms: ~0.95 ms row
// quantisation, ~1.1 ms the address arithmetic of the weight loads, not the
// loads themselves, ~1.4 ms the product loop, ~0.25 ms barriers) led to rows
// held in registers (one global pass, all loads in flight), a reciprocal
// quantiser that is exact (`quant8_chunk`), tile positions kept by counters,
// and per-thread source pointers set once per n tile (`WeightTileLoader`):
// G 2.58, I 1.29 ms. 64-row tiles and two blocks per SM: I 1.02 ms,
// G unchanged. 128-byte k tiles (half the barriers): G 2.39, I 0.98 ms. Ring
// depth never mattered (two stages as good as four). The bare
// product loop reaches ~1,080 TOP/s on this card
// (scripts/torch_probes/mma_s8_rate.cu: mma.sync s8 from shared-memory
// fragments, no loads or barriers) and these kernels 124 to 311, so what is
// left is feeding it: more warps per SM, TMA and wgmma.
//
// Design of H. The second quantisation needs the amax of the whole 4304-wide
// row before any of it is quantised, and a block of 128 rows cannot hold its
// intermediate (550 KB in int8). H is four launches, three of them the TMA +
// s8 wgmma GEMM of hopper_int8_gemm.cuh (128 x 256 tiles) with an epilogue
// policy each:
//   1. `ln_quant_kernel`: LN + row quantisation of x into yq [rows][1152], ys.
//   2. fc1 with `RowAmax`: act(acc * (ys * s1) + b1), each row's max |.|
//      into amax [rows] by one atomicMax per row and block.
//   3. fc1 again with `QuantStore`: the same values, quantised with the full
//      row's scale, stored as int8 gq [rows][4304] (402 MB at the tower's
//      shape, written and read once: ~0.24 ms of traffic).
//   4. fc2 with `BiasResidual`: x + acc * (gs * s2) + b2.
// Nothing of the intermediate is rounded to bf16 before it is quantised, and
// fc1 is computed twice (1.5x the MLP's tensor-core work). The first
// versions held the int8 intermediate of 32 rows in shared memory and
// computed all three passes there on mma.sync (14.9 ms at the tower's shape:
// each block pulled 15 MB of weights from L2 for 32 rows of output); this one
// takes 4.9 ms (NVIDIA H100 80GB HBM3 at 700 W), of which the activation,
// computed in fc1's two epilogues while the tensor cores wait, is most of
// the gap to the 0.94 ms bound. TMA's zero fill covers the 48 columns past
// 4304 of fc1's last tile (their act(b) is skipped by both fc1 policies) and
// the half k32 step past 4304 of fc2.
#include "hopper_int8_gemm.cuh"
#include "int8_common.cuh"

namespace videoitg {

constexpr int kGBM = 64;   // rows per block, G and I (2 x 4 warps of 32 x 32)
constexpr int kGBN = 128;
constexpr int kBK = 128;     // bytes of k per weight tile: one barrier per 4 MMA k steps
constexpr int kStages = 2;   // weight tiles in the cp.async ring
constexpr int kBStride = kBK + kI8Pad;
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int pad_k(int k) { return (k + kBK - 1) / kBK * kBK; }

// ---- G ----
__global__ void __launch_bounds__(kI8Threads, 2)
ln_qkv_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lns,
              const float* __restrict__ lnb, const int8_t* __restrict__ w,
              const float* __restrict__ s, const float* __restrict__ b,
              __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ k,
              __nv_bfloat16* __restrict__ v, int rows, int H, int dq, int dk, int dv,
              float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int a_stride = pad_k(H) + kI8Pad;
  int8_t* as = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* bs = as + kGBM * a_stride;
  float* rs = reinterpret_cast<float*>(bs + kStages * kGBN * kBStride);
  const int row0 = blockIdx.x * kGBM;

  quantize_rows<true>(as, a_stride, rs, x, lns, lnb, eps, row0, kGBM, rows, H, pad_k(H));
  __syncthreads();
  stream_gemm<2, 4, 2, 4, kStages, kBK>(as, a_stride, w, dq + dk + dv, H, bs, blockIdx.x,
                          [&](int row, int col, int v0, int v1, int) {
    const int grow = row0 + row;
    if (grow >= rows) return;
    const float ys = rs[row];
    const float h0 = scale_bias(v0, ys, s[col], b[col]);
    const float h1 = scale_bias(v1, ys, s[col + 1], b[col + 1]);
    __nv_bfloat16* dst = q;
    int c = col, ld = dq;
    if (col >= dq + dk) {
      dst = v; c = col - dq - dk; ld = dv;
    } else if (col >= dq) {
      dst = k; c = col - dq; ld = dk;
    }
    *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(grow) * ld + c) = pack_bf16x2(h0, h1);
  });
}

// ---- I ----
__global__ void __launch_bounds__(kI8Threads, 2)
proj_res_kernel(const __nv_bfloat16* __restrict__ attn, const __nv_bfloat16* __restrict__ res,
                const int8_t* __restrict__ w, const float* __restrict__ s,
                const float* __restrict__ b, __nv_bfloat16* __restrict__ out, int rows, int D,
                int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int a_stride = pad_k(D) + kI8Pad;
  int8_t* as = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* bs = as + kGBM * a_stride;
  float* rs = reinterpret_cast<float*>(bs + kStages * kGBN * kBStride);
  const int row0 = blockIdx.x * kGBM;

  quantize_rows<false>(as, a_stride, rs, attn, nullptr, nullptr, 0.f, row0, kGBM, rows, D,
                       pad_k(D));
  __syncthreads();
  stream_gemm<2, 4, 2, 4, kStages, kBK>(as, a_stride, w, H, D, bs, blockIdx.x,
                                   [&](int row, int col, int v0, int v1, int) {
    const int grow = row0 + row;
    if (grow >= rows) return;
    const float a_scale = rs[row];
    const size_t at = static_cast<size_t>(grow) * H + col;
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + at));
    *reinterpret_cast<uint32_t*>(out + at) =
        pack_bf16x2(__fadd_rn(r.x, scale_bias(v0, a_scale, s[col], b[col])),
                    __fadd_rn(r.y, scale_bias(v1, a_scale, s[col + 1], b[col + 1])));
  });
}

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

constexpr int kLnRows = 64;  // rows per block of H's LN + quantise launch (8 per warp)

// H, launch 1: LN + row quantisation of x into yq [rows][H] and ys [rows].
__global__ void __launch_bounds__(kI8Threads)
ln_quant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lns,
                const float* __restrict__ lnb, int8_t* __restrict__ yq, float* __restrict__ ys,
                int rows, int H, float eps) {
  const int row0 = blockIdx.x * kLnRows;
  quantize_rows<true>(yq + static_cast<size_t>(row0) * H, H, ys + row0, x, lns, lnb, eps, row0,
                      min(kLnRows, rows - row0), rows, H, H);
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

// H, launch 4 (fc2): out = bf16(x + (acc * (gs * s2) + b2)).
struct BiasResidual {
  const unsigned int* amax_bits;
  const float* s2;
  const float* b2;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  int M, N;
  static constexpr bool kStaged = true;

  __device__ __forceinline__ void chunk(int row, int col, const int (&v)[8]) const {
    if (row >= M || col >= N) return;
    const float scale = mlp_scale(amax_bits, row);
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

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace videoitg

// x: bf16 [rows][H]; lns, lnb: fp32 [H]; w: int8 [dq+dk+dv][H]; s, b: fp32
// [dq+dk+dv]; q, k, v: bf16 [rows][dq], [rows][dk], [rows][dv]. Contiguous,
// 16-byte aligned, H a multiple of 16, dq, dk, dv of 8. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int videoitg_fused_ln_qkv_int8_bf16(const void* x, const void* lns, const void* lnb,
                                               const void* w, const void* s, const void* b,
                                               void* q, void* k, void* v, int rows, int H,
                                               int dq, int dk, int dv, float eps, void* stream) {
  using namespace videoitg;
  if (rows <= 0 || H <= 0 || H % 16 || H > kMaxRowK || dq <= 0 || dk <= 0 || dv <= 0 ||
      dq % 8 || dk % 8 || dv % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kGBM * (pad_k(H) + kI8Pad) + kStages * kGBN * kBStride + kGBM * 4;
  cudaError_t err = allow_smem(ln_qkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_qkv_kernel<<<(rows + kGBM - 1) / kGBM, kI8Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(v), rows, H, dq, dk, dv, eps);
  return static_cast<int>(cudaGetLastError());
}

// H in four launches, each on `stream`, each returning cudaGetLastError().
// x: bf16 [rows][H]; lns, lnb: fp32 [H]; w1: int8 [M][H]; s1, b1: fp32 [M];
// w2: int8 [H][M]; s2, b2: fp32 [H]; act 0 = gelu (tanh form), 1 =
// quick_gelu. Scratch (the caller's): yq int8 [rows][H], ys fp32 [rows],
// amax (fp32 bits) [rows], zeroed before launch 2; gq int8 [rows][M]. All
// contiguous and 16-byte aligned, H and M multiples of 16, H at most 2048.
extern "C" int videoitg_mlp_ln_quant_int8_bf16(const void* x, const void* lns, const void* lnb,
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
  const BiasResidual epi{static_cast<const unsigned int*>(amax), static_cast<const float*>(s2),
                         static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(x),
                         static_cast<__nv_bfloat16*>(out), rows, H};
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(hgemm::launch(gq, w2, epi, rows, H, M, st));
}

// attn: bf16 [rows][D]; res, out: bf16 [rows][H]; w: int8 [H][D]; s, b: fp32
// [H]. D a multiple of 16, H of 8.
extern "C" int videoitg_fused_proj_residual_int8_bf16(const void* attn, const void* res,
                                                      const void* w, const void* s,
                                                      const void* b, void* out, int rows, int D,
                                                      int H, void* stream) {
  using namespace videoitg;
  if (rows <= 0 || D <= 0 || H <= 0 || D % 16 || D > kMaxRowK || H % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kGBM * (pad_k(D) + kI8Pad) + kStages * kGBN * kBStride + kGBM * 4;
  cudaError_t err = allow_smem(proj_res_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  proj_res_kernel<<<(rows + kGBM - 1) / kGBM, kI8Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(res),
      static_cast<const int8_t*>(w), static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), rows, D, H);
  return static_cast<int>(cudaGetLastError());
}
