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
// here x is read and the outputs are written, nothing else.
//
// Design. A block takes a tile of rows, quantises them once into an int8
// tile in shared memory (one warp per row, the row held in registers for the
// mean, variance, amax and quantise passes), and streams the whole [N][K]
// weight past it in [128][128] tiles through a two-stage cp.async ring with
// one barrier per tile, i.e. per 4 MMA k steps (int8_common.cuh,
// `stream_gemm`); weights are stored [N][K], the operand layout of mma.sync
// m16n8k32 s8, and stay in L2 across blocks, which start at different n
// tiles so that they do not all ask for the same lines at once. G and I hold
// 64 rows (75 KB) and use 32 x 32 warp tiles, two blocks to an SM, so that
// one block's row quantisation overlaps the other's products.
//
// How it got here (NVIDIA H100 80GB HBM3, 700 W, the tower's shape). The
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
// G 2.58, I 1.29, H 17.1 ms. 64-row tiles and two blocks per SM: I 1.02 ms,
// G unchanged. 128-byte k tiles (half the barriers): G 2.39, I 0.98, H
// 14.96 ms. Ring depth never mattered (two stages as good as four). The bare
// product loop reaches ~1,080 TOP/s on this card
// (scripts/torch_probes/mma_s8_rate.cu: mma.sync s8 from shared-memory
// fragments, no loads or barriers) and these kernels 124 to 311, so what is
// left is feeding it: more warps per SM, TMA and wgmma.
//
// H's intermediate. The second quantisation needs the amax of the whole
// 4304-wide row before any of it is quantised, and 16 rows of it in fp32
// (275 KB) exceed a block's 227 KB. H therefore computes fc1 twice: pass A
// only takes each row's max |GELU(fc1)|, pass B computes the same values
// again and quantises them straight into an int8 [32][4352 + 16] tile
// (140 KB) that fc2 then reads; nothing of the intermediate goes to device
// memory and nothing is rounded to bf16 before it is quantised. The cost:
// 1.5x the MLP's tensor-core work, and tiles of only 32 rows (1 x 8 warps of
// 32 x 16, one block of 8 warps to an SM), so each block pulls fc1 twice and
// fc2 once (15 MB) from L2 for 32 rows of output, 43 GB a call at the
// tower's shape, and a warp has 16 products between barriers. Tried and not
// kept: [256][64] tiles (16.7 against 17.1 ms then), a cheaper tanh from the
// hardware exp2 (20.9 against 21.3 ms then, and more roundings flipped
// against the plain version). A later version has to give an SM more warps
// and feed several row tiles from one weight read (a cluster sharing tiles,
// or TMA multicast). M = 4304 is no multiple of the k tile: the int8 tile is
// zero-padded to 4352 in shared memory and the loads of fc2's rows are
// masked (exact).
#include "int8_common.cuh"

namespace videoitg {

constexpr int kGBM = 64;   // rows per block, G and I (2 x 4 warps of 32 x 32)
constexpr int kGBN = 128;
constexpr int kHBM = 32;   // rows per block, H (1 x 8 warps of 32 x 16)
constexpr int kHBN = 128;
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
// Every product and sum rounded on its own, so that pass A and pass B of H
// compute the same bits whatever the compiler does around them.
__device__ __forceinline__ float activation(float h, int act) {
  if (act == 0) {  // gelu, tanh form: 0.5 h (1 + tanh(sqrt(2/pi) (h + 0.044715 h^3)))
    const float cube = __fmul_rn(__fmul_rn(h, h), h);
    const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, __fmul_rn(0.044715f, cube)));
    return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, tanhf(inner)));
  }
  // quick_gelu: h * sigmoid(1.702 h)
  return __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h)))));
}

__global__ void __launch_bounds__(kI8Threads)
ln_mlp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lns,
              const float* __restrict__ lnb, const int8_t* __restrict__ w1,
              const float* __restrict__ s1, const float* __restrict__ b1,
              const int8_t* __restrict__ w2, const float* __restrict__ s2,
              const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int rows, int H,
              int M, float eps, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int a1_stride = pad_k(H) + kI8Pad;
  const int a2_stride = pad_k(M) + kI8Pad;
  int8_t* a1 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* a2 = a1 + kHBM * a1_stride;
  int8_t* bs = a2 + kHBM * a2_stride;
  float* rs1 = reinterpret_cast<float*>(bs + kStages * kHBN * kBStride);
  float* gs = rs1 + kHBM;
  unsigned int* amax_bits = reinterpret_cast<unsigned int*>(gs + kHBM);
  const int row0 = blockIdx.x * kHBM;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  if (threadIdx.x < kHBM) amax_bits[threadIdx.x] = 0u;
  // The k padding of the intermediate tile, bytes [M, pad_k(M)) of each row.
  const int pad_bytes = pad_k(M) - M;
  for (int idx = threadIdx.x; idx < kHBM * pad_bytes; idx += kI8Threads) {
    a2[(idx / pad_bytes) * a2_stride + M + idx % pad_bytes] = 0;
  }
  quantize_rows<true>(a1, a1_stride, rs1, x, lns, lnb, eps, row0, kHBM, rows, H, pad_k(H));
  __syncthreads();

  // Pass A: each row's max |act(fc1)|. A thread meets rows g, g + 8, g + 16,
  // g + 24 of the tile (slots 0..3).
  float amax[4] = {0.f, 0.f, 0.f, 0.f};
  stream_gemm<1, 8, 2, 2, kStages, kBK>(a1, a1_stride, w1, M, H, bs, blockIdx.x,
                          [&](int row, int col, int v0, int v1, int slot) {
    const float ys = rs1[row];
    const float g0 = activation(scale_bias(v0, ys, s1[col], b1[col]), act);
    const float g1 = activation(scale_bias(v1, ys, s1[col + 1], b1[col + 1]), act);
    amax[slot] = fmaxf(amax[slot], fmaxf(fabsf(g0), fabsf(g1)));
  });
#pragma unroll
  for (int slot = 0; slot < 4; ++slot) {
    float m = amax[slot];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    // Non-negative floats order like their bit patterns.
    if (t == 0) atomicMax(&amax_bits[slot * 8 + g], __float_as_uint(m));
  }
  __syncthreads();
  if (threadIdx.x < kHBM) gs[threadIdx.x] = row_scale_of(__uint_as_float(amax_bits[threadIdx.x]));
  __syncthreads();

  // Pass B: the same values again, quantised into the int8 tile.
  stream_gemm<1, 8, 2, 2, kStages, kBK>(a1, a1_stride, w1, M, H, bs, blockIdx.x,
                          [&](int row, int col, int v0, int v1, int) {
    const float ys = rs1[row];
    const float scale = gs[row];
    const int q0 = quant8(activation(scale_bias(v0, ys, s1[col], b1[col]), act), scale);
    const int q1 = quant8(activation(scale_bias(v1, ys, s1[col + 1], b1[col + 1]), act), scale);
    *reinterpret_cast<uint16_t*>(a2 + row * a2_stride + col) =
        static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
  });

  // fc2 over the int8 intermediate, + bias, + the residual x.
  stream_gemm<1, 8, 2, 2, kStages, kBK>(a2, a2_stride, w2, H, M, bs, blockIdx.x,
                          [&](int row, int col, int v0, int v1, int) {
    const int grow = row0 + row;
    if (grow >= rows) return;
    const float scale = gs[row];
    const size_t at = static_cast<size_t>(grow) * H + col;
    const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
    *reinterpret_cast<uint32_t*>(out + at) =
        pack_bf16x2(__fadd_rn(xf.x, scale_bias(v0, scale, s2[col], b2[col])),
                    __fadd_rn(xf.y, scale_bias(v1, scale, s2[col + 1], b2[col + 1])));
  });
}

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

// x, out: bf16 [rows][H]; w1: int8 [M][H]; s1, b1: fp32 [M]; w2: int8 [H][M];
// s2, b2: fp32 [H]; act 0 = gelu (tanh form), 1 = quick_gelu. H and M
// multiples of 16.
extern "C" int videoitg_fused_ln_mlp_int8_bf16(const void* x, const void* lns, const void* lnb,
                                               const void* w1, const void* s1, const void* b1,
                                               const void* w2, const void* s2, const void* b2,
                                               void* out, int rows, int H, int M, float eps,
                                               int act, void* stream) {
  using namespace videoitg;
  if (rows <= 0 || H <= 0 || M <= 0 || H % 16 || H > kMaxRowK || M % 16 || act < 0 || act > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kHBM * (pad_k(H) + kI8Pad) + kHBM * (pad_k(M) + kI8Pad) +
                   kStages * kHBN * kBStride + 3 * kHBM * 4;
  cudaError_t err = allow_smem(ln_mlp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_mlp_kernel<<<(rows + kHBM - 1) / kHBM, kI8Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), rows, H, M, eps, act);
  return static_cast<int>(cudaGetLastError());
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
