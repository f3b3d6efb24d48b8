// Trainable streaming attention with native GQA (sm_90a): forward with the
// per-row logsumexp, and the two backward kernels.
//
// Replaces the three TPU kernels of videoitg_tpu/ops/flash_attention_train.py:
// `_fwd_kernel` (forward + lse), `_dq_kernel` (dQ) and `_dkv_kernel` (dK, dV
// summed over the GQA group). Query head h reads KV head h / (Hq / Hkv) in
// place in both directions; K and V are never repeated in device memory.
//
// Arithmetic (bf16 operands, fp32 accumulation, fp32 softmax statistics):
//   forward   s = q k^T, p = exp(sm_scale (s - m)) rounded to bf16 into p v,
//             o = acc / l, lse = sm_scale m + log l (natural log)
//   backward  p = exp(sm_scale s - lse), dp = dO v^T, ds = p (dp - delta)
//             dv += bf16(p)^T dO
//             dq  = sm_scale * sum_k bf16(ds) k
//             dk  = sm_scale * sum_q bf16(ds)^T q
// with delta = rowsum(dO * o) in fp32, computed by the caller. Masking uses
// the contract of flash_attention.cu: a masked key (invalid, beyond S, or in
// a causal row's future) has probability exactly 0, so an invalid key gets
// dk = dv = 0; a row with no visible valid key outputs 0 and stores
// lse = +inf, which makes every p of that row exp(-inf) = 0 in the backward.
// The backward kernels read `valid` as a key mask only: the caller zeroes dO
// on invalid query rows, which zeroes their delta, ds and dq and keeps them
// out of dk and dv.
//
// What bounds them on an H100, at the training shape q [1, 28, 16640, 128],
// k/v [1, 4, 16640, 128] (1024 frames x 16 image slots + 256 text slots):
// S^2 D Hq = 0.992 TFLOP per product pair, so the forward does 3.97 TFLOP, dQ
// 5.95 and dK/dV 7.94 against a few hundred MB of operands: thousands of
// operations per byte, far above the ~295 bf16 ridge. All three are bound by
// the tensor cores; none of the S x S matrices leaves registers. On an NVIDIA
// H100 80GB HBM3 at 700 W they take 8.55 (C), 9.45 (D) and 12.97 ms (E) at
// that shape with 16,500 valid tokens (chip_smoke.py).
//
// Design: all three on TMA + wgmma, a producer warp and two consumer
// warpgroups a block.
// * forward (kernel C): hattn::stream_kernel<DP, false, true>
//   (hopper_attention.cuh), kernel B's TMA + wgmma kernel with the lse store:
//   a producer warp streams 128-key tiles of K and V by TMA through a ring,
//   two consumer warpgroups of 64 query rows each run S = Q K^T and O += P V
//   as wgmma; one block per (q head, 128-row tile, batch), causal blocks with
//   the most key tiles first.
// * dQ (kernel D): hattn::dq_kernel<DP, KeyMask> (hopper_attention_dq.cuh),
//   query-stationary: one block owns 128 query rows of one q head, loads Q
//   and dO once by TMA and streams K and V with the tile's key-valid bytes;
//   S = Q K^T and dP = dO V^T from shared memory, dQ += dS K with dS as the
//   register operand and K read MN-major, so nothing is transposed. The
//   kernel is shared with kernel J's dQ (flash_attention_segment.cu), which
//   differs only in its mask policy.
// * dK/dV (kernel E): hattn::dkv_kernel<DP, KeyMask, false>
//   (hopper_attention_dkv.cuh), shared with kernel J's dK/dV: one block
//   owns 128 keys of one KV head, loads K and V once by TMA, and walks every
//   query head of the group and every 64-row query tile itself, so the sums
//   over the group need no atomics and are the same from run to run. It works
//   on the transposed scores (K Q^T, V dO^T, wgmma from shared memory), whose
//   accumulators are already the register operands of P^T dO and dS^T Q;
//   Q and dO arrive by TMA in the layout both products read.
// Lengths need not be a multiple of the tiles: rows beyond S are staged as
// zeros and masked (keys) or given lse = +inf (queries). D is any multiple
// of 8 up to 128 and is padded to a multiple of 16 in shared memory only
// (72 -> 80). Causal blocks skip the tiles wholly above the diagonal.
#include "hopper_attention_dq.cuh"

namespace videoitg {

// --------------------------------------------------------------- launches --

struct TrainArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const uint8_t* valid;
  const float *lse_in, *delta;
  __nv_bfloat16 *o, *dq, *dk, *dv;
  float* lse_out;
  int B, Hq, Hkv, S, D, causal;
  float sm_scale;
  cudaStream_t stream;
};

// Kernel C: stream_kernel's online mode with the lse store
// (hopper_attention.cuh), grid (Hq, ceil(S / 128), B), causal blocks with the
// most key tiles first.
template <int DP>
cudaError_t launch_fwd(const TrainArgs& a) {
  hattn::Args h{a.q, a.k, a.v, a.valid, a.o, a.B, a.Hq, a.Hkv, a.S, a.D, a.causal,
                a.sm_scale * kLog2e, a.stream};
  h.lse = a.lse_out;
  return hattn::launch_stream<DP, false, true>(h, hattn::KeyMask{a.valid});
}

// Kernel D: hattn::dq_kernel<DP, KeyMask> (hopper_attention_dq.cuh), grid
// (ceil(S / 128), Hq, B), causal blocks with the most key tiles first.
static hattn::BwdArgs bwd_args(const TrainArgs& a) {
  return hattn::BwdArgs{a.q, a.k, a.v, a.dout, a.lse_in, a.delta, a.dq, a.dk, a.dv, a.B,
                        a.Hq, a.Hkv, a.S, a.D, a.causal, a.sm_scale, a.stream};
}

template <int DP>
cudaError_t launch_dq(const TrainArgs& a) {
  return hattn::launch_dq<DP>(bwd_args(a), hattn::KeyMask{a.valid});
}

// Kernel E: hattn::dkv_kernel<DP, KeyMask, false> (hopper_attention_dkv.cuh),
// grid (Hkv, ceil(S / 128), B).
template <int DP>
cudaError_t launch_dkv(const TrainArgs& a) {
  return hattn::launch_dkv<DP, hattn::kDkvKeyTilesFirstE != 0>(bwd_args(a),
                                                              hattn::KeyMask{a.valid});
}

static bool shapes_ok(const TrainArgs& a) {
  return a.B > 0 && a.Hq > 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.S > 0 && a.D > 0 &&
         a.D <= 128 && a.D % 8 == 0 && a.B <= 65535 && a.Hq <= 65535 &&
         static_cast<long long>(a.B) * a.S < (1LL << 31);
}

}  // namespace videoitg

// Shapes for all three: q, out, dout, dq contiguous bf16 [B, Hq, S, D]; k, v,
// dk, dv contiguous bf16 [B, Hkv, S, D]; lse, delta contiguous fp32
// [B, Hq, S]; valid contiguous uint8/bool [B, S] or null (every key valid);
// q, k, v, dout 16-byte aligned (TMA). Hq % Hkv == 0, D a multiple of 8 and
// at most 128, B and Hq at most 65535, B * S below 2^31. Each launches on
// `stream` and returns cudaGetLastError().

extern "C" int videoitg_flash_train_fwd_bf16(const void* q, const void* k, const void* v,
                                             const void* valid, void* out, void* lse, int B,
                                             int Hq, int Hkv, int S, int D, int causal,
                                             float sm_scale, void* stream) {
  using namespace videoitg;
  TrainArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.valid = static_cast<const uint8_t*>(valid);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.lse_out = static_cast<float*>(lse);
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_fwd, a)
}

extern "C" int videoitg_flash_train_dq_bf16(const void* q, const void* k, const void* v,
                                            const void* valid, const void* dout,
                                            const void* lse, const void* delta, void* dq, int B,
                                            int Hq, int Hkv, int S, int D, int causal,
                                            float sm_scale, void* stream) {
  using namespace videoitg;
  TrainArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.valid = static_cast<const uint8_t*>(valid);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_dq, a)
}

extern "C" int videoitg_flash_train_dkv_bf16(const void* q, const void* k, const void* v,
                                             const void* valid, const void* dout,
                                             const void* lse, const void* delta, void* dk,
                                             void* dv, int B, int Hq, int Hkv, int S, int D,
                                             int causal, float sm_scale, void* stream) {
  using namespace videoitg;
  TrainArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.valid = static_cast<const uint8_t*>(valid);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_dkv, a)
}
