// Streaming (flash) attention with native GQA for the grounding LM (sm_90a):
// kernel B.
//
// Replaces the TPU kernel `_flash_kernel` in videoitg_tpu/ops/flash_attention.py
// (entry `flash_mha`): online-softmax attention over K/V tiles, query head h
// reading KV head h / (Hq / Hkv) in place, non-causal or causal, a [B, S] key
// mask. Contract (the same as ops/attention.mha_reference): masked keys get
// exactly zero probability, a row with no visible valid key outputs 0, and
// invalid query rows output 0 (so a causal row whose visible prefix is all
// invalid gives future keys no weight either). fp32 scores, running max and
// sum; p rounded to bf16 into P V; fp32 accumulation.
//
// What bounds it on an H100, at the main-path shape q [1, 28, 13056, 128],
// k/v [1, 4, 13056, 128] bf16 (512 frames x 25 image slots + 256 text slots):
// the products are 4*S^2*D*Hq = 2.44 TFLOP per call against 214 MB of
// q/k/v/o, ~11,000 FLOP per byte: far above the ~295 bf16 ridge, so the
// tensor cores bound it and HBM traffic does not matter. The O(S^2) score
// matrix (19 GB in fp32 per layer if materialised) never leaves registers.
//
// Design (hopper_attention.cuh, `stream_kernel<DP, false, false, KeyMask>`,
// online mode): one block per (128-query tile, q head, batch); a producer
// warp streams K and V by TMA
// through a 3-stage ring and stages each tile's 128 key-mask bytes beside
// them; two consumer warpgroups of 64 rows run S = Q K^T and O += P V as
// wgmma (P from registers, V read transposed from shared memory), the running
// max and sum in registers. Masked keys, keys past S and (causal) keys after
// the row are -inf scores; tiles that need none of these skip the masking.
// Causal blocks stop at their last visible tile and start in order of most
// tiles first.
//
// GQA: the grid puts the q heads innermost (blockIdx.x), so the 7 q heads of
// a group on the same query tile run side by side and read the same K / V
// tiles, which stay in L2 (6.7 MB a layer against 50 MB). A block that owned
// the whole group would stage each tile once for 7 heads but needs 7 x 64 x
// 128 fp32 accumulators or a loop over the heads inside the block (kernel K's
// first version did so, 14 warps at 17.1 ms). The L2 order keeps one
// skeleton for A, B, C and K, and B at
// [1, 28/4, 13056, 128] with its key mask takes 5.22 ms on an H100 80GB HBM3
// at 700 W, below one scaled_dot_product_attention call on the same inputs
// (5.50 ms).
//
// ptxas (-Xptxas -v, sm_90a): 168 registers at entry for every head dim,
// 0 bytes of spill; setmaxnreg raises the consumers to 232 (the first TMA
// version, 9 warps without setmaxnreg, was held to 168 and spilled 156 bytes
// at DP = 128).
#include "hopper_attention.cuh"

namespace videoitg {

template <int DP>
cudaError_t launch_flash(const hattn::Args& args) {
  return hattn::launch_stream<DP, false>(args, hattn::KeyMask{args.valid});
}

}  // namespace videoitg

// q, out: contiguous bf16 [B, Hq, S, D]; k, v: contiguous bf16 [B, Hkv, S, D];
// valid: contiguous uint8/bool [B, S] or null (every key valid); q, k, v
// 16-byte aligned (TMA). Hq % Hkv == 0, D a multiple of 8 and at most 128, B and Hq
// at most 65535, B * S below 2^31. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int videoitg_flash_mha_bf16(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, int B, int Hq, int Hkv,
                                       int S, int D, int causal, float sm_scale,
                                       void* stream) {
  using namespace videoitg;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || B > 65535 || Hq > 65535 ||
      static_cast<long long>(B) * S >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const hattn::Args args{q, k, v, static_cast<const uint8_t*>(valid), out, B, Hq, Hkv, S, D,
                         causal, sm_scale * 1.4426950408889634f,
                         static_cast<cudaStream_t>(stream)};
  VIDEOITG_DISPATCH_DP(launch_flash, args)
}
