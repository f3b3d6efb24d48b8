// Short-sequence attention for the SigLIP vision tower (sm_90a): kernel A.
//
// Replaces the TPU kernel `_short_kernel` in
// videoitg_tpu/ops/flash_attention_short.py (entry `flash_mha_short`):
// non-causal, unmasked multi-head attention with Hq == Hkv, fp32 scores, the
// exact softmax (max, exp2, sum, divide) with the scale folded into exp2,
// the normalised P rounded to bf16 into P V, fp32 accumulation.
//
// What bounds it on an H100, at the main-path shape q/k/v [128 frames, 16
// heads, 729, 72] bf16: the attention products are 4*S^2*D = 153 MFLOP per
// (frame, head), 313 GFLOP per call, against 4 x 215 MB = 860 MB of q/k/v/o.
// That is ~364 FLOP per byte, above the card's ~295 bf16 ridge, so the
// tensor cores are the limit, not HBM.
//
// Design (hopper_attention.cuh): option (a) of the redesign, two walks with a
// cheap first one. The TPU kernel divides P by its row sum before rounding P
// to bf16, so each row's max and sum are needed before any P V. One block
// (`resident_kernel`: two consumer warpgroups of 64 rows, one producer warp)
// owns a (frame, head): it stages the whole K by TMA once (6 tiles of 128 x
// 80 at S = 729: 122,880 bytes, rows past S and columns past D zero-filled),
// keeps two Q tiles in flight and walks its 6 query tiles. Per query tile,
// pass 1 computes Q K^T from shared memory only, the row max and the online
// fp32 sum of exp2((s - max) * scale * log2 e); pass 2 computes Q K^T again,
// p = exp2(...) times the row's 1 / sum, rounded to bf16, and P V with V
// streamed through a 2-stage TMA ring. The price is 1.5x the MMA work, ~555
// GFLOP a call with the padding. Option (b), one Q K^T with a 64 x 736 fp32
// score row kept on chip, needs 184 score registers a thread over two
// warpgroups before O and P, or 188 KB of shared memory beside the tiles.
//
// Why K is resident: the first TMA version streamed K through the ring in
// both passes, one block per 128-query tile, and took 2.09 ms, where the same
// kernel at D = 80 took 1.69: each (frame, head)'s K came from L2 twelve
// times and V six, in 32-byte boxes at a 144-byte row pitch that straddle two
// 32-byte sectors on every other row. With K resident the call is 1.48 ms at
// D = 72 and at D = 80 alike. Beyond resident_tiles<DP>() (S > 896 at D = 72)
// the streaming kernel serves, in two-pass mode.
//
// Departures from the TPU arithmetic, all at fp32 rounding level before p is
// rounded to bf16: the online sum rounds differently from a sum taken after
// the max is known; p is exp2(s * scale - max * scale) (one FMA and ex2.approx)
// times the reciprocal of the sum; keys are summed in tiles of 128 split over
// the 4 threads of a row. D = 72 is read as 80 (zero columns, exact in Q K^T
// and never stored); the ragged S = 729 is masked at the last tile's edge;
// rows past S are never stored.
//
// ptxas (-Xptxas -v, sm_90a): 168 registers at entry for every head dim,
// 0 bytes of spill; setmaxnreg raises the consumers to 232 (see
// hopper_attention.cuh).
#include "hopper_attention.cuh"

namespace videoitg {

template <int DP>
cudaError_t launch_short(const hattn::Args& args) {
  return hattn::launch_two_pass<DP>(args);
}

}  // namespace videoitg

// q, k, v, out: contiguous, 16-byte-aligned bf16 [B, H, S, D] on the current
// device, D a multiple of 8 and at most 128, B and H at most 65535. Launches
// on `stream`; returns cudaGetLastError().
extern "C" int videoitg_flash_mha_short_bf16(const void* q, const void* k, const void* v,
                                             void* out, int B, int H, int S, int D,
                                             float sm_scale, void* stream) {
  using namespace videoitg;
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > 128 || D % 8 != 0 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const hattn::Args args{q, k, v, nullptr, out, B, H, H, S, D, 0,
                         sm_scale * 1.4426950408889634f, static_cast<cudaStream_t>(stream)};
  VIDEOITG_DISPATCH_DP(launch_short, args)
}

extern "C" const char* videoitg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
