// Trainable multi-head attention with a segment-id mask (sm_90a): forward
// with the per-row logsumexp, dQ, and dK/dV.
//
// Replaces the TPU kernels behind `mha_trainable` in
// videoitg_tpu/ops/attention.py (the `use_flash="train-jax"` arm): jax's
// library flash attention for the TPU (jax/experimental/pallas/ops/tpu/
// flash_attention.py), its forward, dkv and dq Pallas kernels under one custom
// VJP. Contract, as that arm uses them: MHA (as many KV heads as query heads;
// the caller repeats the KV heads of a GQA model), int32 segment ids [B, S]
// for the queries and for the keys, a query attends a key iff their ids are
// equal (and, when causal, key <= query); the scores are scaled by sm_scale in
// fp32; fp32 softmax statistics.
//
// What differs from flash_attention_train.cu (kernels C, D, E): the three
// kernels are C's, D's and E's kernels with another mask policy.
// * The mask is id equality for both sides, not a key-valid mask. A query at
//   a position the caller calls invalid (id 0) is computed like any other
//   row: it attends the other id-0 keys (the caller's zero padding included),
//   its o is not zeroed, its dO is not ignored and it gets a dq; an id-0 key
//   gets dk and dv from the id-0 queries.
// * MHA: a block of dK/dV owns 128 keys of ONE head and walks that head's
//   query tiles. There is no group to sum over, and no atomics: two runs
//   give the same bits.
// * A query whose id matches no visible key (it cannot occur when both id
//   arrays are the same tensor and the mask is not causal-cut below the row
//   itself: a row always sees itself) outputs 0, stores lse = +inf and has
//   zero gradient. The TPU kernel masks with a large finite value and gives
//   such a row the mean of V; `mha_trainable` reaches neither.
//
// Arithmetic (bf16 operands, fp32 accumulation), the same rounding points as
// C, D, E:
//   forward   s = q k^T, p = exp(sm_scale (s - m)) rounded to bf16 into p v,
//             o = acc / l, lse = sm_scale m + log l (natural log)
//   backward  p = exp(sm_scale s - lse), dp = dO v^T, ds = p (dp - delta)
//             dv = sum_q bf16(p)^T dO
//             dq = sm_scale * sum_k bf16(ds) k
//             dk = sm_scale * sum_q bf16(ds)^T q
// with delta = rowsum(dO * o) in fp32, computed by the caller.
//
// What bounds them on an H100, at the LM's training shape after the KV repeat
// and the padding to 512, q/k/v [1, 28, 16896, 128] bf16: S^2 D H = 1.02 TMAC
// per product, 4 / 6 / 8 TFLOP for forward / dQ / dK,dV against under 1 GB
// of operands: thousands of operations per byte, far above the ~295 bf16
// ridge. The tensor cores bound all three. Causal calls skip every tile that
// lies wholly above the diagonal, in all three kernels, so they do about half
// the work.
//
// Design: all three on TMA + wgmma, a producer warp and two consumer
// warpgroups a block, with the segment-id policy (hopper_attention.cuh).
// * forward: hattn::stream_kernel<DP, false, true, SegmentIds, true>
//   (hopper_attention.cuh), kernel C's kernel: one block owns 128 query rows
//   of one head, loads Q once by TMA, streams 128-key tiles of K and V
//   through a ring of 3 stages with the tiles' kv ids staged by the
//   producer's lanes, keeps each thread's two q ids in registers, and runs S
//   = Q K^T and O += P V as wgmma (V read MN-major by the descriptor); it
//   stores lse in nats. The producer decides once whether the block's rows
//   below S carry one id, and per tile whether its keys do: a tile of
//   another id is seen by no row of the block, so nothing is loaded for it
//   and the consumers pass it by (the padding to 512 makes such tiles: 768
//   of 17,424 tile pairs at the shape above, 20 of 64 at the tower's [32,
//   16, 1024 padded from 729, 72]). The query tiles are the fastest grid
//   index, so a wave's blocks read one head's K and V.
// * dQ: hattn::dq_kernel<DP, SegmentIds> (hopper_attention_dq.cuh), the TMA +
//   wgmma kernel of kernel D: one block owns 128 query rows of one head
//   (producer warp, two consumer warpgroups), loads Q and dO once by TMA,
//   streams K and V tiles with the tiles' kv ids staged by the producer's
//   lanes, and keeps each thread's two q ids in registers; S, dP and dQ +=
//   dS K are wgmma, dS the register operand.
// * dK/dV: hattn::dkv_kernel<DP, SegmentIds, true> (hopper_attention_dkv.cuh),
//   the TMA + wgmma kernel of kernel E with a group of 1: one block owns 128
//   keys of one head (producer warp, two consumer warpgroups of 64 keys),
//   loads K and V once by TMA, streams the head's 64-row Q and dO tiles
//   with their lse, delta and q ids staged by the producer's lanes, and keeps
//   each thread's two kv ids in registers; S^T = K Q^T and dP^T = V dO^T
//   from shared memory, dV += P^T dO and dK += dS^T Q with P^T, dS^T as the
//   register operands. The key tiles are the fastest grid index, so a wave's
//   blocks share one head's Q and dO stream.
// The tensor maps need q, k, v and dout 16-byte aligned. Lengths need not be
// a multiple of the tiles (or of the caller's 512): rows beyond S are staged
// as zeros and masked. D is any multiple of 8 up to 128, padded to a
// multiple of 16 in shared memory only (72 -> 80).
#include "hopper_attention_dq.cuh"

namespace videoitg {

// --------------------------------------------------------------- launches --

struct SegmentArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const int *q_ids, *kv_ids;
  const float *lse_in, *delta;
  __nv_bfloat16 *o, *dq, *dk, *dv;
  float* lse_out;
  int B, H, S, D, causal;
  float sm_scale;
  cudaStream_t stream;
};

// Forward: hattn::stream_kernel<DP, false, true, SegmentIds, true>
// (hopper_attention.cuh), kernel C's kernel with the segment-id policy, grid
// (ceil(S / 128), H, B), causal blocks with the most key tiles first.
template <int DP>
cudaError_t launch_segment_fwd(const SegmentArgs& a) {
  hattn::Args h{a.q, a.k, a.v, nullptr, a.o, a.B, a.H, a.H, a.S, a.D, a.causal,
                a.sm_scale * kLog2e, a.stream};
  h.lse = a.lse_out;
  return hattn::launch_stream<DP, false, true, hattn::SegmentIds,
                              hattn::kFwdQueryTilesFirstJ != 0>(
      h, hattn::SegmentIds{a.q_ids, a.kv_ids});
}

// The backward kernels' operands: as many KV heads as query heads.
static hattn::BwdArgs bwd_args(const SegmentArgs& a) {
  return hattn::BwdArgs{a.q, a.k, a.v, a.dout, a.lse_in, a.delta, a.dq, a.dk, a.dv, a.B,
                        a.H, a.H, a.S, a.D, a.causal, a.sm_scale, a.stream};
}

// dQ: hattn::dq_kernel<DP, SegmentIds> (hopper_attention_dq.cuh), kernel D's
// kernel with the segment-id policy.
template <int DP>
cudaError_t launch_segment_dq(const SegmentArgs& a) {
  return hattn::launch_dq<DP>(bwd_args(a), hattn::SegmentIds{a.q_ids, a.kv_ids});
}

// dK/dV: hattn::dkv_kernel<DP, SegmentIds, true> (hopper_attention_dkv.cuh),
// kernel E's kernel with the segment-id policy, grid (ceil(S / 128), H, B).
template <int DP>
cudaError_t launch_segment_dkv(const SegmentArgs& a) {
  return hattn::launch_dkv<DP, hattn::kDkvKeyTilesFirstJ != 0>(
      bwd_args(a), hattn::SegmentIds{a.q_ids, a.kv_ids});
}

static bool segment_shapes_ok(const SegmentArgs& a) {
  return a.B > 0 && a.H > 0 && a.S > 0 && a.D > 0 && a.D <= 128 && a.D % 8 == 0 &&
         a.B <= 65535 && a.H <= 65535 && static_cast<long long>(a.B) * a.S < (1LL << 31);
}

}  // namespace videoitg

// Shapes for all three: q, k, v, out, dout, dq, dk, dv contiguous bf16
// [B, H, S, D] (q, k, v, dout 16-byte aligned: the kernels read them by
// TMA); lse, delta contiguous fp32 [B, H, S]; q_ids, kv_ids contiguous int32
// [B, S]. D a multiple of 8 and at most 128, B and H at most 65535, B * S
// below 2^31.
// Each launches on `stream` and returns cudaGetLastError().

extern "C" int videoitg_flash_segment_fwd_bf16(const void* q, const void* k, const void* v,
                                               const void* q_ids, const void* kv_ids, void* out,
                                               void* lse, int B, int H, int S, int D, int causal,
                                               float sm_scale, void* stream) {
  using namespace videoitg;
  SegmentArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_ids = static_cast<const int*>(q_ids);
  a.kv_ids = static_cast<const int*>(kv_ids);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.lse_out = static_cast<float*>(lse);
  a.B = B; a.H = H; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!segment_shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_segment_fwd, a)
}

extern "C" int videoitg_flash_segment_dq_bf16(const void* q, const void* k, const void* v,
                                              const void* q_ids, const void* kv_ids,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dq, int B, int H, int S,
                                              int D, int causal, float sm_scale, void* stream) {
  using namespace videoitg;
  SegmentArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_ids = static_cast<const int*>(q_ids);
  a.kv_ids = static_cast<const int*>(kv_ids);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.B = B; a.H = H; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!segment_shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_segment_dq, a)
}

extern "C" int videoitg_flash_segment_dkv_bf16(const void* q, const void* k, const void* v,
                                               const void* q_ids, const void* kv_ids,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv, int B,
                                               int H, int S, int D, int causal, float sm_scale,
                                               void* stream) {
  using namespace videoitg;
  SegmentArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_ids = static_cast<const int*>(q_ids);
  a.kv_ids = static_cast<const int*>(kv_ids);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.B = B; a.H = H; a.S = S; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!segment_shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  VIDEOITG_DISPATCH_DP(launch_segment_dkv, a)
}
