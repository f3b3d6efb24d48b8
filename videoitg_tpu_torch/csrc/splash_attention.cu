// Non-causal multi-query attention with a segment-id mask, for the grounding
// LM's serving prefill (sm_90a): kernel K.
//
// Replaces the TPU kernel behind `_splash_lm` in videoitg_tpu/ops/attention.py:
// jax's library splash MQA forward kernel (made by `_make_splash_kernel`,
// `make_splash_mqa_single_device` with a full mask), vmapped over KV heads and
// batch. Contract, as that kernel has it: q arrives ALREADY SCALED (the kernel
// multiplies the scores by nothing); q_seg and kv_seg are int32 [B, S]
// segment ids and a query attends a key iff their ids are equal; fp32 scores,
// running max and sum, natural exp; one KV head serves the `group` query
// heads of its group. P is rounded to bf16 into P V (the tensor cores take
// bf16 operands); fp32 accumulation; out = acc / l. A query whose id matches
// no key outputs 0 (it cannot occur when q_seg and kv_seg are the same
// array, as in `splash_lm`: a query always matches itself). Every other row
// is stored as computed, whatever its id: `splash_lm` zeroes the invalid
// rows itself. There is no padding in device memory: the ragged edge of the
// last tile is masked here, rows beyond S are never written.
//
// What bounds it on an H100, at the main-path shape q [1, 28, 13056, 128],
// k/v [1, 4, 13056, 128] bf16: the same work as flash_attention.cu,
// 4*S^2*D*Hq = 2.44 TFLOP against 214 MB of q/k/v/o, so the tensor cores
// bound it, not HBM.
//
// Design: kernel B's TMA + wgmma kernel with another mask policy,
// hattn::stream_kernel<DP, false, false, SegmentIds> (hopper_attention.cuh).
// One block per (q head, 128-row query tile, batch), the q heads the fastest
// grid index, so the q heads of a KV group are adjacent blocks that read the
// same K and V tiles from L2; any group size runs in one launch. A producer
// warp streams 128-key tiles of K and V by TMA through a ring of 3 stages
// and its 32 lanes stage each tile's 128 int32 key ids beside them (512 bytes
// a stage) with a summary: whether every key of the tile lies below S and
// carries one id, and that id. Each consumer thread keeps its two rows' q ids
// in registers; a key is seen iff it lies below S and the ids are equal. On
// a tile with one id a thread whose rows carry it skips the masking and one
// whose rows do not hides the whole tile, with no id loaded: the LM's ids
// are a valid prefix, so nearly every tile is such a tile. The pre-scaled q
// is launched with scale_log2 = log2 e (sm_scale 1): p = exp2(s log2 e -
// m log2 e) = exp(s - m). Q, K and V are read through TMA tensor maps, so
// they must be 16-byte aligned.
//
// ptxas (-Xptxas -v, sm_90a): 168 registers at entry, 232 after setmaxnreg,
// 0 spill. On an NVIDIA H100 80GB HBM3 at 700 W it takes 5.28 ms at the shape
// above with a 12,840-token valid prefix, B 5.37 on the same inputs; with 1%
// of the keys invalid at random (most tiles hold two ids) 6.38 against B's
// 5.21 (chip_smoke.py, scripts/torch_probes/attention_probe.py).
#include "hopper_attention.cuh"

namespace videoitg {

template <int DP>
cudaError_t launch_splash(const hattn::Args& a, const int* q_seg, const int* kv_seg) {
  return hattn::launch_stream<DP, false>(a, hattn::SegmentIds{q_seg, kv_seg});
}

}  // namespace videoitg

// q (already scaled), out: contiguous bf16 [B, Hq, S, D]; k, v: contiguous bf16
// [B, Hkv, S, D]; q, k, v 16-byte aligned (TMA); q_seg, kv_seg: contiguous
// int32 [B, S]. Hq % Hkv == 0, D a multiple of 8 and at most 128, B and Hq at
// most 65535, B * S below 2^31. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int videoitg_splash_mqa_bf16(const void* q, const void* k, const void* v,
                                        const void* q_seg, const void* kv_seg, void* out,
                                        int B, int Hq, int Hkv, int S, int D, void* stream) {
  using namespace videoitg;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || B > 65535 || Hq > 65535 || static_cast<long long>(B) * S >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const hattn::Args a{q, k, v, nullptr, out, B, Hq, Hkv, S, D, 0, kLog2e,
                      static_cast<cudaStream_t>(stream)};
  const auto* qs = static_cast<const int*>(q_seg);
  const auto* ks = static_cast<const int*>(kv_seg);
  switch ((D + 15) / 16) {
    case 1: return static_cast<int>(launch_splash<16>(a, qs, ks));
    case 2: return static_cast<int>(launch_splash<32>(a, qs, ks));
    case 3: return static_cast<int>(launch_splash<48>(a, qs, ks));
    case 4: return static_cast<int>(launch_splash<64>(a, qs, ks));
    case 5: return static_cast<int>(launch_splash<80>(a, qs, ks));
    case 6: return static_cast<int>(launch_splash<96>(a, qs, ks));
    case 7: return static_cast<int>(launch_splash<112>(a, qs, ks));
    default: return static_cast<int>(launch_splash<128>(a, qs, ks));
  }
}
