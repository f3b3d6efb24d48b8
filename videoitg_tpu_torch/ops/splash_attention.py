"""Non-causal MQA with a segment-id mask for the LM's serving prefill: CUDA
kernel + plain version.

Counterpart of `_splash_lm` / `_make_splash_kernel` in
videoitg_tpu/ops/attention.py, the A/B arm that sends the grounding LM's
attention through jax's library splash MQA kernel instead of the in-tree
flash kernel. The kernel here is csrc/splash_attention.cu, hand-written for
Hopper: kernel B's TMA + wgmma kernel (csrc/hopper_attention.cuh) with the
segment-id mask policy; its source note gives the design.

Three layers, as in the JAX package:

* `splash_mqa` — the kernel's contract: q ALREADY SCALED [B, Hq, S, D], k/v
  [B, Hkv, S, D], int32 segment ids [B, S] for the queries and for the keys;
  a query attends a key iff their ids are equal; fp32 softmax; one KV head
  serves the Hq / Hkv query heads of its group. CPU tensors run
  `splash_mqa_reference`, CUDA tensors launch the kernel or raise (q, k, v
  contiguous and 16-byte aligned: the kernel reads them by TMA).
* `splash_mqa_reference` — the plain PyTorch version of the same function.
* `splash_lm` — what the LM calls: q scaled by D ** -0.5 in q's own dtype (in
  bf16 that is a rounding the flash arm does not make: it scales the fp32
  scores), ids made from `valid` (1 valid, 0 invalid), the kernel, and invalid
  query rows set to exactly 0. Invalid queries do attend the invalid keys
  (both have id 0); only that last multiply hides it, as in the JAX function.

Where it differs from the TPU kernel: there is no padding to a block (the
kernel masks the ragged edge itself), so invalid queries never see zero pad
keys, and a query whose id matches no key gives 0 here and the mean of V
there. Neither can show through `splash_lm`: its invalid rows are zeroed and
its queries always match themselves.
"""

from __future__ import annotations

import torch

from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops._kernel_args import check_matrix, check_operands, stream_handle


def splash_mqa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_segment_ids: torch.Tensor,
                         kv_segment_ids: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, O(S^2) memory: fp32 scores of the
    already-scaled q, keys of another segment at -inf, unnormalised
    p = exp(s - max) rounded to v's dtype into P V, fp32 accumulation, divided
    by the fp32 row sum at the end. Returns [B, Hq, S, D] in q.dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    group = hq // hkv
    qf = q.reshape(b, hkv, group, s, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    same = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]  # [B, S, S]
    logits = logits.masked_fill(~same[:, None, None], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    out = out / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return out.reshape(b, hq, s, d).to(q.dtype)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on the shapes the kernel refuses: Hq not a multiple of Hkv, k
    and v not [B, Hkv, S, D] beside q, B or Hq above 65535 or B * S of 2^31
    or more (the grid and the tensor maps). Returns (B, Hq, Hkv, S, D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"splash_mqa: Hq={hq} is not a multiple of Hkv={hkv}")
    if k.shape != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"splash_mqa: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if b > 65535 or hq > 65535 or b * s >= 2 ** 31:
        raise ValueError(f"splash_mqa: q {tuple(q.shape)} is beyond the kernel's grid "
                         f"(B, Hq <= 65535, B * S < 2^31)")
    return b, hq, hkv, s, d


def splash_mqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_segment_ids: torch.Tensor, kv_segment_ids: torch.Tensor) -> torch.Tensor:
    """Segment-masked MQA of an already-scaled q. Returns [B, Hq, S, D] in
    q.dtype.

    CPU tensors run `splash_mqa_reference`. CUDA tensors launch the kernel
    (bf16, contiguous, 16-byte aligned, D a multiple of 8 up to 128, int32
    ids) or raise.
    """
    if q.device.type == "cpu":
        return splash_mqa_reference(q, k, v, q_segment_ids, kv_segment_ids)
    check_operands("splash_mqa", q, k, v)
    b, hq, hkv, s, d = check_shapes(q, k, v)
    check_matrix("splash_mqa", "q_segment_ids", q_segment_ids, torch.int32, (b, s), q.device)
    check_matrix("splash_mqa", "kv_segment_ids", kv_segment_ids, torch.int32, (b, s), q.device)
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.videoitg_splash_mqa_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_segment_ids.data_ptr(),
        kv_segment_ids.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, stream_handle(q))
    _build.check(err, "splash_mqa")
    splash_mqa.launches += 1
    return out


splash_mqa.launches = 0


def prescale(q: torch.Tensor) -> torch.Tensor:
    """q * D ** -0.5 in q's own dtype, rounded as the JAX function rounds it:
    the factor itself is first rounded to q's dtype (jax makes a Python
    scalar an array of the other operand's dtype), then the product is."""
    return q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype).item()


def splash_lm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """The LM's splash arm: `valid` is the [B, S] bool key mask of the other
    kernels. Returns [B, Hq, S, D] in q.dtype, invalid query rows exactly 0."""
    seg = valid.to(torch.int32)
    out = splash_mqa(prescale(q), k, v, seg, seg)
    return out * valid[:, None, :, None].to(out.dtype)
