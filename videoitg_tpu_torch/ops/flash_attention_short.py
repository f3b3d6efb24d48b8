"""Short-sequence MHA for the SigLIP tower: CUDA kernel + plain version.

Counterpart of videoitg_tpu/ops/flash_attention_short.py (`flash_mha_short`,
Pallas `_short_kernel`): non-causal, unmasked attention with equal q and kv
head counts, the exact softmax in fp32 (max, exp, sum, divide), P rounded to
the operand type before P V, fp32 accumulation. The kernel is
csrc/flash_attention_short.cu on the TMA + wgmma skeleton of
csrc/hopper_attention.cuh, hand-written for Hopper; its source note gives the
design. The TPU kernel's layout knobs (`kt`, `group`, `frames`) and its
experimental softmax arms are not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch

from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops._kernel_args import check_operands, stream_handle
from videoitg_tpu_torch.ops.attention import mha_reference


def flash_mha_short_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: the unmasked oracle (fp32 softmax,
    P rounded to v.dtype before P V)."""
    return mha_reference(q, k, v, sm_scale=sm_scale)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on shapes the kernel refuses: q, k, v not of one shape (MHA, no
    GQA), or B or H above 65535 (the kernel's grid)."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_mha_short: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must match (MHA, no GQA)")
    if q.shape[0] > 65535 or q.shape[1] > 65535:
        raise ValueError(f"flash_mha_short: B and H must be at most 65535, got {tuple(q.shape)}")


def flash_mha_short(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """q/k/v [B, H, S, D] -> [B, H, S, D] in q.dtype; `sm_scale` defaults to
    D**-0.5.

    CPU tensors run `flash_mha_short_reference`. CUDA tensors launch the
    kernel (bf16, contiguous, 16-byte aligned, D a multiple of 8 up to 128)
    or raise.
    """
    if q.device.type == "cpu":
        return flash_mha_short_reference(q, k, v, sm_scale=sm_scale)
    check_operands("flash_mha_short", q, k, v)
    check_shapes(q, k, v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.videoitg_flash_mha_short_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
        d ** -0.5 if sm_scale is None else sm_scale, stream_handle(q))
    _build.check(err, "flash_mha_short")
    flash_mha_short.launches += 1
    return out


flash_mha_short.launches = 0
