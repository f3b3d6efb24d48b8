"""Streaming GQA attention for the grounding LM: CUDA kernel + plain version.

Counterpart of videoitg_tpu/ops/flash_attention.py (`flash_mha`, Pallas
`_flash_kernel`). The kernel is csrc/flash_attention.cu on the TMA + wgmma
skeleton of csrc/hopper_attention.cuh, hand-written for Hopper; its source
note gives the design. At the LM's 13k-token prefill a
plain implementation would materialise ~19 GB of fp32 scores per layer, so
on the card only the kernel runs.

Contract (shared with the plain version): q [B, Hq, S, D], k/v [B, Hkv, S, D],
`valid` [B, S] bool or None. Masked keys get exactly zero probability, rows
with no visible valid key output 0, invalid query rows output 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops._kernel_args import check_operands, stream_handle
from videoitg_tpu_torch.ops.attention import mha_reference


def flash_mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: the oracle with invalid query rows zeroed."""
    out = mha_reference(q, k, v, valid=valid, causal=causal)
    if valid is not None:
        out = out * valid[:, None, :, None].to(out.dtype)
    return out


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel refuses beyond `check_operands`: Hq not a
    multiple of Hkv, k / v not [B, Hkv, S, D], B or Hq above 65535 (the
    grid), B * S of 2^31 or more, a key mask that is not a contiguous bool
    [B, S] on q's device."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"flash_mha: Hq={hq} is not a multiple of Hkv={hkv}")
    if k.shape != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"flash_mha: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if b > 65535 or hq > 65535 or b * s >= 2 ** 31:
        raise ValueError(f"flash_mha: q {tuple(q.shape)} is beyond the kernel's grid "
                         f"(B, Hq <= 65535, B * S < 2^31)")
    if valid is not None:
        if (valid.dtype != torch.bool or valid.shape != (b, s)
                or valid.device != q.device or not valid.is_contiguous()):
            raise ValueError("flash_mha: valid must be a contiguous bool [B, S] "
                             "tensor on q's device")


def flash_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Streaming attention. Returns [B, Hq, S, D] in q.dtype.

    CPU tensors run `flash_mha_reference`. CUDA tensors launch the kernel
    (bf16, contiguous, 16-byte aligned, D a multiple of 8 up to 128) or
    raise.
    """
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, valid=valid, causal=causal)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    check_operands("flash_mha", q, k, v)
    check_shapes(q, k, v, valid)
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.videoitg_flash_mha_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        b, hq, hkv, s, d, int(causal), d ** -0.5, stream_handle(q))
    _build.check(err, "flash_mha")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
