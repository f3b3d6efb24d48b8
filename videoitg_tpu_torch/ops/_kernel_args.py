"""Checks shared by the kernel wrappers before a pointer reaches CUDA."""

from __future__ import annotations

import torch


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte-aligned bf16 CUDA
    tensor on one device with a head dim the kernels take (multiple of 8, at
    most 128)."""
    device = tensors[0].device
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: needs CUDA tensors (or CPU tensors for the "
                             f"plain version), got {x.device}")
        if x.device != device:
            raise ValueError(f"{name}: tensors on {device} and {x.device}")
    check_layout(name, *tensors)


def check_layout(name: str, *tensors: torch.Tensor) -> None:
    """The device-independent half of `check_operands`: bf16, [B, H, S, D],
    contiguous, 16-byte-aligned base (a TMA tensor map needs it), head dim a
    multiple of 8 up to 128."""
    for x in tensors:
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name}: expects [B, H, S, D], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    d = tensors[0].shape[-1]
    if d % 8 or d > 128:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8 and at most 128")


def stream_handle(x: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on x's device."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check_matrix(name: str, what: str, x: torch.Tensor, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """Raise unless x is a contiguous, 16-byte-aligned CUDA tensor of the
    given dtype and shape on `device`."""
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name}: {what} must lie on {device} (a CUDA device), got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: {what} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be 16-byte aligned")
