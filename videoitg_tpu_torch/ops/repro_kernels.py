"""The two one-line kernels of scripts/repro_pallas_interpret_vma.py on CUDA.

Counterparts of `kernel_literal` (o = x * 2.0) and `kernel_no_literal`
(o = x + x), which the JAX package keeps to reproduce a jax fault: Pallas
interpret mode fails the varying-axes check inside a partial-manual
`shard_map`. PyTorch has no counterpart of that fault; the port keeps the two
kernels (csrc/repro_kernels.cu), not the bug. scripts/torch_repro_kernels.py
launches both on the card and checks them bit-equal to each other and to
their plain versions.
"""

from __future__ import annotations

import torch

from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops._kernel_args import stream_handle


def double_literal_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version of `double_literal`."""
    return x * 2.0


def double_no_literal_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version of `double_no_literal`."""
    return x + x


def _launch(name: str, entry: str, x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor (or a CPU tensor for the plain "
                         f"version), got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous float32 tensor, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    if not 0 < x.numel() < 2 ** 31:
        raise ValueError(f"{name}: {x.numel()} elements")
    out = torch.empty_like(x)
    err = getattr(_build.library(), entry)(x.data_ptr(), out.data_ptr(), x.numel(),
                                           stream_handle(x))
    _build.check(err, name)
    return out


def double_literal(x: torch.Tensor) -> torch.Tensor:
    """x * 2.0f. CPU tensors run the plain version; CUDA tensors launch the
    kernel (fp32, contiguous) or raise."""
    if x.device.type == "cpu":
        return double_literal_reference(x)
    out = _launch("double_literal", "videoitg_double_literal_f32", x)
    double_literal.launches += 1
    return out


def double_no_literal(x: torch.Tensor) -> torch.Tensor:
    """x + x. CPU tensors run the plain version; CUDA tensors launch the
    kernel (fp32, contiguous) or raise."""
    if x.device.type == "cpu":
        return double_no_literal_reference(x)
    out = _launch("double_no_literal", "videoitg_double_no_literal_f32", x)
    double_no_literal.launches += 1
    return out


double_literal.launches = 0
double_no_literal.launches = 0
