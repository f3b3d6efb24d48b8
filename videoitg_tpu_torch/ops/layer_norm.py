"""Residual add + LayerNorm of a vision tower's bf16 stream in one kernel.

`add_layer_norm(x, delta, bias, ln, eps) -> (r, y)`:

  r = x + (delta + bias)   the new residual stream, each add rounded in x's
                           dtype (delta a product's output whose bias was held
                           back; bias may be None; with delta None, r is x)
  y = layer_norm(ln, r)    fp32 statistics, rounded once to x's dtype

It replaces no TPU kernel: the JAX package's LayerNorm and residual adds are
plain jnp (videoitg_tpu/models/common.py `layer_norm`), which XLA fuses on the
TPU. In PyTorch they are about ten full passes over the rows in fp32 a norm,
plus the bias and residual adds; csrc/layer_norm.cu does it in one read of x
and delta and one write of r and y, bound by those bytes.

The tower's inference loop (models/siglip.py, with `use_flash=True` and no
gradient) carries each product's output to the next norm through it. The plain version, `add_layer_norm_reference`,
is the tower's plain sequence itself (bias add, residual add,
`common.layer_norm`), so on the CPU the loop gives the plain loop's numbers
bit for bit. On the card r is bit-equal to it and y differs only by the
order of the fp32 sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from videoitg_tpu_torch.models.common import Norm, layer_norm
from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops._kernel_args import check_matrix, stream_handle

MAX_WIDTH = 2048  # widest row the kernel takes (a warp holds it in registers)


def residual_add(x: torch.Tensor, delta: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + (delta + bias), each add rounded in x's dtype: the residual of a
    linear whose bias was held back, as the plain tower adds it."""
    if bias is not None:
        delta = delta + bias
    return x + delta


def add_layer_norm_reference(x: torch.Tensor, delta: Optional[torch.Tensor],
                             bias: Optional[torch.Tensor], ln: Norm, eps: float):
    """Plain version of `add_layer_norm`: (r, y)."""
    if delta is not None:
        x = residual_add(x, delta, bias)
    return x, layer_norm(ln, x, eps)


def add_layer_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], ln: Norm, eps: float):
    """(r, y) as the module docstring says. x, delta: [..., H]; bias, ln's
    scale and bias: [H].

    CPU tensors run the plain version; CUDA tensors launch the kernel (every
    tensor bf16, contiguous and 16-byte aligned, H a multiple of 8 up to
    2048, bias only with delta) or raise.
    """
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, delta, bias, ln, eps)
    h = x.shape[-1]
    n = x.numel() // h if h else 0
    dev = x.device
    if n <= 0 or h % 8 or h > MAX_WIDTH:
        raise ValueError(f"add_layer_norm: {n} rows of H={h}; H must be a multiple of 8, at "
                         f"most {MAX_WIDTH}")
    if bias is not None and delta is None:
        raise ValueError("add_layer_norm: a bias comes with a delta")
    check_matrix("add_layer_norm", "x", x, torch.bfloat16, x.shape, dev)
    if delta is not None:
        check_matrix("add_layer_norm", "delta", delta, torch.bfloat16, x.shape, dev)
    check_matrix("add_layer_norm", "ln scale", ln.scale, torch.bfloat16, (h,), dev)
    check_matrix("add_layer_norm", "ln bias", ln.bias, torch.bfloat16, (h,), dev)
    if bias is not None:
        check_matrix("add_layer_norm", "bias", bias, torch.bfloat16, (h,), dev)
    r = torch.empty_like(x) if delta is not None else x
    y = torch.empty_like(x)
    _build.check(_build.library().videoitg_add_layer_norm_bf16(
        x.data_ptr(), delta.data_ptr() if delta is not None else None,
        bias.data_ptr() if bias is not None else None, ln.scale.data_ptr(), ln.bias.data_ptr(),
        r.data_ptr() if delta is not None else None, y.data_ptr(), n, h, float(eps),
        stream_handle(x)), "add_layer_norm")
    add_layer_norm.launches += 1
    return r, y


add_layer_norm.launches = 0
