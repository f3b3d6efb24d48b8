"""act8 linear: dynamic activation quantisation and an int8 GEMM.

Counterpart of videoitg_tpu/ops/quant_gemm.py (`act8_gemm`, Pallas `_kernel`).
The kernel is csrc/quant_gemm.cu, hand-written for Hopper, in two launches:
`row_quant_kernel` reads x once in bf16 and writes its int8 copy
(`round(x / x_scale)` clipped to +-127) and, unless the caller gives it, the
row scale (`amax / 127`, 1 for a zero row); then a TMA + s8 wgmma GEMM
(csrc/hopper_int8_gemm.cuh) runs int8 x int8 on the tensor cores with an
exact int32 sum, and its epilogue applies `(acc * x_scale) * w_scale`.

`act8_gemm_reference` repeats that arithmetic in plain PyTorch with an exact
integer product; the CPU tests use it, and hold the two launches' plain
versions (`row_quant_reference`, `act8_gemm_s8_reference`) to it. The first
launch, `row_quant_int8`, is also kernel I's first
(ops/fused_encoder.fused_proj_residual_int8). Served behind
`Act8Switches.qgemm` (VIDEOITG_QGEMM=1) through ops/quant.quantized_linear.
"""

from __future__ import annotations

import torch

from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops._kernel_args import check_matrix, stream_handle
from videoitg_tpu_torch.ops.quant import QuantLinear, int8_matmul, row_scale_of

# The block sizes of the TPU kernel decide which linears it serves
# (`shapes_supported`); the port keeps the rule so both packages route alike.
BLOCK_N = 512
BLOCK_K = 512


def row_scale(x2: torch.Tensor) -> torch.Tensor:
    """[M, K] -> fp32 [M, 1] row scales: amax / 127, 1 for a zero row
    (`ops/quant.row_scale_of`)."""
    amax = torch.linalg.vector_norm(x2, ord=float("inf"), dim=-1, keepdim=True,
                                    dtype=torch.float32)
    return row_scale_of(amax)


def quantize_rows(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """round(x / x_scale) clipped to +-127, as int8."""
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127).to(torch.int8)


def act8_gemm_reference(x: torch.Tensor, x_scale, w_qt: torch.Tensor,
                        w_scale: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The kernel's plain PyTorch version: (quant(x) @ w_q) * x_scale * w_scale,
    with `row_scale(x)` where x_scale is None."""
    if x_scale is None:
        x_scale = row_scale(x)
    acc = int8_matmul(quantize_rows(x, x_scale), w_qt)
    return (acc.float() * x_scale * w_scale).to(out_dtype or x.dtype)


def row_quant_reference(x: torch.Tensor, x_scale=None):
    """Plain version of the first launch: (int8 x_q [M, K], fp32 x_scale
    [M, 1]), the scale made from x where none is given."""
    if x_scale is None:
        x_scale = row_scale(x)
    return quantize_rows(x, x_scale), x_scale


def act8_gemm_s8_reference(x_q: torch.Tensor, x_scale: torch.Tensor, w_qt: torch.Tensor,
                           w_scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """Plain version of the second launch: the GEMM's `Act8Out` epilogue."""
    return (int8_matmul(x_q, w_qt).float() * x_scale * w_scale).to(out_dtype)


def row_quant_int8(x: torch.Tensor, x_scale=None):
    """The first launch, `row_quant_kernel`: x bf16 [M, K] -> (int8 x_q
    [M, K], fp32 x_scale [M, 1]), the scale made from x where none is given.
    Kernel I (ops/fused_encoder.py) starts with it too.

    CPU tensors run `row_quant_reference`. CUDA tensors launch the kernel
    (K a multiple of 16) or raise.
    """
    if x.device.type == "cpu":
        return row_quant_reference(x, x_scale)
    m, k = x.shape
    dev = x.device
    check_matrix("row_quant_int8", "x", x, torch.bfloat16, (m, k), dev)
    if x_scale is not None:
        check_matrix("row_quant_int8", "x_scale", x_scale, torch.float32, (m, 1), dev)
    if m <= 0 or k % 16:
        raise ValueError(f"row_quant_int8: M={m}, K={k}: K must be a multiple of 16")
    x_q = torch.empty((m, k), device=dev, dtype=torch.int8)
    made = x_scale is None
    if made:
        x_scale = torch.empty((m, 1), device=dev, dtype=torch.float32)
    _build.check(_build.library().videoitg_row_quant_int8_bf16(
        x.data_ptr(), x_scale.data_ptr(), x_q.data_ptr(), m, k, int(made), stream_handle(x)),
        "row_quant_int8")
    return x_q, x_scale


def act8_gemm(x: torch.Tensor, x_scale, w_qt: torch.Tensor,
              w_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K]; x_scale fp32 [M, 1], or None to make it from x (`row_scale`);
    w_qt int8 [N, K]; w_scale fp32 [N]. Returns [M, N] in x.dtype.

    CPU tensors run `act8_gemm_reference`. CUDA tensors launch the kernel's
    two launches (bf16 x, K a multiple of 16, N a multiple of 8) or raise.
    """
    if x.device.type == "cpu":
        return act8_gemm_reference(x, x_scale, w_qt, w_scale)
    m, k = x.shape
    n = w_qt.shape[0]
    dev = x.device
    check_matrix("act8_gemm", "x", x, torch.bfloat16, (m, k), dev)
    check_matrix("act8_gemm", "w_qt", w_qt, torch.int8, (n, k), dev)
    check_matrix("act8_gemm", "w_scale", w_scale, torch.float32, (n,), dev)
    if m <= 0 or k % 16 or n % 8:
        raise ValueError(f"act8_gemm: M={m}, K={k}, N={n}: K must be a multiple of 16 "
                         "and N of 8")
    x_q, x_scale = row_quant_int8(x, x_scale)
    out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    _build.check(_build.library().videoitg_act8_gemm_s8(
        x_q.data_ptr(), x_scale.data_ptr(), w_qt.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        m, k, n, stream_handle(x)), "act8_gemm")
    act8_gemm.launches += 1
    return out


act8_gemm.launches = 0


def act8_linear(lin: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for the act_q arm of ops/quant.quantized_linear on [*, K]
    inputs. The row scales follow `ops/quant.row_quant`'s formula and are
    made by the kernel; the bias is added outside it in the output dtype."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    y = act8_gemm(x2, None, lin.w_qt, lin.scale)
    y = y.reshape(*x.shape[:-1], lin.out_features)
    if lin.b is not None:
        y = y + lin.b
    return y


def shapes_supported(lin, x=None) -> bool:
    """True for an int8 linear whose K and N divide the TPU kernel's blocks
    (every LM linear of the 8B model does; the tower's 1152 and the tiny test
    configurations do not and take the library product)."""
    if not isinstance(lin, QuantLinear) or lin.bits != 8:
        return False
    n, k = lin.w_qt.shape
    return k % BLOCK_K == 0 and n % BLOCK_N == 0
