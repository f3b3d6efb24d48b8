"""Fused encoder-layer kernels for the full-int8 (act8) serving tier.

Counterpart of videoitg_tpu/ops/fused_encoder.py. Each function keeps a whole
non-attention sub-block of a vision encoder layer in hand-written Hopper
kernels (csrc/fused_encoder.cu), so the LayerNorm output and the
[rows, intermediate] MLP tensor never go to device memory in bf16 or fp32.
Every product runs on the TMA + s8 wgmma GEMM (csrc/hopper_int8_gemm.cuh)
after a launch that quantises the rows once:

  * fused_ln_qkv_int8:        LN -> per-row int8 quant -> one packed
                              [H, dq+dk+dv] int8 product -> scale + bias ->
                              three dense outputs q, k, v, in two launches
                              (`ln_row_quant`, `qkv_project`).
  * fused_ln_mlp_int8:        LN -> quant -> fc1 -> GELU -> quant of the
                              whole intermediate row -> fc2 -> + residual,
                              in four launches (`ln_row_quant`,
                              `mlp_fc1_amax`, `mlp_fc1_quant`,
                              `mlp_fc2_residual`) through int8 copies of
                              the two activations.
  * fused_proj_residual_int8: quant -> o_proj -> + residual, in two launches
                              (`ops/quant_gemm.row_quant_int8`, kernel F's
                              row quantisation, then `proj_residual`).

All work is row-local (LN statistics, per-row scales), so a ragged last row
tile is masked in the kernels. Numerics: fp32 LN (two-pass) and scales,
exact int32 sums, activations quantised from the fp32 LN / GELU values,
`acc * (row_scale * w_scale) + b` in fp32 before the cast.

Beside each kernel and each launch its plain PyTorch version
(`*_reference`) repeats the arithmetic with an exact integer product; the
CPU tests use them. Served behind `Act8Switches.fused` (VIDEOITG_FUSED=1)
in models/siglip.py.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from videoitg_tpu_torch.models.common import Norm
from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops._kernel_args import check_matrix, stream_handle
from videoitg_tpu_torch.ops.quant import QuantLinear, int8_matmul, row_quant, row_scale_of
from videoitg_tpu_torch.ops.quant_gemm import row_quant_int8

ACTIVATIONS = ("gelu_tanh", "quick_gelu")
MAX_ROW_WIDTH = 2048  # widest row `ln_row_quant` takes (a warp holds it in registers)


def _layer_norm_f32(x: torch.Tensor, ln: Norm, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) * (x - mean)).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * ln.scale.float() + ln.bias.float()


def _activation_f32(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu_tanh":
        return F.gelu(h, approximate="tanh")
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    raise ValueError(f"unknown activation {act!r} (one of {ACTIVATIONS})")


def _vec(a, n: int, device) -> torch.Tensor:
    """A bias as an fp32 [n] vector (zeros when absent)."""
    if a is None:
        return torch.zeros(n, device=device, dtype=torch.float32)
    return a.detach().float().contiguous()


def _scaled(acc: torch.Tensor, row_scale: torch.Tensor, lin_scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    return acc.float() * (row_scale * lin_scale) + bias


def _check_int8(name: str, *lins) -> None:
    for lin in lins:
        if not isinstance(lin, QuantLinear) or lin.bits != 8:
            raise ValueError(f"{name}: every linear must be an int8 QuantLinear")


def fused_ln_qkv_int8_reference(x, ln: Norm, q_lin, k_lin, v_lin, eps: float):
    """Plain version of `fused_ln_qkv_int8`."""
    yq, ys = row_quant(_layer_norm_f32(x.float(), ln, eps))
    out = []
    for lin in (q_lin, k_lin, v_lin):
        h = _scaled(int8_matmul(yq, lin.w_qt), ys, lin.scale,
                    _vec(lin.b, lin.out_features, x.device))
        out.append(h.to(x.dtype))
    return tuple(out)


# ---- the row quantisation with LN: launch 1 of G and of H ----


def ln_row_quant_reference(x, ln: Norm, eps: float):
    """Plain version of `ln_row_quant`: (int8 yq [N, H], fp32 ys [N, 1])."""
    return row_quant(_layer_norm_f32(x.float(), ln, eps))


def ln_row_quant(x: torch.Tensor, ln: Norm, eps: float):
    """LN + per-row int8 quantisation, `ln_quant_kernel`. x: bf16 [N, H] ->
    (yq, ys)."""
    if x.device.type == "cpu":
        return ln_row_quant_reference(x, ln, eps)
    n, h = x.shape
    dev = x.device
    check_matrix("ln_row_quant", "x", x, torch.bfloat16, (n, h), dev)
    if n <= 0 or h % 16 or h > MAX_ROW_WIDTH:
        raise ValueError(f"ln_row_quant: H={h} must be a multiple of 16, at most "
                         f"{MAX_ROW_WIDTH}")
    lns, lnb = _vec(ln.scale, h, dev), _vec(ln.bias, h, dev)
    yq = torch.empty((n, h), device=dev, dtype=torch.int8)
    ys = torch.empty((n, 1), device=dev, dtype=torch.float32)
    _build.check(_build.library().videoitg_ln_row_quant_int8_bf16(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), yq.data_ptr(), ys.data_ptr(), n, h,
        float(eps), stream_handle(x)), "ln_row_quant")
    return yq, ys


# ---- G's launch 2, beside its plain version ----


def _packed_qkv(q_lin, k_lin, v_lin, device):
    """The three int8 linears packed along the output axis, as the JAX
    package packs them on every call: (w [dq+dk+dv, H], s, b)."""
    lins = (q_lin, k_lin, v_lin)
    return (torch.cat([lin.w_qt for lin in lins], dim=0),
            torch.cat([lin.scale for lin in lins]),
            torch.cat([_vec(lin.b, lin.out_features, device) for lin in lins]))


def qkv_project_reference(yq, ys, q_lin, k_lin, v_lin, dtype):
    """Plain version of `qkv_project`: the packed product, scaled and
    biased, split into (q, k, v) at the kernel's column offsets."""
    w, s, b = _packed_qkv(q_lin, k_lin, v_lin, yq.device)
    h = _scaled(int8_matmul(yq, w), ys, s, b).to(dtype)
    dq, dk = q_lin.out_features, k_lin.out_features
    return h[:, :dq].contiguous(), h[:, dq:dq + dk].contiguous(), h[:, dq + dk:].contiguous()


def qkv_project(yq: torch.Tensor, ys: torch.Tensor, q_lin: QuantLinear, k_lin: QuantLinear,
                v_lin: QuantLinear, dtype: torch.dtype = torch.bfloat16):
    """G's launch 2: the packed QKV product with the `QkvOut` epilogue ->
    (q [N, dq], k [N, dk], v [N, dv]) in `dtype` (the kernel's is bf16)."""
    if yq.device.type == "cpu":
        return qkv_project_reference(yq, ys, q_lin, k_lin, v_lin, dtype)
    n, h = yq.shape
    dev = yq.device
    dq, dk, dv = q_lin.out_features, k_lin.out_features, v_lin.out_features
    check_matrix("fused_ln_qkv_int8", "yq", yq, torch.int8, (n, h), dev)
    check_matrix("fused_ln_qkv_int8", "ys", ys, torch.float32, (n, 1), dev)
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_ln_qkv_int8: the kernel writes bfloat16, not {dtype}")
    if h % 16 or dq % 8 or dk % 8 or dv % 8:
        raise ValueError(f"fused_ln_qkv_int8: H={h} must be a multiple of 16 and dq, dk, dv = "
                         f"{dq}, {dk}, {dv} multiples of 8")
    w, s, b = _packed_qkv(q_lin, k_lin, v_lin, dev)
    check_matrix("fused_ln_qkv_int8", "packed weight", w, torch.int8, (dq + dk + dv, h), dev)
    check_matrix("fused_ln_qkv_int8", "packed scale", s, torch.float32, (dq + dk + dv,), dev)
    q = torch.empty((n, dq), device=dev, dtype=torch.bfloat16)
    k = torch.empty((n, dk), device=dev, dtype=torch.bfloat16)
    v = torch.empty((n, dv), device=dev, dtype=torch.bfloat16)
    _build.check(_build.library().videoitg_qkv_gemm_s8(
        yq.data_ptr(), ys.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), n, h, dq, dk, dv, stream_handle(yq)),
        "fused_ln_qkv_int8 (QKV product)")
    return q, k, v


def fused_ln_qkv_int8(x: torch.Tensor, ln: Norm, q_lin: QuantLinear, k_lin: QuantLinear,
                      v_lin: QuantLinear, eps: float):
    """LN + dynamic int8 quant + packed QKV product. x: [N, H]. Returns
    (q [N, dq], k [N, dk], v [N, dv]) in x.dtype. The three int8 weights are
    packed along the output axis on every call (4 MB at the SigLIP shape).

    CPU tensors run the plain version; CUDA tensors launch the kernel's two
    launches, `ln_row_quant` and `qkv_project` (bf16, H a multiple of 16 up
    to 2048, dq, dk, dv multiples of 8), or raise.
    """
    _check_int8("fused_ln_qkv_int8", q_lin, k_lin, v_lin)
    if x.device.type == "cpu":
        return fused_ln_qkv_int8_reference(x, ln, q_lin, k_lin, v_lin, eps)
    yq, ys = ln_row_quant(x, ln, eps)
    out = qkv_project(yq, ys, q_lin, k_lin, v_lin)
    fused_ln_qkv_int8.launches += 1
    return out


fused_ln_qkv_int8.launches = 0


def fused_ln_mlp_int8_reference(x, ln: Norm, fc1, fc2, eps: float, act: str = "gelu_tanh"):
    """Plain version of `fused_ln_mlp_int8`."""
    xf = x.float()
    yq, ys = row_quant(_layer_norm_f32(xf, ln, eps))
    h = _scaled(int8_matmul(yq, fc1.w_qt), ys, fc1.scale,
                _vec(fc1.b, fc1.out_features, x.device))
    gq, gs = row_quant(_activation_f32(h, act))
    o = _scaled(int8_matmul(gq, fc2.w_qt), gs, fc2.scale,
                _vec(fc2.b, fc2.out_features, x.device))
    return (xf + o).to(x.dtype)


# ---- H's launches 2 to 4, each beside its plain version (launch 1 is
# `ln_row_quant`) ----
# The kernel computes fc1 twice: once for each row's amax (reduced over the
# GEMM's n tiles), once to quantise with the full row's scale. The stage
# functions take the plain version for CPU tensors and launch the kernel for
# CUDA tensors; `fused_ln_mlp_int8` chains them.
FC1_TILE = 256  # columns of one fc1 tile of the kernel, where the broken-use checks cut


def _fc1_act(yq, ys, fc1, act: str) -> torch.Tensor:
    h = _scaled(int8_matmul(yq, fc1.w_qt), ys, fc1.scale,
                _vec(fc1.b, fc1.out_features, yq.device))
    return _activation_f32(h, act)


def mlp_fc1_amax_reference(yq, ys, fc1, act: str) -> torch.Tensor:
    """Launch 2's plain version: each row's max |act(fc1)|, fp32 [N] (the
    kernel takes it per n tile, then over the tiles: max has no order)."""
    return _fc1_act(yq, ys, fc1, act).abs().amax(dim=-1)


def mlp_fc1_quant_reference(yq, ys, fc1, amax, act: str) -> torch.Tensor:
    """Launch 3's plain version: act(fc1) quantised with the scale of the
    full row's amax, int8 [N, M]."""
    g = _fc1_act(yq, ys, fc1, act)
    return torch.clamp(torch.round(g / row_scale_of(amax[:, None])), -127, 127).to(torch.int8)


def mlp_fc2_residual_reference(x, gq, amax, fc2) -> torch.Tensor:
    """Launch 4's plain version: x + fc2(gq) in x.dtype."""
    o = _scaled(int8_matmul(gq, fc2.w_qt), row_scale_of(amax[:, None]), fc2.scale,
                _vec(fc2.b, fc2.out_features, x.device))
    return (x.float() + o).to(x.dtype)


def _run(err: int, what: str) -> None:
    _build.check(err, f"fused_ln_mlp_int8 ({what})")


def _fc1_args(yq, ys, fc1):
    """Checks and pointers of fc1's two launches; the fp32 bias is returned
    too, so that the caller holds it until its launch is enqueued."""
    n, h = yq.shape
    m = fc1.out_features
    dev = yq.device
    check_matrix("fused_ln_mlp_int8", "yq", yq, torch.int8, (n, h), dev)
    check_matrix("fused_ln_mlp_int8", "ys", ys, torch.float32, (n, 1), dev)
    check_matrix("fused_ln_mlp_int8", "fc1 weight", fc1.w_qt, torch.int8, (m, h), dev)
    check_matrix("fused_ln_mlp_int8", "fc1 scale", fc1.scale, torch.float32, (m,), dev)
    if m % 16:
        raise ValueError(f"fused_ln_mlp_int8: M={m} must be a multiple of 16")
    b1 = _vec(fc1.b, m, dev)
    return (yq.data_ptr(), ys.data_ptr(), fc1.w_qt.data_ptr(), fc1.scale.data_ptr(),
            b1.data_ptr()), (n, h, m), b1


def mlp_fc1_amax(yq: torch.Tensor, ys: torch.Tensor, fc1: QuantLinear, act: str):
    """Launch 2: fc1 with the `RowAmax` epilogue -> fp32 [N] row amax."""
    if yq.device.type == "cpu":
        return mlp_fc1_amax_reference(yq, ys, fc1, act)
    ptrs, (n, h, m), _b1 = _fc1_args(yq, ys, fc1)
    amax = torch.zeros(n, device=yq.device, dtype=torch.float32)
    _run(_build.library().videoitg_mlp_fc1_amax_s8(
        *ptrs, amax.data_ptr(), n, h, m, ACTIVATIONS.index(act), stream_handle(yq)), "fc1 amax")
    return amax


def mlp_fc1_quant(yq: torch.Tensor, ys: torch.Tensor, fc1: QuantLinear, amax: torch.Tensor,
                  act: str) -> torch.Tensor:
    """Launch 3: fc1 again with the `QuantStore` epilogue -> int8 [N, M]."""
    if yq.device.type == "cpu":
        return mlp_fc1_quant_reference(yq, ys, fc1, amax, act)
    ptrs, (n, h, m), _b1 = _fc1_args(yq, ys, fc1)
    check_matrix("fused_ln_mlp_int8", "amax", amax, torch.float32, (n,), yq.device)
    gq = torch.empty((n, m), device=yq.device, dtype=torch.int8)
    _run(_build.library().videoitg_mlp_fc1_quant_s8(
        *ptrs, amax.data_ptr(), gq.data_ptr(), n, h, m, ACTIVATIONS.index(act),
        stream_handle(yq)), "fc1 quantise")
    return gq


def mlp_fc2_residual(x: torch.Tensor, gq: torch.Tensor, amax: torch.Tensor,
                     fc2: QuantLinear) -> torch.Tensor:
    """Launch 4: fc2 with the `BiasResidual` epilogue -> [N, H] in x.dtype."""
    if x.device.type == "cpu":
        return mlp_fc2_residual_reference(x, gq, amax, fc2)
    n, h = x.shape
    m = gq.shape[1]
    dev = x.device
    check_matrix("fused_ln_mlp_int8", "x", x, torch.bfloat16, (n, h), dev)
    check_matrix("fused_ln_mlp_int8", "gq", gq, torch.int8, (n, m), dev)
    check_matrix("fused_ln_mlp_int8", "amax", amax, torch.float32, (n,), dev)
    check_matrix("fused_ln_mlp_int8", "fc2 weight", fc2.w_qt, torch.int8, (h, m), dev)
    check_matrix("fused_ln_mlp_int8", "fc2 scale", fc2.scale, torch.float32, (h,), dev)
    if h % 16 or m % 16:
        raise ValueError(f"fused_ln_mlp_int8: H={h} and M={m} must be multiples of 16")
    b2 = _vec(fc2.b, h, dev)
    out = torch.empty_like(x)
    _run(_build.library().videoitg_mlp_fc2_residual_s8(
        gq.data_ptr(), amax.data_ptr(), fc2.w_qt.data_ptr(), fc2.scale.data_ptr(),
        b2.data_ptr(), x.data_ptr(), out.data_ptr(), n, m, h, stream_handle(x)), "fc2")
    return out


def fused_ln_mlp_int8(x: torch.Tensor, ln: Norm, fc1: QuantLinear, fc2: QuantLinear,
                      eps: float, act: str = "gelu_tanh") -> torch.Tensor:
    """x + fc2(act(fc1(quant(LN(x))))) with the intermediate quantised to int8
    before it reaches device memory. x: [N, H]. Returns [N, H] in x.dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel's four
    launches (bf16, H a multiple of 16 up to 2048, M a multiple of 16) or
    raise.
    """
    _check_int8("fused_ln_mlp_int8", fc1, fc2)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r} (one of {ACTIVATIONS})")
    if x.device.type == "cpu":
        return fused_ln_mlp_int8_reference(x, ln, fc1, fc2, eps, act)
    yq, ys = ln_row_quant(x, ln, eps)
    amax = mlp_fc1_amax(yq, ys, fc1, act)
    gq = mlp_fc1_quant(yq, ys, fc1, amax, act)
    out = mlp_fc2_residual(x, gq, amax, fc2)
    fused_ln_mlp_int8.launches += 1
    return out


fused_ln_mlp_int8.launches = 0


def fused_proj_residual_int8_reference(attn, residual, o_lin):
    """Plain version of `fused_proj_residual_int8`."""
    aq, a_scale = row_quant(attn.float())
    o = _scaled(int8_matmul(aq, o_lin.w_qt), a_scale, o_lin.scale,
                _vec(o_lin.b, o_lin.out_features, attn.device))
    return (residual.float() + o).to(residual.dtype)


# ---- I's launch 2, beside its plain version (launch 1 is kernel F's row
# quantisation, `ops/quant_gemm.row_quant_int8`) ----


def proj_residual_reference(aq, a_scale, residual, o_lin) -> torch.Tensor:
    """Plain version of `proj_residual`: residual + o_proj(aq) in
    residual.dtype."""
    o = _scaled(int8_matmul(aq, o_lin.w_qt), a_scale, o_lin.scale,
                _vec(o_lin.b, o_lin.out_features, aq.device))
    return (residual.float() + o).to(residual.dtype)


def proj_residual(aq: torch.Tensor, a_scale: torch.Tensor, residual: torch.Tensor,
                  o_lin: QuantLinear) -> torch.Tensor:
    """I's launch 2: o_proj with the `BiasResidual` epilogue, the row scale
    as launch 1 wrote it. aq: int8 [N, D], a_scale: fp32 [N, 1], residual:
    bf16 [N, H] -> [N, H]."""
    if aq.device.type == "cpu":
        return proj_residual_reference(aq, a_scale, residual, o_lin)
    n, d = aq.shape
    h = o_lin.out_features
    dev = aq.device
    check_matrix("fused_proj_residual_int8", "aq", aq, torch.int8, (n, d), dev)
    check_matrix("fused_proj_residual_int8", "a_scale", a_scale, torch.float32, (n, 1), dev)
    check_matrix("fused_proj_residual_int8", "residual", residual, torch.bfloat16, (n, h), dev)
    check_matrix("fused_proj_residual_int8", "o weight", o_lin.w_qt, torch.int8, (h, d), dev)
    check_matrix("fused_proj_residual_int8", "o scale", o_lin.scale, torch.float32, (h,), dev)
    if d % 16 or h % 8:
        raise ValueError(f"fused_proj_residual_int8: D={d} must be a multiple of 16 and H={h} "
                         "of 8")
    b = _vec(o_lin.b, h, dev)
    out = torch.empty_like(residual)
    _build.check(_build.library().videoitg_proj_residual_s8(
        aq.data_ptr(), a_scale.data_ptr(), o_lin.w_qt.data_ptr(), o_lin.scale.data_ptr(),
        b.data_ptr(), residual.data_ptr(), out.data_ptr(), n, d, h, stream_handle(aq)),
        "fused_proj_residual_int8 (o_proj)")
    return out


def fused_proj_residual_int8(attn: torch.Tensor, residual: torch.Tensor,
                             o_lin: QuantLinear) -> torch.Tensor:
    """residual + o_proj(quant(attn)). attn: [N, D], residual: [N, H].

    CPU tensors run the plain version; CUDA tensors launch the kernel's two
    launches, `ops/quant_gemm.row_quant_int8` and `proj_residual` (bf16, D a
    multiple of 16, H a multiple of 8), or raise.
    """
    _check_int8("fused_proj_residual_int8", o_lin)
    if attn.device.type == "cpu":
        return fused_proj_residual_int8_reference(attn, residual, o_lin)
    aq, a_scale = row_quant_int8(attn)
    out = proj_residual(aq, a_scale, residual, o_lin)
    fused_proj_residual_int8.launches += 1
    return out


fused_proj_residual_int8.launches = 0


def can_fuse_encoder_layer(layer) -> bool:
    """True when every encoder-layer linear is int8 with act_q: the exact
    configuration the act8 serving tier produces. (LoRA adapters, which the
    JAX package also excludes, are not ported.)"""
    def ok(lin):
        return isinstance(lin, QuantLinear) and lin.bits == 8 and lin.act_q

    return all(ok(getattr(layer, k, None)) for k in ("q", "k", "v", "o", "fc1", "fc2"))
