"""Shared building blocks of the model stack.

Counterpart of videoitg_tpu/models/common.py. Dense linear weights keep the
JAX package's [in, out] layout (`x @ w`), so the weight bridge (checkpoint.py)
copies them without a transpose and the tests compare like with like; the
quantised forms live in ops/quant.py and `linear` dispatches on the form.
Norm statistics and RoPE angles are fp32 whatever the compute dtype.

Every parameter is built with `requires_grad=False` (the serving state); the
optimizer factories of train/ turn gradients on for the leaves that train.
A dense `Linear` or a `QuantLinear` may carry a LoRA adapter (`lora_a`
[in, r], `lora_b` [r, out], `lora_scale` [], set by train/lora.add_lora):
`linear` then adds `((x @ a) @ b) * scale`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from videoitg_tpu_torch.utils import profiling


def new_param(shape, device, dtype, generator: Optional[torch.Generator], std: float):
    """A parameter tensor: N(0, std^2) from `generator`, or uninitialised."""
    x = torch.empty(shape, device=device, dtype=torch.float32 if generator is not None else dtype)
    if generator is not None:
        x.normal_(0.0, std, generator=generator)
        x = x.to(dtype)
    return nn.Parameter(x, requires_grad=False)


class Linear(nn.Module):
    """Dense layer `x @ w + b` with w [in, out].

    With a generator the weights are N(0, 1/in) and the bias zero, the
    distributions of the JAX package's `init_linear`; without one they are
    left uninitialised for a checkpoint to fill.
    """

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = new_param((d_in, d_out), device, dtype, generator, d_in ** -0.5)
        self.b = (nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype),
                               requires_grad=False) if bias else None)
        init_lora_slots(self)


LORA_KEYS = ("lora_a", "lora_b", "lora_scale")


def init_lora_slots(lin: nn.Module) -> None:
    """Empty adapter slots on a linear (absent from its state dict until set)."""
    for key in LORA_KEYS:
        lin.register_parameter(key, None)


def set_lora(lin: nn.Module, lora_a: torch.Tensor, lora_b: torch.Tensor,
             lora_scale: torch.Tensor) -> None:
    """Attach a LoRA adapter to a dense or quantised linear. All three leaves
    are parameters, `lora_scale` too: the JAX package trains every `lora_*`
    leaf, and the training trajectories are held to it."""
    for key, value in zip(LORA_KEYS, (lora_a, lora_b, lora_scale)):
        setattr(lin, key, nn.Parameter(value, requires_grad=False))


def clear_lora(lin: nn.Module) -> None:
    for key in LORA_KEYS:
        setattr(lin, key, None)


def has_lora(lin: nn.Module) -> bool:
    return lin.lora_a is not None


def _lora_delta(p, x: torch.Tensor) -> torch.Tensor:
    """((x @ a) @ b) * scale in the adapter's dtype: a bf16 x is cast up to
    fp32 adapters (the promotion the JAX package gets implicitly); the caller
    casts the delta back to the output's dtype."""
    delta = (x.to(p.lora_a.dtype) @ p.lora_a) @ p.lora_b
    return delta * p.lora_scale.to(delta.dtype)


def linear_span(m: int, k: int, n: int, kind: str):
    """The tracer's `linear` span of an [m, k] x [k, n] product: its
    operations, 2 m k n, and its kind, "int8" for a product of int8
    activations or "bf16" for one in floating point, whatever kernel runs it."""
    return profiling.span("linear", ops=2.0 * m * k * n, kind=kind)


def linear(p, x: torch.Tensor, act8=None) -> torch.Tensor:
    """x @ w (+ b) for a dense `Linear`; an int8 / int4 `QuantLinear`
    (ops/quant.py) goes to `quantized_linear`, with the act8 kernel switches.
    A LoRA delta is added before the bias of a dense linear and after the
    quantised product (QLoRA). A linear split over a tensor-parallel mesh
    (it carries a `tp` marker, parallel/sharding.py) runs its slice and its
    collective in parallel/tensor.py. Traced, the call is a `linear` span
    counting this rank's product."""
    if profiling.tracing:
        k = x.shape[-1]
        with linear_span(x.numel() // k, k, _out_features(p), _kind(p)):
            return _linear(p, x, act8)
    return _linear(p, x, act8)


def linear_held_bias(p, x: torch.Tensor, act8=None):
    """`linear` with the bias held back for a later pass to add: (x @ w, b)
    for a plain dense `Linear` (no LoRA adapter, no `tp` marker); any other
    form gives (linear(p, x, act8), None), its bias added. Traced, the
    product is a `linear` span as in `linear`."""
    if not isinstance(p, Linear) or p.lora_a is not None or getattr(p, "tp", None) is not None:
        return linear(p, x, act8), None
    if profiling.tracing:
        k = x.shape[-1]
        with linear_span(x.numel() // k, k, _out_features(p), _kind(p)):
            return x @ p.w, p.b
    return x @ p.w, p.b


def _out_features(p) -> int:
    return p.w.shape[-1] if isinstance(p, Linear) else p.out_features


def _kind(p) -> str:
    return "int8" if getattr(p, "act_q", False) else "bf16"


def _linear(p, x: torch.Tensor, act8) -> torch.Tensor:
    if getattr(p, "tp", None) is not None:
        from videoitg_tpu_torch.parallel.tensor import tp_linear

        return tp_linear(p, x, act8)
    if not isinstance(p, Linear):
        from videoitg_tpu_torch.ops.quant import Act8Switches, quantized_linear

        y = quantized_linear(p, x, act8 if act8 is not None else Act8Switches())
        if p.lora_a is not None:
            y = y + _lora_delta(p, x).to(y.dtype)
        return y
    y = x @ p.w
    if p.lora_a is not None:
        y = y + _lora_delta(p, x).to(y.dtype)
    if p.b is not None:
        y = y + p.b
    return y


class Norm(nn.Module):
    """Scale (and, for LayerNorm, bias) of a norm layer: ones and zeros."""

    def __init__(self, dim: int, bias: bool, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(dim, device=device, dtype=dtype),
                                  requires_grad=False) if bias else None)


def rms_norm(p: Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics (Qwen2 semantics)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * p.scale.float()).to(x.dtype)


def layer_norm(p: Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics (SigLIP semantics)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * p.scale.float() + p.bias.float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu_pytorch_tanh — SigLIP's activation."""
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The erf GELU — the seq_mlp projector's activation."""
    return F.gelu(x)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies, fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, NeoX/Qwen2 'rotate_half' convention.

    x: [B, H, S, D]; positions: [B, S] integer. Angles and the rotation are
    fp32; the result is cast back to x.dtype.
    """
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, device=x.device)
    angles = positions.float()[:, :, None] * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, None]  # [B, 1, S, D/2]
    sin = torch.sin(angles)[:, None]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def fused_qkv(p_q, p_k, p_v, x: torch.Tensor, act8=None):
    """q/k/v projections as one GEMM over concatenated weight columns
    (exact: concatenation commutes with the matmul). Three separate linears
    when any of them is quantised or carries a LoRA adapter. Column-parallel
    slices (tp) concatenate as they are; their replicated input's gradient
    is summed over tp (parallel/tensor.copy_to_tp). Traced, the call is one
    `linear` span counting the three products (three where their kinds
    differ): a span's events cost the device a few microseconds each."""
    ps, k = (p_q, p_k, p_v), x.shape[-1]
    if not all(isinstance(p, Linear) and p.lora_a is None for p in ps):
        if profiling.tracing and _kind(p_q) == _kind(p_k) == _kind(p_v):
            with linear_span(x.numel() // k, k, sum(map(_out_features, ps)), _kind(p_q)):
                return tuple(_linear(p, x, act8) for p in ps)
        return tuple(linear(p, x, act8) for p in ps)
    if getattr(p_q, "tp", None) is not None:
        from videoitg_tpu_torch.parallel.tensor import copy_to_tp

        x = copy_to_tp(x, p_q.tp.group)
    dq, dk = p_q.w.shape[-1], p_k.w.shape[-1]
    with (linear_span(x.numel() // k, k, sum(map(_out_features, ps)), "bf16")
          if profiling.tracing else profiling.NULL):
        w = torch.cat([p_q.w, p_k.w, p_v.w], dim=-1)
        y = x @ w
        if p_q.b is not None:
            y = y + torch.cat([p_q.b, p_k.b, p_v.b], dim=-1)
    return y[..., :dq], y[..., dq: dq + dk], y[..., dq + dk:]
