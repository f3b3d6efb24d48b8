"""Serving quantisation tiers: int8 / int4 weights, dynamic int8 activations.

Counterpart of videoitg_tpu/ops/quant.py, with the same formulas:
per-output-channel symmetric scales `amax / 127` (`/ 7` for int4), a zero
column gets scale 1, `round` is half to even, values are clipped to +-127
(+-7). Because the quantisation is symmetric, dequantisation commutes with
the matmul: `x @ (w_q * s) == (x @ w_q) * s`.

In PyTorch's idiom a quantised linear is a module, `QuantLinear`, that holds
the integer weight, its fp32 scale, the bias and a plain boolean `act_q`
(dynamic per-row int8 activations). The tier transforms replace the dense
`Linear` modules of a model in place, layer by layer, so the dense and the
int8 copies of a large model never both sit whole on the device.

Layout. The int8 weight is stored `[out, in]` (`w_qt`, the input axis
contiguous): that is the operand layout of the s8 tensor-core product, for
the hand-written kernels (ops/quant_gemm.py, ops/fused_encoder.py) and for
the library integer product alike. `QuantLinear.w_q` is the `[in, out]` view
of the JAX package, and the weight bridge (checkpoint.py) crosses in that
layout, bit for bit. Packed int4 keeps the JAX layout `[in/2, out]` (low
nibble = row i, high nibble = row i + in/2); no kernel reads it.

The two switches. `VIDEOITG_QGEMM=1` sends act8 linears whose shape the
kernel supports through the hand-written quantise-into-GEMM kernel
(`act8_linear`), `VIDEOITG_FUSED=1` sends act8 encoder layers of the vision
tower through the fused kernels. Both are off by default, as in the JAX
package. They are read once (`Act8Switches.from_env`, where the engine is
built) and passed down as a plain value. With a switch off, the act8
product is a library integer product (`torch._int_mm` on the card, an exact
int32 matmul on the CPU), the counterpart of XLA's integer einsum.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import torch
from torch import nn

from videoitg_tpu_torch.models.common import Linear, init_lora_slots

QWEN2_LINEAR_KEYS = ("q", "k", "v", "o", "gate", "up", "down")
SIGLIP_LINEAR_KEYS = ("q", "k", "v", "o", "fc1", "fc2")


class Act8Switches(NamedTuple):
    """Which act8 products run in the hand-written kernels."""

    qgemm: bool = False   # kernel F for act8 linears (the LM)
    fused: bool = False   # kernels G, H, I for act8 encoder layers (the tower)

    @classmethod
    def from_env(cls, qgemm: Optional[bool] = None,
                 fused: Optional[bool] = None) -> "Act8Switches":
        """Explicit values win; None reads VIDEOITG_QGEMM / VIDEOITG_FUSED."""
        if qgemm is None:
            qgemm = os.environ.get("VIDEOITG_QGEMM") == "1"
        if fused is None:
            fused = os.environ.get("VIDEOITG_FUSED") == "1"
        return cls(bool(qgemm), bool(fused))


# ---- tensor-level quantisers (any leading axes; the reduction is over the
# input axis -2, never a stacked-layer axis) ----


@functools.lru_cache(maxsize=None)
def _divisor(device: torch.device, value: float) -> torch.Tensor:
    """`value` as a 0-d fp32 tensor on `device`, made once per device."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def symmetric_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """amax / qmax by a true division, 1 where amax is 0: the one formula of
    every symmetric scale (weights per output channel, activations per row).
    The divisor is a 0-d tensor on amax's device, kept per device, so a call
    copies nothing to the card: PyTorch's CUDA division by a Python number
    multiplies by its reciprocal, an ulp off the quotient for some amax, where
    the kernels (`__fdiv_rn`) and the JAX package divide."""
    return torch.where(amax == 0, torch.ones_like(amax), amax / _divisor(amax.device, qmax))


def quantize_weight_int8(w: torch.Tensor):
    """[..., in, out] float -> (w_q int8 [..., in, out], scale fp32 [..., out])."""
    w = w.float()
    scale = symmetric_scale(w.abs().amax(dim=-2), 127.0)
    w_q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_weight_int4(w: torch.Tensor):
    """[..., in, out] float -> (packed int8 [..., in/2, out], scale fp32
    [..., out]): two nibbles a byte, low = row i, high = row i + in/2."""
    w = w.float()
    in_dim = w.shape[-2]
    if in_dim % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {in_dim}")
    scale = symmetric_scale(w.abs().amax(dim=-2), 7.0)
    w_q = torch.clamp(torch.round(w / scale[..., None, :]), -7, 7).to(torch.int8)
    return pack_int4(w_q), scale


def pack_int4(w_q: torch.Tensor) -> torch.Tensor:
    """int8 [..., in, out] in [-8, 7] -> packed int8 [..., in/2, out]; the
    inverse of `unpack_int4`."""
    in_dim = w_q.shape[-2]
    lo = w_q[..., : in_dim // 2, :]
    hi = w_q[..., in_dim // 2:, :]
    # Through int16 so that the shift cannot overflow; the cast keeps the low byte.
    return ((lo.to(torch.int16) & 0xF) | (hi.to(torch.int16) << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 [..., in/2, out] -> int8 [..., in, out] in [-8, 7]."""
    lo = ((packed & 0xF) ^ 8) - 8   # sign-extend the low nibble
    hi = packed >> 4                # arithmetic shift
    return torch.cat([lo, hi], dim=-2)


def row_scale_of(amax: torch.Tensor) -> torch.Tensor:
    """Row amax -> the symmetric int8 row scale: amax / 127, 1 where amax is
    0. The one formula of every activation-side scale (`row_quant`,
    ops/quant_gemm.row_scale, ops/fused_encoder's MLP stages)."""
    return symmetric_scale(amax, 127.0)


def row_quant(y: torch.Tensor):
    """fp32 [..., K] -> (int8 [..., K], fp32 [..., 1] scale): dynamic per-row
    symmetric quantisation, the activation side of every act8 product."""
    amax = y.abs().amax(dim=-1, keepdim=True)
    scale = row_scale_of(amax)
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(a_q: torch.Tensor, w_qt: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [N, K]^T -> int32 [M, N]. A library product:
    `torch._int_mm` on the card, an int32 matmul on the CPU."""
    if a_q.device.type == "cpu":
        return a_q.to(torch.int32) @ w_qt.t().to(torch.int32)
    m = a_q.shape[0]
    if m <= 16:  # torch._int_mm takes more than 16 rows
        pad = a_q.new_zeros((32, a_q.shape[1]))
        pad[:m] = a_q
        return torch._int_mm(pad, w_qt.t())[:m]
    return torch._int_mm(a_q.contiguous(), w_qt.t())


# ---- the quantised linear ----


class QuantLinear(nn.Module):
    """An int8 (`w_qt` [out, in] + `scale`) or packed-int4 (`w_q4` [in/2, out]
    + `scale4`) linear with an optional bias and the `act_q` flag.

    `.to(dtype)` / `.bfloat16()` cast the bias (and a LoRA adapter, if one is
    attached) only: integer weights stay integer and the scales stay fp32
    (see `_apply`).
    """

    def __init__(self, *, w_qt: Optional[torch.Tensor] = None,
                 w_q4: Optional[torch.Tensor] = None, scale: torch.Tensor,
                 b: Optional[torch.Tensor] = None, act_q: bool = False):
        super().__init__()
        if (w_qt is None) == (w_q4 is None):
            raise ValueError("QuantLinear takes exactly one of w_qt (int8) and w_q4 (int4)")
        weight = w_qt if w_qt is not None else w_q4
        if weight.dtype != torch.int8 or weight.dim() != 2:
            raise ValueError(f"integer weight must be a 2-D int8 tensor, got "
                             f"{weight.dtype} {tuple(weight.shape)}")
        if scale.dtype != torch.float32:
            raise ValueError(f"scale must be float32, got {scale.dtype}")
        self.bits = 8 if w_qt is not None else 4
        if self.bits == 8:
            self.register_buffer("w_qt", w_qt.contiguous())
            self.register_buffer("scale", scale.contiguous())
        else:
            self.register_buffer("w_q4", w_q4.contiguous())
            self.register_buffer("scale4", scale.contiguous())
        self.b = None if b is None else nn.Parameter(b, requires_grad=False)
        self.act_q = bool(act_q)
        init_lora_slots(self)  # QLoRA: train/lora.add_lora fills them

    @property
    def w_q(self) -> torch.Tensor:
        """The int8 weight in the JAX package's [in, out] layout (a view)."""
        return self.w_qt.t()

    @property
    def in_features(self) -> int:
        return self.w_qt.shape[1] if self.bits == 8 else 2 * self.w_q4.shape[0]

    @property
    def out_features(self) -> int:
        return self.w_qt.shape[0] if self.bits == 8 else self.w_q4.shape[1]

    def _apply(self, fn, recurse=True):
        # A dtype cast must not touch the fp32 scales: keep the original and
        # only follow the module to its new device.
        name = "scale" if self.bits == 8 else "scale4"
        kept = self._buffers[name]
        super()._apply(fn, recurse)
        moved = self._buffers[name]
        if moved.dtype != torch.float32:
            self._buffers[name] = kept.to(device=moved.device)
        return self


def is_quantized(lin) -> bool:
    return isinstance(lin, QuantLinear)


def is_quantized_tree(model: nn.Module) -> bool:
    """True if any linear of the model is int8- or int4-quantised."""
    return any(isinstance(m, QuantLinear) for m in model.modules())


def quantize_linear_int8(lin: Linear) -> QuantLinear:
    """Dense `Linear` (w [in, out]) -> int8 `QuantLinear`."""
    w_q, scale = quantize_weight_int8(lin.w.data)
    return QuantLinear(w_qt=w_q.t().contiguous(), scale=scale,
                       b=None if lin.b is None else lin.b.data)


def quantize_linear_int4(lin: Linear) -> QuantLinear:
    """Dense `Linear` -> packed-int4 `QuantLinear`."""
    packed, scale = quantize_weight_int4(lin.w.data)
    return QuantLinear(w_q4=packed, scale=scale, b=None if lin.b is None else lin.b.data)


def _int_weight_matmul(w_qt: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
                       bias: Optional[torch.Tensor], act_q: bool,
                       x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shared core of the int8 / int4 linears: x @ dequant(w) with the
    per-output-channel scale applied after the product. With act_q the
    activations are quantised per row and the product is int8 x int8 with an
    exact int32 sum (a library product, see `int8_matmul`); `x_scale`
    ([M, 1] fp32) gives the row scales instead of the rows' own amax (a
    row-parallel shard quantises with the whole row's, parallel/tensor.py)."""
    if act_q:
        lead = x.shape[:-1]
        x2 = x.float().reshape(-1, x.shape[-1])
        if x_scale is None:
            x_q, x_scale = row_quant(x2)
        else:
            x_q = torch.clamp(torch.round(x2 / x_scale), -127, 127).to(torch.int8)
        acc = int8_matmul(x_q, w_qt)
        y = (acc.float() * x_scale * scale).to(x.dtype).reshape(*lead, w_qt.shape[0])
    else:
        y = torch.matmul(x, w_qt.t().to(x.dtype))
        y = (y.float() * scale).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def quantized_linear(lin: QuantLinear, x: torch.Tensor,
                     act8: Act8Switches = Act8Switches(),
                     x_scale: Optional[torch.Tensor] = None,
                     with_bias: bool = True) -> torch.Tensor:
    """x @ dequant(w) (+ b unless `with_bias` is off) for either integer
    form. An act_q int8 linear whose shape the kernel supports goes through
    `act8_linear` (kernel F on the card) when `act8.qgemm` is set. `x_scale`
    gives act8's row scales (see `_int_weight_matmul`)."""
    bias = lin.b if with_bias else None
    if lin.bits == 4:
        return _int_weight_matmul(unpack_int4(lin.w_q4).t(), lin.scale4, x, bias, lin.act_q,
                                  x_scale)
    if lin.act_q and act8.qgemm:
        from videoitg_tpu_torch.ops.quant_gemm import act8_linear, shapes_supported

        if shapes_supported(lin, x):
            return act8_linear(lin, x, x_scale=x_scale, with_bias=with_bias)
    return _int_weight_matmul(lin.w_qt, lin.scale, x, bias, lin.act_q, x_scale)


# ---- model-level transforms (in place, layer by layer) ----


def _replace_layer_linears(tower: nn.Module, keys, transform) -> nn.Module:
    for layer in tower.layers:
        for key in keys:
            lin = getattr(layer, key)
            if isinstance(lin, Linear):
                setattr(layer, key, transform(lin))
    return tower


def quantize_qwen2_int8(lm: nn.Module) -> nn.Module:
    """int8 weights for all decoder-layer linears (embeddings and norms stay dense)."""
    return _replace_layer_linears(lm, QWEN2_LINEAR_KEYS, quantize_linear_int8)


def quantize_qwen2_int4(lm: nn.Module) -> nn.Module:
    """Packed-int4 weights for all decoder-layer linears."""
    return _replace_layer_linears(lm, QWEN2_LINEAR_KEYS, quantize_linear_int4)


def quantize_siglip_int8(tower: nn.Module) -> nn.Module:
    """Weight-only int8 for the vision tower's encoder linears (the patch and
    position embeddings stay dense: small and precision-sensitive)."""
    return _replace_layer_linears(tower, SIGLIP_LINEAR_KEYS, quantize_linear_int8)


def enable_act_quant(tower: nn.Module, keys=QWEN2_LINEAR_KEYS) -> nn.Module:
    """Mark every quantised layer linear for dynamic activation quantisation."""
    for layer in tower.layers:
        for key in keys:
            lin = getattr(layer, key)
            if isinstance(lin, QuantLinear):
                lin.act_q = True
    return tower


def cast_params(model: nn.Module, dtype: torch.dtype, device=None) -> nn.Module:
    """Cast float leaves to `dtype` (and move to `device`), preserving
    quantised linears exactly: integer weights stay integer and their scales
    fp32 (`QuantLinear._apply`); a blind cast would round the scales."""
    return model.to(device=device, dtype=dtype)


def quantize_grounding_int8(model: nn.Module) -> nn.Module:
    """Serving quantisation of the grounding model: LM linears int8; the
    vision tower, projector and scoring head stay dense."""
    quantize_qwen2_int8(model.lm)
    return model


def apply_full_int8(model: nn.Module) -> nn.Module:
    """Full int8 serving: quantise the LM if still dense, then dynamic
    activation quantisation on the LM and the vision encoder linears."""
    quantize_qwen2_int8(model.lm)  # leaves already-quantised linears alone
    enable_act_quant(model.lm)
    enable_act_quant(quantize_siglip_int8(model.vision), keys=SIGLIP_LINEAR_KEYS)
    return model


def apply_quantization_tier(model: nn.Module, tier: str) -> nn.Module:
    """One tier -> transform mapping for every serving entry point:
    'int8' = weight-only int8 LM; 'int4' = packed-nibble int4 LM; 'act8' =
    int8 weights + dynamic int8 activations (LM + vision). In place."""
    if tier in ("int8", "act8"):
        quantize_grounding_int8(model)
    elif tier == "int4":
        quantize_qwen2_int4(model.lm)
    else:
        raise ValueError(f"unknown quantization tier {tier!r}")
    if tier == "act8":
        apply_full_int8(model)
    return model


# ---- random models directly in serving form ----


def _init_qwen2_quantized(cfg, generator: torch.Generator, device, dtype, to_q) -> nn.Module:
    """A random LM whose decoder linears are drawn directly in integer form
    (`to_q(d_in, d_out) -> QuantLinear`): the dense weights never exist."""
    from videoitg_tpu_torch.models.qwen2 import Qwen2

    lm = Qwen2(cfg, device=device, dtype=dtype, generator=generator, dense_linears=False)
    h = cfg.hidden_size
    shapes = {"q": (h, cfg.q_dim), "k": (h, cfg.kv_dim), "v": (h, cfg.kv_dim),
              "o": (cfg.q_dim, h), "gate": (h, cfg.intermediate_size),
              "up": (h, cfg.intermediate_size), "down": (cfg.intermediate_size, h)}
    for layer in lm.layers:
        for name, (d_in, d_out) in shapes.items():
            lin = to_q(d_in, d_out)
            if name in ("q", "k", "v"):
                lin.b = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype),
                                     requires_grad=False)
            setattr(layer, name, lin)
    return lm


def init_qwen2_int8(cfg, generator: torch.Generator, *, device=None,
                    dtype=torch.bfloat16) -> nn.Module:
    """Random LM directly in int8 serving form: weights uniform in
    [-127, 127], every scale 0.01."""
    def to_q(d_in, d_out):
        w = torch.randint(-127, 128, (d_out, d_in), generator=generator, device=device,
                          dtype=torch.int8)
        return QuantLinear(w_qt=w, scale=torch.full((d_out,), 0.01, device=device))

    return _init_qwen2_quantized(cfg, generator, device, dtype, to_q)


def init_qwen2_int4(cfg, generator: torch.Generator, *, device=None,
                    dtype=torch.bfloat16) -> nn.Module:
    """Random LM directly in packed-int4 serving form: bytes uniform in
    [-128, 127], every scale 0.02."""
    def to_q(d_in, d_out):
        w = torch.randint(-128, 128, (d_in // 2, d_out), generator=generator, device=device,
                          dtype=torch.int8)
        return QuantLinear(w_q4=w, scale=torch.full((d_out,), 0.02, device=device))

    return _init_qwen2_quantized(cfg, generator, device, dtype, to_q)
