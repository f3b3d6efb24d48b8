"""LoRA adapters for the LM.

Counterpart of videoitg_tpu/train/lora.py. A target linear of every decoder
layer gains `lora_a` [in, r], `lora_b` [r, out] and `lora_scale` [] (=
alpha / rank); `models/common.linear` adds `((x @ a) @ b) * scale`. Training
freezes everything but the `lora_*` leaves (and, if asked, the scoring head);
`merge_lora` folds the adapters back into dense weights.

The port changes the model in place, where the JAX package returns a new
params tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from videoitg_tpu_torch.models.common import Linear, clear_lora, has_lora, set_lora

DEFAULT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def add_lora(model: nn.Module, generator: torch.Generator, rank: int = 16, alpha: float = 32.0,
             targets: Sequence[str] = DEFAULT_TARGETS,
             dtype: torch.dtype = torch.float32) -> nn.Module:
    """Add LoRA leaves to the LM's decoder-layer linears, in place.

    Works on dense and on quantised bases (QLoRA): the adapters train in
    float while the frozen base stays int8 / int4. A ~ N(0, 1 / d_in) drawn
    from `generator` (on its device, then moved to the linear's), B = 0.
    The adapters keep `dtype` (fp32 by default) over a bf16 base: add them
    after any cast of the model.
    """
    for layer in model.lm.layers:
        for name in targets:
            lin = getattr(layer, name)
            if isinstance(lin, Linear):
                d_in, d_out = lin.w.shape
                device = lin.w.device
            else:
                d_in, d_out = lin.in_features, lin.out_features
                device = lin.scale.device if lin.bits == 8 else lin.scale4.device
            a = torch.randn(d_in, rank, generator=generator, device=generator.device,
                            dtype=torch.float32) * d_in ** -0.5
            set_lora(lin, a.to(device=device, dtype=dtype),
                     torch.zeros(rank, d_out, device=device, dtype=dtype),
                     torch.tensor(alpha / rank, device=device, dtype=torch.float32))
    return model


def merge_lora(model: nn.Module) -> nn.Module:
    """Fold the LoRA deltas into the dense weights and drop the adapter
    leaves, in place. Raises on a quantised base."""
    for lin in model.modules():
        if not (hasattr(lin, "lora_a") and has_lora(lin)):
            continue
        if not isinstance(lin, Linear):
            raise ValueError(
                "cannot fold LoRA into a quantized base (no dense 'w'); "
                "dequantize first or serve base+adapters unmerged")
        delta = (lin.lora_a.float() @ lin.lora_b.float()) * lin.lora_scale.float()
        lin.w.data = (lin.w.data.float() + delta.detach()).to(lin.w.dtype)
        clear_lora(lin)
    return model


def make_lora_optimizer(
    model: nn.Module,
    learning_rate: float = 2e-4,
    out_proj_lr: Optional[float] = None,
    total_steps: int = 10_000,
    warmup_ratio: float = 0.05,
    schedule: str = "cosine",
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = 1.0,
    accum_steps: int = 1,
):
    """Train only the `lora_*` leaves (and the scoring head when
    `out_proj_lr` is set). Clipping (per group) and accumulation compose as
    in `make_grounding_optimizer`."""
    from videoitg_tpu_torch.train.optimizer import GroupedAdamW

    labels = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        if any(k.startswith("lora_") for k in keys):
            labels[name] = "lora"
        elif out_proj_lr is not None and "out_proj" in keys:
            labels[name] = "out_proj"
        else:
            labels[name] = "frozen"
    return GroupedAdamW(
        model, labels,
        {"lora": learning_rate,
         "out_proj": out_proj_lr if out_proj_lr is not None else learning_rate},
        total_steps=total_steps, warmup_ratio=warmup_ratio, schedule=schedule,
        weight_decay=weight_decay, max_grad_norm=max_grad_norm, accum_steps=accum_steps)
