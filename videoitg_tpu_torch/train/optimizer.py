"""Optimizer with per-subtree learning-rate groups.

Counterpart of videoitg_tpu/train/optimizer.py (optax.multi_transform over
subtree labels): AdamW, base lr 2e-5, a separate group for the scoring head
(`out_proj_lr` 2e-4), an optional one for the projector, a frozen vision
tower, cosine schedule with warmup, weight decay 0 by default.

`GroupedAdamW` is what the factories return. It is `torch.optim.AdamW` over
one param group per label plus a `LambdaLR` scheduler, with three things
kept as the JAX package has them, because each moves the parameters:

* clipping is per group: every label's gradients are clipped by that group's
  own global norm (`optax.clip_by_global_norm` sits inside each label's
  chain), not by one norm over all parameters;
* the schedule is read at the update count, which starts at 0, so the first
  update has learning rate 0;
* accumulation averages the gradients of `accum_steps` calls and advances
  clipping, Adam and the schedule once per `accum_steps` calls
  (`optax.MultiSteps`).

It sets `requires_grad` from the labels: a frozen leaf gets no gradient and
no optimizer state.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn


def _label_tree(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> optimizer group (`base`, `out_proj`, `projector`,
    `frozen`). The vision tower is frozen. A quantised linear's own leaves
    (its bias; the integer weight and scales are buffers) are frozen whatever
    their subtree, while LoRA leaves riding on it keep the subtree's group."""
    from videoitg_tpu_torch.ops.quant import QuantLinear

    labels = {}
    for mod_name, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            top = name.split(".")[0]
            label = {"out_proj": "out_proj", "projector": "projector",
                     "vision": "frozen"}.get(top, "base")
            if isinstance(module, QuantLinear) and not leaf.startswith("lora_"):
                label = "frozen"
            labels[name] = label
    return labels


def make_schedule(base_lr: float, total_steps: int, warmup_ratio: float = 0.05,
                  kind: str = "cosine") -> Callable[[int], float]:
    """count -> learning rate. `cosine`: linear warmup from 0 over `warmup`
    updates, then a cosine to 0 at max(total_steps, warmup + 1); `constant`:
    the same warmup, then `base_lr`. warmup = max(1, int(total * ratio))."""
    warmup = max(1, int(total_steps * warmup_ratio))
    if kind == "cosine":
        decay = max(total_steps, warmup + 1) - warmup

        def cosine(count: int) -> float:
            if count < warmup:
                return base_lr * count / warmup
            frac = min(count - warmup, decay) / decay
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

        return cosine
    if kind == "constant":
        return lambda count: base_lr * min(count, warmup) / warmup
    raise ValueError(f"unknown schedule {kind!r}")


class GroupedAdamW:
    """AdamW over labelled param groups; see the module docstring.

    `labels` maps every parameter name of `model` to a group; `group_lrs`
    gives the peak learning rate of each group that trains (a label missing
    from it, or mapped to None, is frozen). `apply(grads)` is one call of the
    JAX package's `tx.update` + `apply_updates`, in place.
    """

    def __init__(self, model: nn.Module, labels: Dict[str, str],
                 group_lrs: Dict[str, Optional[float]], *, total_steps: int,
                 warmup_ratio: float = 0.05, schedule: str = "cosine",
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, max_grad_norm: Optional[float] = 1.0,
                 accum_steps: int = 1):
        named = dict(model.named_parameters())
        if set(named) != set(labels):
            raise KeyError("labels do not cover the model's parameters")
        groups: Dict[str, List[str]] = {}
        for name, p in named.items():
            label = labels[name]
            trains = group_lrs.get(label) is not None
            p.requires_grad_(trains)
            if trains:
                groups.setdefault(label, []).append(name)
        if not groups:
            raise ValueError("no parameter trains under these labels")
        self.group_names = {label: names for label, names in groups.items()}
        self.params: List[nn.Parameter] = [named[n] for names in groups.values() for n in names]
        self.max_grad_norm = max_grad_norm
        self.accum_steps = max(1, int(accum_steps))
        self.mini_step = 0
        # lr 1.0 times the schedule's value: LambdaLR multiplies the initial lr.
        self.optimizer = torch.optim.AdamW(
            [{"params": [named[n] for n in names], "name": label}
             for label, names in groups.items()],
            lr=1.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, [make_schedule(group_lrs[label], total_steps, warmup_ratio, schedule)
                             for label in groups])

    def trainable_names(self) -> List[str]:
        return [n for names in self.group_names.values() for n in names]

    def apply(self, grads: Sequence[torch.Tensor]) -> None:
        """Take the gradients of one call (aligned with `self.params`)."""
        first = self.mini_step == 0
        for p, g in zip(self.params, grads):
            if first:
                p.grad = g.detach().clone() if self.accum_steps > 1 else g.detach()
            else:
                p.grad.add_(g.detach())
        self.mini_step += 1
        if self.mini_step < self.accum_steps:
            return
        self.mini_step = 0
        for group in self.optimizer.param_groups:
            g_list = [p.grad for p in group["params"]]
            if self.accum_steps > 1:
                torch._foreach_div_(g_list, float(self.accum_steps))
            if self.max_grad_norm is not None:
                norm = global_norm(g_list)
                scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                    self.max_grad_norm / norm)
                torch._foreach_mul_(g_list, [scale.to(g.dtype) for g in g_list])
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        acc = [p.grad for p in self.params] if self.mini_step else None
        return {"optimizer": self.optimizer.state_dict(), "scheduler": self.scheduler.state_dict(),
                "mini_step": self.mini_step, "accumulated": acc}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = state["mini_step"]
        if state["accumulated"] is not None:
            for p, g in zip(self.params, state["accumulated"]):
                p.grad = g.to(device=p.device, dtype=p.dtype)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all the tensors, accumulated in fp32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def make_grounding_optimizer(
    model: nn.Module,
    learning_rate: float = 2e-5,
    out_proj_lr: Optional[float] = 2e-4,
    projector_lr: Optional[float] = None,
    weight_decay: float = 0.0,
    total_steps: int = 10_000,
    warmup_ratio: float = 0.05,
    schedule: str = "cosine",
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = 1.0,
    accum_steps: int = 1,
    tune_projector_only: bool = False,
) -> GroupedAdamW:
    """Groups `base`, `out_proj`, `projector`; the vision tower and every
    quantised base frozen. `tune_projector_only` (the stage-1 adapter
    pretrain) freezes `base` and `out_proj` too."""
    group_lrs = {
        "base": None if tune_projector_only else learning_rate,
        "out_proj": None if tune_projector_only else (
            out_proj_lr if out_proj_lr is not None else learning_rate),
        "projector": projector_lr if projector_lr is not None else learning_rate,
    }
    return GroupedAdamW(model, _label_tree(model), group_lrs, total_steps=total_steps,
                        warmup_ratio=warmup_ratio, schedule=schedule, weight_decay=weight_decay,
                        b1=b1, b2=b2, eps=eps, max_grad_norm=max_grad_norm,
                        accum_steps=accum_steps)
