"""Grounding train step.

Counterpart of videoitg_tpu/train/train_step.py: the loss of
`models/grounding.grounding_loss` with a frozen vision tower and
rematerialised decoder layers, gradients of the leaves that train, one
optimizer call.

Two differences from the JAX package, both stated where they matter:
PyTorch updates the parameters in place, so a step returns a `TrainState`
that holds the same model object; and gradients are computed only for the
leaves that train (that is what lets an 8B base with LoRA adapters fit one
card), so the `grad_norm` metric is the norm over those leaves, where the
JAX package differentiates every leaf and reports the norm over all of
them, the frozen base included. The updates are the same: the JAX package
sets the frozen groups' updates to zero.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models.grounding import GroundingBatch, grounding_loss
from videoitg_tpu_torch.train.optimizer import GroupedAdamW, global_norm


@dataclass
class TrainState:
    step: int                  # counts every call, accumulation or not
    model: nn.Module
    optimizer: GroupedAdamW


def create_train_state(model: nn.Module, tx: GroupedAdamW) -> TrainState:
    return TrainState(step=0, model=model, optimizer=tx)


def make_train_step(cfg: GroundingConfig, tx: GroupedAdamW, hw: int, use_flash=False,
                    remat: bool = True, param_dtype=None, donate: bool = False):
    """Returns (state, batch) -> (state, metrics) with metrics `loss`,
    `pos_weight`, `pos_frac`, `grad_norm` (0-d tensors; `grad_norm` over the
    leaves that train). `use_flash=True` runs the differentiable attention
    kernels. The step uses the optimizer its state carries (`tx`, as built by
    `create_train_state`). `donate` and `param_dtype` are accepted for the JAX
    signature's sake and do nothing: the update is in place either way, so no
    second copy of the parameters ever exists."""
    del tx, param_dtype, donate

    def step_fn(state: TrainState, batch: GroundingBatch):
        opt = state.optimizer
        loss, metrics = grounding_loss(state.model, batch, cfg, hw=hw, use_flash=use_flash,
                                       remat=remat, freeze_vision=True)
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(opt.params, grads)]
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        opt.apply(grads)
        return TrainState(state.step + 1, state.model, opt), metrics

    return step_fn


def run_step(step_fn, state: TrainState, batch: GroundingBatch, mesh=None, microbatches=None):
    """Execute one step. `mesh` (data / tensor / sequence / pipeline
    parallelism) needs more than one device and is not ported (ROADMAP
    queue 1)."""
    if mesh is not None or microbatches is not None:
        raise NotImplementedError(
            "run_step(mesh=...): multi-device training is not ported yet (ROADMAP queue 1)")
    return step_fn(state, batch)
