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

On a device mesh (`run_step(mesh=...)`, one process per device) the model is
this rank's slice (parallel/sharding.shard_model) and the step is the JAX
package's GSPMD step written out: the batch is split over dp, attention
rings over sp and the decoder stack runs as a pipeline over pp, the tp
collectives carry their own backward (parallel/tensor.py), the gradients
are summed over dp, and `grad_norm` and each group's clipping norm are the
norms of the whole leaves (parallel/grads.py).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch import nn

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models.grounding import grounding_loss
from videoitg_tpu_torch.train.optimizer import GroupedAdamW, global_norm


@dataclass
class TrainState:
    step: int                  # counts every call, accumulation or not
    model: nn.Module
    optimizer: GroupedAdamW


def create_train_state(model: nn.Module, tx: GroupedAdamW) -> TrainState:
    return TrainState(step=0, model=model, optimizer=tx)


def step_from_loss(loss_fn):
    """(state, batch) -> (state, metrics) around `loss_fn(model, batch) ->
    (loss, metrics)`: gradients of the leaves that train, `grad_norm` over
    them, one optimizer call in place. Shared by the grounding and the VLM
    SFT steps."""

    def step_fn(state: TrainState, batch):
        from videoitg_tpu_torch.parallel.context import current_attention_mesh

        opt = state.optimizer
        loss, metrics = loss_fn(state.model, batch)
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(opt.params, grads)]
        metrics = dict(metrics)
        ctx = current_attention_mesh()
        if ctx is None:
            metrics["grad_norm"] = global_norm(grads)
            opt.apply(grads)
        else:
            from videoitg_tpu_torch.parallel.grads import MeshNorms, sum_over_dp

            grads = sum_over_dp(grads, ctx[0])
            norms = MeshNorms(state.model, ctx[0])
            metrics["grad_norm"] = norms([opt.params], [grads])[0]
            opt.apply(grads, norms=norms)
        return TrainState(state.step + 1, state.model, opt), metrics

    return step_fn


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
    return step_from_loss(lambda model, batch: grounding_loss(
        model, batch, cfg, hw=hw, use_flash=use_flash, remat=remat, freeze_vision=True))


def run_step(step_fn, state: TrainState, batch, mesh=None, microbatches=None):
    """Execute one step. With a `mesh` (parallel/mesh.make_mesh; every rank
    of it calls this with the same whole batch and its own slice of the
    model) the batch is split over dp, attention sees the mesh (ring
    attention under sp), a pp axis above 1 runs the decoder stack as a
    pipeline of `microbatches` (default: the largest divisor of the rank's
    batch <= pp), and the step sums the gradients over dp and takes the
    norms over the whole leaves. Without one, `microbatches` is ignored,
    as in the JAX package."""
    if mesh is None:
        return step_fn(state, batch)
    from torch.distributed.device_mesh import DeviceMesh

    from videoitg_tpu_torch.parallel import context as par_context
    from videoitg_tpu_torch.parallel.mesh import PP_AXIS, axis_size, dp_share

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel/mesh.make_mesh), "
                        f"not {type(mesh).__name__}")
    share = dp_share(batch[0].shape[0], mesh)
    local = type(batch)(*(None if x is None else x[share] for x in batch))
    with contextlib.ExitStack() as stack:
        if axis_size(mesh, PP_AXIS) > 1:
            stack.enter_context(par_context.pipeline_mesh(mesh, microbatches=microbatches))
        stack.enter_context(par_context.attention_mesh(mesh))
        return step_fn(state, local)
