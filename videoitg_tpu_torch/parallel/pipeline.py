"""Pipeline parallelism: a GPipe microbatch schedule over the mesh's pp axis.

Counterpart of videoitg_tpu/parallel/pipeline.py (forward). Stage s holds the
decoder layers [s L/P, (s+1) L/P) and nothing else of the stack
(parallel/sharding.shard_model); the batch is split into M microbatches that
flow stage to stage as activations, with `dist.send` / `dist.recv` between
neighbouring stages. Stage s works on microbatch t - s at step t, so the
schedule is the classic M + P - 1 steps; here each stage simply takes its
microbatches in order, and the sends and receives pace it into that
diagram (no stage computes a bubble). The last stage's output is broadcast
to every stage, the counterpart of the JAX package's psum over a one-hot
stage mask; the final norm runs outside. Inside a stage the attention mesh is
off (no ring), while tensor parallelism of the stage's weights stays on;
a stage runs the attention kernels as the engine's `use_flash` says.

Under autograd the stage is one `torch.autograd.Function` (`_Stage`) whose
inputs are the stage's input and its trainable leaves, so that a caller's
`torch.autograd.grad(loss, params)` reaches them. Its forward runs the
schedule above, keeping each microbatch's detached input and the graph of
its output (each layer rematerialised when asked). Its backward runs the
microbatches in reverse, in one fixed order on every stage: receive the
cotangent from stage s + 1 (the last stage takes its own), differentiate
that microbatch, send dX to stage s - 1. Every stage computes the same loss,
so the broadcast's backward keeps the cotangent of the last stage only (the
transpose of the JAX psum over a one-hot stage mask); the input's gradient,
whole on stage 0, is broadcast to every stage, as the JAX island's
replicated input receives it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from videoitg_tpu_torch.parallel import context as par_context
from videoitg_tpu_torch.parallel.mesh import PP_AXIS


def default_microbatches(batch: int, pp: int) -> int:
    """Largest divisor of `batch` that is <= pp (so the default never
    violates batch % M == 0, whatever the batch)."""
    m = min(batch, pp)
    while batch % m:
        m -= 1
    return m


class _Schedule:
    """One stage's view of the pipeline: its layers, neighbours and the
    microbatch split."""

    def __init__(self, lm, positions, valid, cfg, use_flash, act8, lm_splash, remat, mesh,
                 pp_axis, m):
        self.group = mesh.get_group(pp_axis)
        pp = dist.get_world_size(self.group)
        stage = mesh.get_local_rank(pp_axis)
        self.prev = dist.get_global_rank(self.group, stage - 1) if stage > 0 else None
        self.nxt = dist.get_global_rank(self.group, stage + 1) if stage < pp - 1 else None
        self.first = dist.get_global_rank(self.group, 0)
        self.last = dist.get_global_rank(self.group, pp - 1)
        self.lm, self.positions, self.valid, self.cfg = lm, positions, valid, cfg
        self.use_flash, self.act8, self.lm_splash, self.remat = use_flash, act8, lm_splash, remat
        self.m = m

    def part(self, i: int, b: int) -> slice:
        mb = b // self.m
        return slice(i * mb, (i + 1) * mb)

    def stage(self, x: torch.Tensor, part: slice) -> torch.Tensor:
        from torch.utils.checkpoint import checkpoint

        from videoitg_tpu_torch.models.qwen2 import _decoder_layer

        pos = self.positions[part]
        val = None if self.valid is None else self.valid[part]
        args = (pos, val, self.cfg, self.use_flash, self.act8, self.lm_splash)
        for layer in self.lm.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(_decoder_layer, layer, x, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _decoder_layer(layer, x, *args)
        return x

    def input_of(self, inputs_embeds: torch.Tensor, part: slice) -> torch.Tensor:
        if self.prev is None:
            return inputs_embeds[part]
        x = torch.empty_like(inputs_embeds[part])
        dist.recv(x, src=self.prev, group=self.group)
        return x

    def forward(self, inputs_embeds: torch.Tensor, keep=None) -> torch.Tensor:
        """The GPipe forward; with `keep` (a list) under autograd, each
        microbatch's (detached input, output) is appended to it."""
        out = torch.empty_like(inputs_embeds)
        b = inputs_embeds.shape[0]
        with par_context.no_attention_mesh():
            for i in range(self.m):
                part = self.part(i, b)
                x = self.input_of(inputs_embeds, part)
                if keep is not None:
                    x = x.detach().requires_grad_(inputs_embeds.requires_grad or
                                                  self.prev is not None)
                    with torch.enable_grad():
                        y = self.stage(x, part)
                    keep.append((x, y))
                else:
                    y = self.stage(x, part)
                if self.nxt is not None:
                    dist.send(y.detach().contiguous(), dst=self.nxt, group=self.group)
                else:
                    out[part] = y.detach()
        dist.broadcast(out, src=self.last, group=self.group)
        return out


class _Stage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, inputs_embeds, *leaves):
        keep = []
        out = sched.forward(inputs_embeds, keep)
        ctx.sched, ctx.keep, ctx.leaves = sched, keep, leaves
        return out

    @staticmethod
    def backward(ctx, dout):
        sched, keep, leaves = ctx.sched, ctx.keep, ctx.leaves
        b = dout.shape[0]
        dx = torch.zeros_like(dout)
        dleaves = [None] * len(leaves)
        with par_context.no_attention_mesh():
            for i in reversed(range(sched.m)):
                part = sched.part(i, b)
                x, y = keep[i]
                if sched.nxt is None:
                    g = dout[part].contiguous()
                else:
                    g = torch.empty_like(y)
                    dist.recv(g, src=sched.nxt, group=sched.group)
                wrt = ([x] if x.requires_grad else []) + list(leaves)
                grads = (torch.autograd.grad(y, wrt, g, allow_unused=True) if y.requires_grad
                         else [None] * len(wrt))
                if x.requires_grad:
                    gx, grads = grads[0], grads[1:]
                    if sched.prev is not None:
                        dist.send(gx.contiguous(), dst=sched.prev, group=sched.group)
                    elif gx is not None:
                        dx[part] = gx
                for j, gl in enumerate(grads):
                    if gl is not None:
                        dleaves[j] = gl if dleaves[j] is None else dleaves[j] + gl
        ctx.keep = None
        if ctx.needs_input_grad[1]:
            dist.broadcast(dx, src=sched.first, group=sched.group)
        else:
            dx = None
        dleaves = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, dleaves)]
        return (None, dx, *dleaves)


def pipeline_hidden_states(lm, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                           valid: Optional[torch.Tensor], cfg, use_flash=False, act8=None,
                           lm_splash: Optional[bool] = None, remat: bool = False, *, mesh,
                           pp_axis: str = PP_AXIS,
                           microbatches: Optional[int] = None) -> torch.Tensor:
    """The decoder stack over this rank's batch as a pipeline; returns the
    hidden states before the final norm, the same on every stage.
    Differentiable in the stage's input and in the stage's leaves that
    require gradients; `remat` recomputes each layer in the backward pass.

    Requires cfg.num_layers % pp == 0 (the model sharded with pp) and
    batch % M == 0 (M defaults to the largest divisor of the batch <= pp)."""
    from videoitg_tpu_torch.ops.quant import Act8Switches

    group = mesh.get_group(pp_axis)
    pp = dist.get_world_size(group)
    stage = mesh.get_local_rank(pp_axis)
    per = cfg.num_layers // pp
    if cfg.num_layers % pp:
        raise ValueError(f"layers ({cfg.num_layers}) % pp ({pp}) != 0")
    if len(lm.layers) != per:
        raise ValueError(f"stage {stage} holds {len(lm.layers)} layers, the schedule "
                         f"needs {per}: shard the model with pp (parallel/sharding.py)")
    b = inputs_embeds.shape[0]
    m = microbatches if microbatches is not None else default_microbatches(b, pp)
    if b % m:
        raise ValueError(f"batch ({b}) % microbatches ({m}) != 0")
    act8 = act8 if act8 is not None else Act8Switches()
    # Every stage sends and receives in the model's dtype.
    sched = _Schedule(lm, positions, valid, cfg, use_flash, act8, lm_splash, remat, mesh,
                      pp_axis, m)
    leaves = [p for p in lm.layers.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (inputs_embeds.requires_grad or leaves):
        return _Stage.apply(sched, inputs_embeds, *leaves)
    return sched.forward(inputs_embeds)
