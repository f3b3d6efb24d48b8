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


def pipeline_hidden_states(lm, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                           valid: Optional[torch.Tensor], cfg, use_flash=False, act8=None,
                           lm_splash: Optional[bool] = None, *, mesh, pp_axis: str = PP_AXIS,
                           microbatches: Optional[int] = None) -> torch.Tensor:
    """The decoder stack over this rank's batch as a pipeline; returns the
    hidden states before the final norm, the same on every stage.

    Requires cfg.num_layers % pp == 0 (the model sharded with pp) and
    batch % M == 0 (M defaults to the largest divisor of the batch <= pp)."""
    from videoitg_tpu_torch.models.qwen2 import _decoder_layer
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
    mb = b // m
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < pp - 1 else None
    last = dist.get_global_rank(group, pp - 1)
    # Every stage sends and receives in the model's dtype.
    out = torch.empty_like(inputs_embeds)
    with par_context.no_attention_mesh():
        for i in range(m):
            part = slice(i * mb, (i + 1) * mb)
            if prev is None:
                x = inputs_embeds[part]
            else:
                x = torch.empty_like(inputs_embeds[part])
                dist.recv(x, src=prev, group=group)
            pos = positions[part]
            val = None if valid is None else valid[part]
            for layer in lm.layers:
                x = _decoder_layer(layer, x, pos, val, cfg, use_flash, act8, lm_splash)
            if nxt is not None:
                dist.send(x.contiguous(), dst=nxt, group=group)
            else:
                out[part] = x
    dist.broadcast(out, src=last, group=group)
    return out
