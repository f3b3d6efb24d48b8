"""Ambient mesh context for attention and for the decoder pipeline.

Counterpart of videoitg_tpu/parallel/context.py. Threading the mesh through
every model function would burden the functional API, so the engine installs
it here: `ops/attention.mha` reads the attention mesh (its sp axis sends the
LM's masked attention through ring attention), the training losses read its
dp axis (`sum_over_dp`: whole-batch statistics) and
`models/qwen2.qwen2_hidden_states` reads the pipeline (its pp axis runs the
decoder stack as a microbatch pipeline). Tensor parallelism needs no context:
each sharded linear carries its own marker (parallel/sharding.py).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

_ACTIVE: Optional[Tuple[object, str, str, Optional[str]]] = None


@contextlib.contextmanager
def attention_mesh(mesh, dp_axis: str = "dp", tp_axis: str = "tp",
                   sp_axis: Optional[str] = None):
    """While active, attention sees the mesh; an sp axis of size > 1 (picked
    up when not named) shards the LM's masked attention over a ring."""
    global _ACTIVE
    prev = _ACTIVE
    if sp_axis is None:
        from videoitg_tpu_torch.parallel.mesh import SP_AXIS, mesh_shape

        if mesh_shape(mesh).get(SP_AXIS, 1) > 1:
            sp_axis = SP_AXIS
    _ACTIVE = (mesh, dp_axis, tp_axis, sp_axis)
    try:
        yield
    finally:
        _ACTIVE = prev


def current_attention_mesh() -> Optional[Tuple[object, str, str, Optional[str]]]:
    return _ACTIVE


def sum_over_dp(*tensors):
    """The tensors summed over the active mesh's dp axis (a training step's
    whole-batch statistics, which the JAX package gets from GSPMD); as they
    are when no mesh is active or dp is 1. Not differentiable: for
    statistics of the labels and for metrics."""
    if _ACTIVE is None:
        return tensors
    import torch
    import torch.distributed as dist

    from videoitg_tpu_torch.parallel.mesh import axis_size

    mesh, dp_axis = _ACTIVE[0], _ACTIVE[1]
    if axis_size(mesh, dp_axis) == 1:
        return tensors
    flat = torch.stack([t.detach().float() for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group(dp_axis))
    return tuple(flat[i].to(t.dtype) for i, t in enumerate(tensors))


@contextlib.contextmanager
def no_attention_mesh():
    """Suppress the ambient attention mesh (inside a pipeline stage, where
    attention runs on the stage's own heads with no ring)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = None
    try:
        yield
    finally:
        _ACTIVE = prev


# (mesh, pp_axis, microbatches), consulted by models/qwen2.qwen2_hidden_states;
# see parallel/pipeline.py.
_PIPELINE: Optional[Tuple[object, str, Optional[int]]] = None


@contextlib.contextmanager
def pipeline_mesh(mesh, pp_axis: str = "pp", microbatches: Optional[int] = None):
    """While active, the LM decoder stack runs as a GPipe microbatch pipeline
    over mesh's pp axis (parallel/pipeline.py). microbatches=None defaults to
    the largest divisor of the batch <= pp."""
    global _PIPELINE
    prev = _PIPELINE
    _PIPELINE = (mesh, pp_axis, microbatches)
    try:
        yield
    finally:
        _PIPELINE = prev


def current_pipeline() -> Optional[Tuple[object, str, Optional[int]]]:
    return _PIPELINE
