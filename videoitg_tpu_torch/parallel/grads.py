"""Gradients of a training step on a device mesh: the sum over dp and the
norms of leaves split over tp and pp.

The JAX package gets both from GSPMD. Here each rank holds its slice of
every leaf (parallel/sharding.shard_model) and the gradient of it for its
share of the batch:

* a rank's loss is its share of the whole-batch loss (the losses' statistics
  are summed over dp, parallel/context.sum_over_dp), so the gradients are
  summed over dp;
* tp needs no sum here: the backward of each collective (parallel/tensor.py)
  leaves every rank with the whole gradient of a replicated leaf and its
  own slice's of a split one; sp none either (the ring gathers its
  gradients); pp none (the pipeline broadcasts its input's gradient and
  every stage computes the same loss after it);
* a norm over leaves (the `grad_norm` metric, each label group's clipping
  norm) is the norm of the whole leaves: the squares of a leaf split over
  tp are summed over tp, those of a stage's own layers over pp, and a
  replicated leaf counts once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from videoitg_tpu_torch.parallel.mesh import DP_AXIS, PP_AXIS, TP_AXIS, axis_size

_BUCKET = 1 << 26  # elements a dp all-reduce carries at most


def split_axes(model: torch.nn.Module) -> Dict[int, Tuple[str, ...]]:
    """id(parameter) -> the mesh axes its leaf is split over on this rank:
    "tp" for the weight of a module marked with a `TPShard` (and the bias of
    a column-parallel one), "pp" for the layers of a pipeline stage."""
    staged = getattr(getattr(model, "lm", None), "pp_layers", None) is not None
    out = {}
    for mod_name, mod in model.named_modules():
        t = getattr(mod, "tp", None)
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            axes = ()
            if t is not None and (leaf == "w" or (leaf == "b" and t.kind != "row")):
                axes += (TP_AXIS,)
            if staged and name.startswith("lm.layers."):
                axes += (PP_AXIS,)
            out[id(p)] = axes
    return out


def sum_over_dp(grads: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each gradient summed over the dp axis, in buckets of one dtype."""
    if axis_size(mesh, DP_AXIS) == 1:
        return list(grads)
    group = mesh.get_group(DP_AXIS)
    out = [g.contiguous() for g in grads]
    i = 0
    while i < len(out):
        j, n = i, 0
        while j < len(out) and out[j].dtype == out[i].dtype and (j == i or n + out[j].numel()
                                                                   <= _BUCKET):
            n += out[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1) for g in out[i:j]])
        dist.all_reduce(flat, group=group)
        for k, part in zip(range(i, j), flat.split([g.numel() for g in out[i:j]])):
            out[k] = part.view_as(out[k])
        i = j
    return out


class MeshNorms:
    """norms(param_lists, grad_lists) -> one fp32 norm per list, each the
    norm of the whole leaves, in one collective per axis. With tp and pp
    both 1 every leaf is whole on every rank and the norms are the
    one-device ones (`optimizer.global_norm`), bit for bit."""

    def __init__(self, model: torch.nn.Module, mesh):
        self.axes = split_axes(model)
        self.mesh = mesh
        self.tp = axis_size(mesh, TP_AXIS)
        self.pp = axis_size(mesh, PP_AXIS)

    def __call__(self, param_lists, grad_lists) -> List[torch.Tensor]:
        from videoitg_tpu_torch.train.optimizer import global_norm

        if self.tp == 1 and self.pp == 1:
            return [global_norm(g) for g in grad_lists]
        # columns: split over tp and pp, over tp only, over pp only, whole
        col = {(TP_AXIS, PP_AXIS): 0, (TP_AXIS,): 1, (PP_AXIS,): 2, (): 3}
        device = next(g.device for grads in grad_lists for g in grads)
        table = torch.zeros((len(grad_lists), 4), dtype=torch.float32, device=device)
        for r, (params, grads) in enumerate(zip(param_lists, grad_lists)):
            for p, g in zip(params, grads):
                table[r, col[self.axes.get(id(p), ())]] += torch.linalg.vector_norm(
                    g, dtype=torch.float32).square()
        if self.tp > 1:
            part = table[:, 0:2].contiguous()
            dist.all_reduce(part, group=self.mesh.get_group(TP_AXIS))
            table[:, 0:2] = part
        if self.pp > 1:
            part = table[:, [0, 2]].contiguous()
            dist.all_reduce(part, group=self.mesh.get_group(PP_AXIS))
            table[:, [0, 2]] = part
        return list(table.sum(dim=1).sqrt())
