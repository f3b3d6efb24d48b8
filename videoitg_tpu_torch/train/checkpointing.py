"""Training checkpoints with auto-resume.

Counterpart of videoitg_tpu/train/checkpointing.py (orbax) on `torch.save`:
periodic checkpoints under `<output_dir>/checkpoints/<step>/` with a keep
limit, resume from the newest one, and a forced final save. A checkpoint
holds the step, the model's leaves and the optimizer's state (AdamW moments,
the schedule's position, a pending accumulation). It is written under a
temporary name and renamed, so a reader only ever sees complete checkpoints.

The layout does not depend on the mesh, as orbax's does not: every leaf is
stored whole under its name in the whole model, the moments under their
parameter's name. On a device mesh (`mesh=`) the rank at the mesh's origin
writes, gathering a leaf split over tp from its tp line and a pipeline
stage's layers from their stage, one leaf at a time; a restore slices each
leaf as `parallel/sharding.shard_model` does. So a checkpoint taken on a
mesh resumes with or without one, and one taken without a mesh resumes on
one.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch

from videoitg_tpu_torch.train.train_step import TrainState

_FILE = "state.pt"


class _Layout:
    """How this rank's leaves map to the whole model's: names (a pipeline
    stage's layer i is the model's layer first + i) and slices."""

    def __init__(self, model, mesh, specs):
        from videoitg_tpu_torch.parallel import sharding
        from videoitg_tpu_torch.parallel.mesh import mesh_coords, mesh_shape

        self.mesh = mesh
        self.shape = mesh_shape(mesh) if mesh is not None else {}
        self.coords = mesh_coords(mesh) if mesh is not None else {}
        self.stage = getattr(getattr(model, "lm", None), "pp_layers", None)
        if mesh is None:
            self.specs = {}
        else:
            if specs is None:
                specs = sharding.grounding_param_specs(
                    with_lm_head=hasattr(getattr(model, "lm", None), "lm_head"),
                    pp=self.stage is not None)
            self.specs = sharding.adapt_specs_to_params(specs, model)

    def global_name(self, name: str, stage_first: Optional[int] = None) -> str:
        if self.stage is None or not name.startswith("lm.layers."):
            return name
        first = self.stage[0] if stage_first is None else stage_first
        _, _, idx, rest = name.split(".", 3)
        return f"lm.layers.{first + int(idx)}.{rest}"

    def local_of(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        from videoitg_tpu_torch.parallel.sharding import local_slice

        spec = self.specs.get(name)
        if spec is None or len(spec) != whole.dim():  # a moment's step count is a scalar
            return whole
        return local_slice(name, whole, spec, self.shape, self.coords)

    def writes(self) -> bool:
        return self.mesh is None or all(c == 0 for c in self.coords.values())

    def gather(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's {local name: tensor} -> {global name: whole tensor} on
        the writing rank ({} elsewhere; on a mesh the tensors are moved to
        the CPU). Every rank of the mesh calls it with the same names."""
        if self.mesh is None:
            return {n: t.detach() for n, t in tensors.items()}
        import torch.distributed as dist

        from videoitg_tpu_torch.parallel.mesh import PP_AXIS, TP_AXIS

        tp, pp = self.shape.get(TP_AXIS, 1), self.shape.get(PP_AXIS, 1)
        writer = self.writes()
        # Collectives run where the backend does (NCCL: the card), whatever
        # device a leaf lives on (offloaded moments, step counts).
        device = (torch.device("cuda", torch.cuda.current_device())
                  if self.mesh.device_type == "cuda" else torch.device("cpu"))
        out = {}
        names = sorted(tensors)
        # pp: a stage's layers travel to the writer from the rank of that
        # stage at the origin of every other axis.
        line = self.mesh.mesh.reshape(pp, -1)[:, 0].tolist() if pp > 1 else None
        at_origin = all(c == 0 for a, c in self.coords.items() if a != PP_AXIS)
        per = None if self.stage is None else self.stage[1] - self.stage[0]
        for name in names:
            t = tensors[name].detach().to(device)
            spec = self.specs.get(name, ())
            if tp > 1 and TP_AXIS in spec and len(spec) == t.dim():
                t = _gather_tp(name, t, spec, self.mesh.get_group(TP_AXIS))
            if pp > 1 and name.startswith("lm.layers."):
                if writer:
                    out[self.global_name(name, 0)] = t.cpu()
                    for s in range(1, pp):
                        got = torch.empty_like(t)
                        dist.recv(got, src=line[s])
                        out[self.global_name(name, s * per)] = got.cpu()
                elif at_origin:
                    dist.send(t.contiguous(), dst=line[0])
            elif writer:
                out[self.global_name(name)] = t.cpu()
        return out


def _gather_tp(name, t, spec, group):
    """The whole leaf from every tp rank's slice (`local_slice` undone)."""
    from videoitg_tpu_torch.parallel.mesh import TP_AXIS, all_gather_cat

    if name.endswith(".w_q4") and spec[0] == TP_AXIS:
        from videoitg_tpu_torch.ops.quant import pack_int4, unpack_int4

        return pack_int4(all_gather_cat(unpack_int4(t).contiguous(), group, dim=-2))
    return all_gather_cat(t.contiguous(), group, dim=spec.index(TP_AXIS))


def _mesh_barrier(mesh) -> None:
    """Every rank of the mesh waits for every other (a barrier on each axis
    in turn)."""
    import torch.distributed as dist

    for axis in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(axis))


class TrainCheckpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 2, save_interval: int = 500,
                 async_save: bool = False, mesh=None, specs=None):
        """`async_save` is accepted for the JAX signature's sake; every save
        here is synchronous and durable when `maybe_save` returns. `mesh`
        (every rank of it calls every method) and `specs` (the spec tree the
        model was sharded with; default `grounding_param_specs` for the
        model) say how the ranks' leaves make the whole model."""
        self.directory = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval = save_interval
        self.max_to_keep = max_to_keep
        self.mesh, self.specs = mesh, specs
        del async_save

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def maybe_save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Save at multiples of `save_interval`, or always with `force`. A
        step that is already on disk is not written again."""
        if not force and (self.save_interval <= 0 or step % self.save_interval != 0):
            return False
        final = os.path.join(self.directory, str(step))
        written = os.path.exists(os.path.join(final, _FILE))
        if self.mesh is not None:
            # every rank looks before any rank writes, so all take the same branch
            # (a rank that saw the writer's file would skip the collectives below)
            _mesh_barrier(self.mesh)
        if written:
            return False
        layout = _Layout(state.model, self.mesh, self.specs)
        payload = {"step": int(state.step),
                   "model": layout.gather(state.model.state_dict()),
                   "optimizer": state.optimizer.state_dict(layout.gather)}
        if layout.writes():
            tmp = f"{final}.tmp.{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, _FILE))
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            if self.max_to_keep is not None and self.max_to_keep > 0:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        if self.mesh is not None:
            _mesh_barrier(self.mesh)
        return True

    def restore_latest(self, template: TrainState):
        """Load the newest checkpoint into the template's model and optimizer
        (in place; they give the structure, the slices, devices and dtypes)
        and return (step, state), or (None, None) when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None
        saved = torch.load(os.path.join(self.directory, str(step), _FILE), map_location="cpu",
                           weights_only=True)
        layout = _Layout(template.model, self.mesh, self.specs)
        model_sd = {name: layout.local_of(name, saved["model"][layout.global_name(name)])
                    for name in template.model.state_dict()}
        template.model.load_state_dict(model_sd)
        template.optimizer.load_state_dict(saved["optimizer"], layout.global_name, layout.local_of)
        return step, TrainState(saved["step"], template.model, template.optimizer)

    def close(self) -> None:
        pass
