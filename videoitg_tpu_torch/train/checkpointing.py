"""Training checkpoints with auto-resume.

Counterpart of videoitg_tpu/train/checkpointing.py (orbax) on `torch.save`:
periodic checkpoints under `<output_dir>/checkpoints/<step>/` with a keep
limit, resume from the newest one, and a forced final save. A checkpoint
holds the step, the model's state dict and the optimizer's (AdamW moments,
the schedule's position, a pending accumulation). It is written under a
temporary name and renamed, so a reader only ever sees complete checkpoints.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

from videoitg_tpu_torch.train.train_step import TrainState

_FILE = "state.pt"


class TrainCheckpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 2, save_interval: int = 500,
                 async_save: bool = False):
        """`async_save` is accepted for the JAX signature's sake; every save
        here is synchronous and durable when `maybe_save` returns."""
        self.directory = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval = save_interval
        self.max_to_keep = max_to_keep
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
        if os.path.exists(os.path.join(final, _FILE)):
            return False
        tmp = f"{final}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"step": int(state.step), "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, os.path.join(tmp, _FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        if self.max_to_keep is not None and self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        return True

    def restore_latest(self, template: TrainState):
        """Load the newest checkpoint into the template's model and optimizer
        (in place; they give the structure, devices and dtypes) and return
        (step, state), or (None, None) when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None
        saved = torch.load(os.path.join(self.directory, str(step), _FILE), map_location="cpu",
                           weights_only=True)
        template.model.load_state_dict(saved["model"])
        template.optimizer.load_state_dict(saved["optimizer"])
        return step, TrainState(saved["step"], template.model, template.optimizer)

    def close(self) -> None:
        pass
