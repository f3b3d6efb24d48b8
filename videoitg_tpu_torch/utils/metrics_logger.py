"""Training/eval metrics logging.

Replaces the reference's loguru + optional W&B reporting (SURVEY §5.5):
a structured JSONL metrics stream (one object per step — machine-parseable,
rsync-able from TPU hosts) plus an optional weights-and-biases sink when the
library and an API key are present. `report_to` mirrors the HF flag.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "jsonl",
                 run_name: Optional[str] = None, config: Optional[dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", encoding="utf-8")
        self.wandb = None
        if "wandb" in report_to:
            try:
                import wandb  # optional; not in the base image

                self.wandb = wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "videoitg-tpu"),
                    name=run_name, config=config or {}, resume="allow",
                )
            except Exception as e:
                print(f"[metrics] wandb unavailable ({e}); falling back to jsonl")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def close(self) -> None:
        self._fh.close()
        if self.wandb is not None:
            self.wandb.finish()
