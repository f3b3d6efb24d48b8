"""A cell of BENCHMARK.json cut to the port's `tiny` preset and small
frames, for runs of the whole harness on the CPU."""

import copy
import dataclasses
import time

import torch

from benchmark.harness import run_cell
from benchmark.manifest import Manifest


# The tiny model's own limits where the 8B's do not hold for it: at these
# widths a row holds 32 to 128 values, and the act8 path's per-row int8
# rounding reads ~2.5x the 8B model's (logit_crms 0.039 against 0.0154).
TINY_CHECK = {"videoitg-8b-act8": {"logit_max": 0.2, "logit_crms": 0.08, "logit_shift": 0.05}}
# a mix's sizes cut to the tiny model
TINY_MIX = dict(frames=8, height=48, width=64, grid=[3, 4], instructions=12, chars=[10, 30])


def tiny_cell(workload: str, **mix_changes):
    from videoitg_tpu_torch.config import preset

    man = Manifest()
    wl = man.workload(workload)
    cfg = copy.deepcopy(man.config(wl))
    cfg["model"] = dataclasses.asdict(preset("tiny"))
    cfg["check"] = TINY_CHECK.get(cfg["name"], cfg["check"])
    mix = dict(man.mix(wl), **TINY_MIX)
    mix.update(mix_changes)
    return man, wl, cfg, mix


def run_tiny(workload: str, seed: int = 20261018, seconds: float = 0.3, trace: bool = False,
             cfg_changes=None, **mix_changes) -> dict:
    man, wl, cfg, mix = tiny_cell(workload, **mix_changes)
    if cfg_changes:
        cfg.update(cfg_changes)
    metrics = man.per_layer(wl) if trace else man.end_to_end(wl)
    return run_cell(cfg, mix, man.client(mix), man.readers(metrics), seed, seconds, trace,
                    torch.device("cpu"), time.perf_counter())
