"""Pipeline observability: stage timers.

The port's copy of `StageTimer` from videoitg_tpu/utils/profiling.py. The
selection pipeline's stages (decode / preprocess / tower / score) are timed
explicitly on the host clock; frames scored per second fall out of the stage
totals. The JAX package's profiler-trace helpers do not come across.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design
    (one per pipeline worker)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(1, self.counts[name]), 2),
            }
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def frames_per_second(self, total_frames: int, stage: str = "score") -> float:
        t = self.totals.get(stage, 0.0)
        return total_frames / t if t > 0 else 0.0
