"""One request of a run, as the clients in traffic/kinds/ report it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Request:
    video: int          # index in the traffic's video pool
    group: int          # requests of one group share their video's encoding
    instruction: str
    frames: int         # frames scored a question
    questions: int
    encoded: bool       # whether this request ran the tower
    scores: Optional[np.ndarray] = None  # [frames] sigmoid scores, on the host
    t_issue: float = 0.0
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_issue
