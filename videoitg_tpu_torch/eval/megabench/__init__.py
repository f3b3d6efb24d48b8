"""MEGA-Bench scoring suite (parity: lmms_eval/tasks/megabench/ — the
standalone evaluator the reference README tells users to run after the
lmms-eval submission step).

Layout: parsing.py (response parsers), conversions.py (type casts +
geometry helpers + latex normalization), scoring.py (the metric
registry), planning.py (the PDDL plan checker), evaluator.py (the
per-task field/aggregation driver). The lmms-eval-side task module is
videoitg_tpu/eval/tasks/megabench.py.
"""

from videoitg_tpu_torch.eval.megabench.evaluator import (  # noqa: F401
    score_query,
    score_task,
)
from videoitg_tpu_torch.eval.megabench.scoring import get_metric  # noqa: F401
