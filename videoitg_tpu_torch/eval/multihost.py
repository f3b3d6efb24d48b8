"""Collective rank synchronisation for evaluation over torch.distributed.

Counterpart of videoitg_tpu/eval/multihost.py. The reference gathers per-rank
samples and metrics to rank 0 with torch.distributed.gather_object behind a
dist.barrier (lmms_eval/evaluator.py:553-573); here every rank of the open
process group (gloo on the CPU, NCCL on the card) meets at `dist.barrier`
and receives every rank's records through `dist.all_gather_object`, so no
shared filesystem is needed. Python objects ride the collective as JSON
text, as in the JAX package. Rank fleets launched separately with --rank /
--world_size meet through the shared filesystem instead
(eval/harness.py wait_for_ranks + merge_and_aggregate).
"""

from __future__ import annotations

import json
from typing import Any, List


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def barrier(name: str) -> None:
    """Barrier across every rank of the process group (no-op in one process)."""
    if not is_multiprocess():
        return
    import torch.distributed as dist

    dist.barrier()


def gather_objects(obj: Any) -> List[Any]:
    """Allgather one JSON-serializable object per rank.

    Every rank receives the full list, indexed by rank. Must be called by ALL
    ranks (it is a collective). Single process: [obj]."""
    if not is_multiprocess():
        return [obj]
    import torch.distributed as dist

    payload = json.dumps(obj, ensure_ascii=False, default=str)
    gathered: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, payload)
    return [json.loads(p) for p in gathered]
