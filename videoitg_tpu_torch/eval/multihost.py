"""Rank synchronization for evaluation, in one process.

Counterpart of videoitg_tpu/eval/multihost.py, which gathers per-rank
records over the JAX distributed runtime. Here a run is one process:
`is_multiprocess()` is true only when `torch.distributed` is initialised
with more than one rank, and then `barrier` and `gather_objects` raise,
since collectives across processes are ROADMAP queue 1, item 8. Rank fleets
launched separately with --rank / --world_size need no collective: they
meet through the shared filesystem (eval/harness.py wait_for_ranks +
merge_and_aggregate).
"""

from __future__ import annotations

from typing import Any, List

_NOT_PORTED = ("eval collectives across processes are not ported to PyTorch yet "
               "(ROADMAP queue 1, item 8); launch ranks with --rank / --world_size "
               "and a shared output directory instead")


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def barrier(name: str) -> None:
    """No-op in one process; refused across processes (item 8)."""
    if is_multiprocess():
        raise NotImplementedError(f"barrier {name!r}: {_NOT_PORTED}")


def gather_objects(obj: Any) -> List[Any]:
    """[obj] in one process; refused across processes (item 8)."""
    if is_multiprocess():
        raise NotImplementedError(_NOT_PORTED)
    return [obj]
