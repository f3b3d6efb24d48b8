"""Device mesh construction, and the helpers of the data-parallel axis.

Counterpart of videoitg_tpu/parallel/mesh.py. One process per device (launched
by `torchrun`), all running the same program (SPMD): `make_mesh` lays the
ranks of the default process group out as a
`torch.distributed.device_mesh.DeviceMesh` with the JAX axis names and order,
so rank r sits at the mesh coordinates of JAX device r. "dp" shards videos
and questions, "tp" shards attention heads and MLP features inside one
forward, "sp" shards the LM's sequence (ring attention), "pp" shards the
decoder layers into pipeline stages. Tensors stay plain local tensors and
every collective is written out (no DTensor): the kernels are launches on raw
pointers of ordinary tensors.

On the card the backend is NCCL, one process per device on `cuda:LOCAL_RANK`;
gloo serves only a caller that asked for the CPU. A failed NCCL set-up is an
error, never a fall-back to gloo or to the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"
PP_AXIS = "pp"


def init_distributed(cpu: bool) -> Optional[torch.device]:
    """Join the process group that `torchrun` describes in the environment
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), once. Returns
    this rank's device (`cuda:LOCAL_RANK`, or the CPU with `cpu`), or None
    when the environment describes no group of more than one process and none
    is open. The backend is NCCL on the card and gloo on the CPU."""
    if dist.is_initialized():
        return _rank_device(cpu)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    device = _rank_device(cpu)
    if cpu:
        dist.init_process_group("gloo")
    else:
        dist.init_process_group("nccl")
    return device


def open_cli_mesh(args, tool: str):
    """(device, mesh) of a CLI launch with `args.dp/tp/sp/pp` (the flags
    --dp/--tp/--sp/--pp and --cpu): the torchrun group's ranks as a mesh,
    each on its own device; (None, None) with no group open and every axis
    1 (the one-device path). Axes above 1 with no group are a SystemExit
    naming `tool`, never a one-device run."""
    axes = (args.dp, args.tp, args.sp, args.pp)
    if args.dp is None and args.tp is None and args.sp == 1 and args.pp == 1:
        return None, None
    device = init_distributed(args.cpu)
    if not dist.is_initialized():
        if any(n is not None and n > 1 for n in axes):
            raise SystemExit(f"error: {tool}: --dp / --tp / --sp / --pp above 1 need one "
                             f"process per device (launch with torchrun)")
        return None, None
    try:
        return device, make_mesh(dp=args.dp, tp=args.tp, sp=args.sp, pp=args.pp)
    except AssertionError as e:
        raise SystemExit(f"error: {tool}: {e}") from e


def leave_mesh(mesh) -> None:
    """Every rank of a CLI's mesh meets, then the process group is closed, so
    no rank exits while another still talks to it (no mesh: nothing)."""
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()


def _rank_device(cpu: bool) -> torch.device:
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device found (torch.cuda.is_available() is False); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(device)
    return device


def mesh_layout(n: int, dp: Optional[int] = None, tp: Optional[int] = None, sp: int = 1,
                pp: int = 1):
    """(axis names, shape) of the mesh over n ranks, with the JAX package's
    defaults and checks: tp is 4, 2 or 1 by divisibility of the ranks per
    sequence group (the 8B model's 4 KV heads), dp what is left; pp leads and
    sp trails, each only when above 1."""
    per_pipe = n // pp
    assert per_pipe * pp == n, f"pp({pp}) must divide device count ({n})"
    per_seq = per_pipe // sp
    assert per_seq * sp == per_pipe, f"sp({sp}) must divide devices/pp ({per_pipe})"
    if tp is None:
        tp = 4 if per_seq % 4 == 0 else (2 if per_seq % 2 == 0 else 1)
        if dp is not None:
            tp = per_seq // dp
    if dp is None:
        dp = per_seq // tp
    assert dp * tp * sp * pp == n, (
        f"pp({pp}) * dp({dp}) * tp({tp}) * sp({sp}) != devices ({n})")
    if pp > 1:
        axes = (PP_AXIS, DP_AXIS, TP_AXIS) + ((SP_AXIS,) if sp > 1 else ())
        return axes, (pp, dp, tp) + ((sp,) if sp > 1 else ())
    if sp == 1:
        return (DP_AXIS, TP_AXIS), (dp, tp)
    return (DP_AXIS, TP_AXIS, SP_AXIS), (dp, tp, sp)


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None, sp: int = 1, pp: int = 1,
              device_type: Optional[str] = None, ranks: Optional[Sequence[int]] = None):
    """A ([pp,] dp, tp[, sp]) DeviceMesh over `ranks` (default: every rank of
    the open default process group), laid out as `mesh_layout` says. Every
    rank of the group calls it, also one outside `ranks`. device_type
    defaults to "cuda" under NCCL and "cpu" under gloo. On one rank all axes
    are 1."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an open torch.distributed process group "
                           "(launch with torchrun)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    axes, shape = mesh_layout(len(ranks), dp=dp, tp=tp, sp=sp, pp=pp)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=axes)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size}, the JAX mesh's `.shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coords(mesh) -> Dict[str, int]:
    """{axis name: this rank's index on it}."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1) if mesh is not None else 1


def dp_share(n: int, mesh) -> slice:
    """This rank's contiguous share of n items split over dp (n % dp == 0)."""
    dp = axis_size(mesh, DP_AXIS)
    if n % dp:
        raise ValueError(f"{n} items do not split over dp={dp}")
    r = mesh_coords(mesh)[DP_AXIS] if dp > 1 else 0
    return slice(r * n // dp, (r + 1) * n // dp)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's x along `dim`, in group rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_dp(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The dp-split result made whole: the shares of the dp line, in order."""
    if axis_size(mesh, DP_AXIS) == 1:
        return x
    return all_gather_cat(x, mesh.get_group(DP_AXIS), dim=dim)
