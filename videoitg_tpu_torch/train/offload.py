"""Host offload of optimizer state (the ZeRO-offload equivalent on one card).

Counterpart of videoitg_tpu/train/offload.py. Between steps the Adam moments
live in pinned host memory; each step copies them to the device, updates, and
parks the result on the host again (the DeepSpeed-offload cadence). It saves
the moments' device memory (8 bytes a trained fp32 parameter) for the length
of the forward and backward pass and costs two PCIe copies of them a step.

Only a CUDA device has a host to offload to; callers gate on
`supports_host_offload` and go on without it elsewhere, as the JAX CLI does.
"""

from __future__ import annotations

import torch

from videoitg_tpu_torch.train.optimizer import GroupedAdamW

_MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


def supports_host_offload(device: torch.device) -> bool:
    return torch.device(device).type == "cuda"


def offload_opt_state(tx: GroupedAdamW) -> int:
    """Move every Adam moment that lies on a CUDA device to pinned host
    memory. Returns the bytes parked (0 before the first update: AdamW
    creates its state then)."""
    parked = 0
    for state in tx.optimizer.state.values():
        for key in _MOMENTS:
            t = state.get(key)
            if t is not None and t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
                host.copy_(t, non_blocking=True)
                state[key] = host
                parked += t.numel() * t.element_size()
    if parked:
        torch.cuda.synchronize()  # the device copies are freed after this returns
    return parked


def fetch_opt_state(tx: GroupedAdamW) -> None:
    """Bring every parked moment back to its parameter's device."""
    for param, state in tx.optimizer.state.items():
        for key in _MOMENTS:
            if key in state and state[key].device != param.device:
                state[key] = state[key].to(param.device, non_blocking=True)


def make_offloaded_train_step(step_fn):
    """Wrap a train step so that the optimizer state lives on the host
    between steps."""

    def wrapped(state, batch):
        fetch_opt_state(state.optimizer)
        new_state, metrics = step_fn(state, batch)
        offload_opt_state(new_state.optimizer)
        return new_state, metrics

    return wrapped
