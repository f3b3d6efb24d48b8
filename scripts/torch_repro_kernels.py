#!/usr/bin/env python3
"""The port's counterpart of scripts/repro_pallas_interpret_vma.py.

The original reproduces a jax fault: a Pallas kernel run in interpret mode
inside a partial-manual `shard_map` fails the varying-manual-axes check,
with a literal in its body (`kernel_literal`, x * 2.0) and without one
(`kernel_no_literal`, x + x). PyTorch has no interpret mode, no `shard_map`
and no counterpart of that fault, so there is nothing to reproduce here: the
port keeps the two kernels, not the bug.

This script builds them (videoitg_tpu_torch/csrc/repro_kernels.cu), launches
both on the card on the original's [8, 128] fp32 shape, and checks them
bit-equal to each other and to their plain PyTorch versions. Exit 0 when
they are; it needs an NVIDIA GPU.

    python3 scripts/torch_repro_kernels.py [--profile]

With `--profile` it then times each kernel and its plain version (`x * 2.0`,
`x + x`, one PyTorch call each) over 200 launches two ways: CUDA events
around the Python calls (the launch path included: ctypes, the wrapper's
checks, the allocation of the output) and torch.profiler's device time per
launch (the kernel alone on the card). The gap between the two says whether
the kernel or the launch path is the slower part.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile(x, reps: int = 200) -> None:
    """Per launch: CUDA-event ms around the calls and the profiler's device
    ms of the kernels they launched, for each kernel and its plain version."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from videoitg_tpu_torch.ops import repro_kernels as rk

    calls = {"double_literal": lambda: rk.double_literal(x),
             "x * 2.0": lambda: rk.double_literal_reference(x),
             "double_no_literal": lambda: rk.double_no_literal(x),
             "x + x": lambda: rk.double_no_literal_reference(x)}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / reps
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device_us, launches = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total:
                device_us += evt.self_device_time_total
                launches += evt.count
        print(f"{name}: {event_ms:.5f} ms a call (CUDA events, launch path included); device "
              f"{device_us / 1e3 / max(launches, 1):.5f} ms a launch over {launches} kernel "
              f"launches (torch.profiler)", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also time the kernels and their plain versions on the device")
    args = parser.parse_args(argv)
    import torch

    from videoitg_tpu_torch.ops import repro_kernels as rk

    if not torch.cuda.is_available():
        print("torch_repro_kernels: no CUDA device found", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 128, generator=gen, device="cuda")
    lit, no_lit = rk.double_literal(x), rk.double_no_literal(x)
    torch.cuda.synchronize()
    checks = {
        "double_literal == double_no_literal": torch.equal(lit, no_lit),
        "double_literal == x * 2.0": torch.equal(lit, rk.double_literal_reference(x)),
        "double_no_literal == x + x": torch.equal(no_lit, rk.double_no_literal_reference(x)),
        "both launched": rk.double_literal.launches >= 1 and rk.double_no_literal.launches >= 1,
    }
    for what, ok in checks.items():
        print(f"{what}: {'ok' if ok else 'FAILED'}")
    print(f"{torch.cuda.get_device_name(0)}: {sum(checks.values())}/{len(checks)} checks hold")
    if args.profile and all(checks.values()):
        profile(x)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
