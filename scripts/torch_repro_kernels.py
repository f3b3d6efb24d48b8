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

    python3 scripts/torch_repro_kernels.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
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
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
