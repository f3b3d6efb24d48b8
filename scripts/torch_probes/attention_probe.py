"""Probe: kernels A (flash_mha_short) and B (flash_mha) timed outside chip_smoke.py.

    python3 scripts/torch_probes/attention_probe.py --shapes
        A, B (online, Hq == Hkv, no mask) and scaled_dot_product_attention
        on one set of inputs at several shapes: what A's two walks cost
        against one, and what the head dim does to each.
    python3 scripts/torch_probes/attention_probe.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]
        A at [128, 16, 729, 72], B at [1, 28/4, 13056, 128] with and without
        its key mask, and B causal at the VLM prefill's [1, 28/4, 15584, 128],
        in this checkout and in each other one (for example the parent commit
        unpacked by `git archive` into a directory .gitignore lists), each in
        its own process with its own build, in turns: others, this, this, the
        others in reverse.

CUDA events over 20 launches (10 for B) after one warm-up; needs one card.
Read on an NVIDIA H100 80GB HBM3 at 700 W, ms:
  --shapes, with the first TMA version of A (K and V streamed in both
  passes): [128, 16, 729, 72] A 2.0968, B 1.5070, sdpa 1.0683; [.., 729, 80]
  A 1.6877, B 1.2344, sdpa 1.1013; with K resident: [128, 16, 729, 72] A
  1.4787, B 1.5044, sdpa 1.1228; [.., 729, 80] A 1.4544, B 1.2687.
  Against the step before (A with K streamed): A 2.0966 -> 1.4835 / 1.4852,
  B 5.2404 -> 5.2678 / 5.2388, B causal 4.6507 -> 3.8416 / 3.8112; with
  turn-taking between the warpgroups in A: 1.6000 / 1.6096.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernels(root):
    sys.path.insert(0, root)
    from videoitg_tpu_torch.ops.flash_attention import flash_mha
    from videoitg_tpu_torch.ops.flash_attention_short import flash_mha_short

    return flash_mha_short, flash_mha


def shapes() -> None:
    import torch
    from torch.nn import functional as F

    flash_mha_short, flash_mha = kernels(HERE)
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(128, 16, 729, 72), (128, 16, 729, 80), (128, 16, 768, 80), (128, 16, 729, 128),
                  (16, 16, 4096, 72), (1, 28, 13056, 72), (128, 16, 1458, 72)]:
        q, k, v = (torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        print(shape, "A %.4f" % ms(lambda: flash_mha_short(q, k, v)),
              "B-online %.4f" % ms(lambda: flash_mha(q, k, v)),
              "sdpa %.4f" % ms(lambda: F.scaled_dot_product_attention(q, k, v)), flush=True)


def one_checkout(tag: str) -> None:
    import torch

    flash_mha_short, flash_mha = kernels(os.getcwd())
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*sh):
        return torch.randn(*sh, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = r(128, 16, 729, 72), r(128, 16, 729, 72), r(128, 16, 729, 72)
    a_ms = ms(lambda: flash_mha_short(q, k, v))
    s = 13056
    q, k, v = r(1, 28, s, 128), r(1, 4, s, 128), r(1, 4, s, 128)
    valid = torch.rand(1, s, generator=g, device="cuda") > 0.01
    b_ms = ms(lambda: flash_mha(q, k, v, valid=valid), 10)
    b_nomask = ms(lambda: flash_mha(q, k, v), 10)
    s = 15584
    q, k, v = r(1, 28, s, 128), r(1, 4, s, 128), r(1, 4, s, 128)
    valid = torch.ones(1, s, dtype=torch.bool, device="cuda")
    valid[0, 30:32] = False
    c_ms = ms(lambda: flash_mha(q, k, v, valid=valid, causal=True), 10)
    print(f"{tag}: A {a_ms:.4f} B {b_ms:.4f} B-nomask {b_nomask:.4f} B-causal {c_ms:.4f}",
          flush=True)


def main(argv) -> int:
    if argv[:1] == ["--shapes"]:
        shapes()
        return 0
    if argv[:1] == ["--one"]:
        one_checkout(argv[1])
        return 0
    if not argv:
        raise SystemExit(__doc__)
    others = [os.path.abspath(p) for p in argv]
    order = [(o, "other " + o) for o in others] + [(HERE, "this")] * 2 + \
        [(o, "other " + o) for o in reversed(others)]
    for root, tag in order:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tag], cwd=root,
                           capture_output=True, text=True, timeout=600)
        print(p.stdout.strip(), p.stderr.strip()[-500:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
