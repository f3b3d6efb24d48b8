#!/usr/bin/env python3
"""Where one selection request, or one training step, of the PyTorch port
spends its device time.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/torch_profile_request.py --tier act8 --kernels on
    python3 scripts/torch_profile_request.py --tier bf16
    python3 scripts/torch_profile_request.py --hit --splash on
    python3 scripts/torch_profile_request.py --train
    python3 scripts/torch_profile_request.py --train --objective vlm --arm train-jax

Builds VideoITG-8B (random weights from --seed) in the given tier, runs two
untimed 512-frame `SelectionEngine.select` requests, then one under
torch.profiler (CPU + CUDA activities). With `--hit` the profiled unit is
what the serving daemon does on an encoded-video cache hit:
`score_encoded` of one prompt on tower features encoded beforehand
(projector + LM + head; `--splash on` sends the LM's attention through the
splash arm). With `--train` the profiled unit is
one LoRA r16 training step (bf16 base, remat, the differentiable attention
kernels) on a feature batch of `--frames` frames (default 1024, hw 4,
16,640 tokens), after two untimed steps; `--objective vlm` makes it a VLM
SFT step of the causal, tied variant on a video sample of `--frames` uint8
frames (default 256, hw 8, 16,960 tokens, the frozen tower in the step), and
`--arm train-jax` sends either objective's attention through the segment-id
kernels (kernel J) instead of the native-GQA ones (C, D, E). Prints the unit's wall time, the
summed device time of its kernels, the idle share (1 - device / wall), the
device time by group (the port's own kernels by name, library GEMMs, copies,
all other PyTorch kernels) and the largest single kernels, each line with
the card's name and power limit. Writes the same as JSON under chiprun_out/.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Kernel-name fragments -> group, first match wins: the int8 GEMM's instances
# (hgemm::gemm_kernel<policy>) by their epilogue policy, before the
# "gemm" fragment of the library's kernels. The two row quantisers serve two
# kernels each (`row_quant_kernel` F and I, `ln_quant_kernel` G and H): they
# are a group of their own, and the top-kernels list gives each one's time
# and launches.
GROUPS = (
    ("hattn::resident_kernel", "kernel A flash_mha_short"),
    ("row_quant_kernel", "int8 row quantisation (F, G, H, I)"),
    ("ln_quant_kernel", "int8 row quantisation (F, G, H, I)"),
    ("Act8Out", "kernel F act8_gemm"),
    ("QkvOut", "kernel G fused_ln_qkv_int8"),
    ("RowAmax", "kernel H fused_ln_mlp_int8"),
    ("QuantStore", "kernel H fused_ln_mlp_int8"),
    ("ScaleOfAmax", "kernel H fused_ln_mlp_int8"),
    ("ScaleGiven", "kernel I fused_proj_residual_int8"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
    ("nvjet", "library GEMMs"),
    ("gemm", "library GEMMs"),
    ("cutlass", "library GEMMs"),
    ("cublas", "library GEMMs"),
)
# Rows of the tracer's own bookkeeping: no work of the request.
TRACER_ROWS = ("Command Buffer Full", "Activity Buffer Request")


def group_of(name: str) -> str:
    # stream_kernel<DP, kTwoPass, kLse, Policy, order>: with segment ids J's
    # forward (the lse store) or else kernel K; with the key mask kernel C
    # with the lse store, A in its two-pass mode beyond resident K, else B.
    if "hattn::stream_kernel" in name:
        if "SegmentIds" in name:
            return ("kernel J flash_segment_fwd" if ", false, true," in name
                    else "kernel K splash_mqa")
        if ", false, true," in name:
            return "kernel C flash_train_fwd"
        return "kernel A flash_mha_short" if ", true, false," in name else "kernel B flash_mha"
    # dq_kernel<DP, Policy> and dkv_kernel<DP, Policy, order>: kernels D and E
    # with the key mask, J's dQ and dK/dV with segment ids.
    if "hattn::dq_kernel" in name:
        return ("kernel J flash_segment_dq" if "SegmentIds" in name
                else "kernel D flash_train_dq")
    if "hattn::dkv_kernel" in name:
        return ("kernel J flash_segment_dkv" if "SegmentIds" in name
                else "kernel E flash_train_dkv")
    for fragment, group in GROUPS:
        if fragment in name:
            return group
    return "other PyTorch kernels (elementwise, reductions, casts)"


def make_vlm_train_unit(model, cfg, dev, frames: int, seed: int, use_flash):
    """A closure that takes one LoRA r16 VLM SFT step of the causal, tied
    variant on one synthetic video sample of `frames` uint8 frames (hw = the
    inference hw of that many frames, 30 + 200 text tokens, 150 labels)."""
    import dataclasses

    import numpy as np
    import torch

    from videoitg_tpu_torch.train.lora import add_lora, make_lora_optimizer
    from videoitg_tpu_torch.train.train_step import create_train_state, run_step
    from videoitg_tpu_torch.train.vlm_sft import VLMSample, collate_vlm, make_vlm_train_step

    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, causal=True,
                                                           tie_word_embeddings=True))
    add_lora(model, torch.Generator(device=dev).manual_seed(seed + 30), rank=16)
    tx = make_lora_optimizer(model, learning_rate=2e-4, total_steps=10)
    rng = np.random.default_rng(seed + 31)
    post = rng.integers(1, cfg.lm.vocab_size, 200).tolist()
    sample = VLMSample(rng.integers(0, 256, (frames, 360, 640, 3), dtype=np.uint8),
                       rng.integers(1, cfg.lm.vocab_size, 30).tolist(), post,
                       [-100] * 50 + post[50:])
    batch = collate_vlm([sample], frames, cfg, dtype=torch.bfloat16, device=dev)
    hw = cfg.projector.tokens_hw(frames, cfg.vision.num_patches_per_side)
    step_fn = make_vlm_train_step(cfg, tx, hw=hw, use_flash=use_flash, remat=True)
    holder = [create_train_state(model, tx)]

    def unit():
        holder[0], _ = run_step(step_fn, holder[0], batch)

    return unit


def make_train_unit(model, cfg, dev, frames: int, seed: int, use_flash=True):
    """A closure that takes one LoRA r16 training step on a synthetic feature
    batch of `frames` frames (hw = the inference hw of that many frames)."""
    import torch

    from videoitg_tpu_torch.models.grounding import GroundingBatch
    from videoitg_tpu_torch.train.lora import add_lora, make_lora_optimizer
    from videoitg_tpu_torch.train.train_step import (
        create_train_state,
        make_train_step,
        run_step,
    )

    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    add_lora(model, gen, rank=16)
    tx = make_lora_optimizer(model, learning_rate=2e-4, out_proj_lr=2e-4, total_steps=10)
    hw = cfg.projector.tokens_hw(frames, cfg.vision.num_patches_per_side)
    batch = GroundingBatch(
        frames=torch.randn(1, frames, cfg.vision.num_patches, cfg.vision.hidden_size,
                           generator=gen, device=dev, dtype=torch.bfloat16),
        frame_valid=torch.ones(1, frames, dtype=torch.bool, device=dev),
        text_ids=torch.randint(0, cfg.lm.vocab_size, (1, cfg.max_text_len), generator=gen,
                               device=dev),
        text_valid=torch.arange(cfg.max_text_len, device=dev)[None] < 40,
        labels=(torch.rand(1, frames, generator=gen, device=dev) < 0.1).float())
    step_fn = make_train_step(cfg, tx, hw=hw, use_flash=use_flash, remat=True)
    holder = [create_train_state(model, tx)]

    def unit():
        holder[0], _ = run_step(step_fn, holder[0], batch)

    return unit


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tier", choices=["bf16", "int8", "int4", "act8"], default="bf16")
    p.add_argument("--kernels", choices=["on", "off"], default="on",
                   help="act8 only: the hand-written int8 kernels (both switches) on or off")
    p.add_argument("--hit", action="store_true",
                   help="profile the daemon's cache-hit path (score_encoded) instead of "
                        "a whole request")
    p.add_argument("--splash", choices=["on", "off"], default="off",
                   help="the LM's splash attention arm (kernel K) instead of kernel B")
    p.add_argument("--train", action="store_true",
                   help="profile one LoRA training step instead of a request")
    p.add_argument("--objective", choices=["grounding", "vlm"], default="grounding",
                   help="with --train: the grounding step on a feature batch, or a VLM SFT "
                        "step on a video sample")
    p.add_argument("--arm", choices=["train", "train-jax"], default="train",
                   help="with --train: the native-GQA attention kernels (C, D, E) or the "
                        "segment-id ones (J)")
    p.add_argument("--frames", type=int, default=None,
                   help="default: 512 for a request, 1024 for a grounding step, 256 for a "
                        "VLM step")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.frames is None:
        args.frames = 512 if not args.train else (256 if args.objective == "vlm" else 1024)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_request: needs an NVIDIA GPU")
    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.engine import SelectionEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, cfg, tok = load_grounding_components(
        None, "videoitg-8b", True, torch.bfloat16, dev, seed=args.seed,
        quantize=None if args.tier == "bf16" or args.train else args.tier)
    if args.train:
        make_unit = make_vlm_train_unit if args.objective == "vlm" else make_train_unit
        unit = make_unit(model, cfg, dev, args.frames, args.seed,
                         use_flash=True if args.arm == "train" else "train-jax")
    else:
        on = args.kernels == "on"
        engine = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16,
                                 qgemm=on, fused=on, lm_splash=args.splash == "on")
        frames = np.random.default_rng(args.seed + 2).integers(
            0, 256, (args.frames, 360, 640, 3), dtype=np.uint8)
        sampled = list(range(args.frames))

        if args.hit:
            enc = engine.encode_video(frames)

            def unit():
                engine.score_encoded(enc, ["What is the person holding?"])
        else:
            def unit():
                engine.select(frames, sampled, "What is the person holding?")

    for _ in range(2):
        unit()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        unit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    groups: dict[str, float] = {}
    counts: dict[str, int] = {}
    kernels = []
    for evt in prof.key_averages():
        # Device-side activities only: a CPU operator's row repeats the device
        # time of the kernels it launched.
        if evt.device_type != DeviceType.CUDA or evt.key in TRACER_ROWS:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us <= 0:
            continue
        g = group_of(evt.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        counts[g] = counts.get(g, 0) + evt.count
        kernels.append((us / 1e3, evt.count, evt.key))
    busy_ms = sum(groups.values())
    if busy_ms <= 0:
        raise SystemExit("torch_profile_request: the profiler recorded no device time")
    if args.train:
        label, out_name = "train, LoRA r16", "profile_train_lora.json"
        if args.objective == "vlm" or args.arm != "train":
            label = f"train {args.objective}, LoRA r16, arm {args.arm}"
            out_name = f"profile_train_{args.objective}_{args.arm}.json"
    else:
        label = args.tier + (f", int8 kernels {args.kernels}" if args.tier == "act8" else "")
        out_name = f"profile_{args.tier}_{args.kernels}.json"
        if args.hit or args.splash == "on":
            label += f", {'cache hit' if args.hit else 'request'}, splash {args.splash}"
            out_name = (f"profile_{args.tier}_{args.kernels}_{'hit' if args.hit else 'request'}"
                        f"_splash_{args.splash}.json")
    print(f"profile [{label}] {args.frames} frames: wall {wall:.4f} s, device busy "
          f"{busy_ms / 1e3:.4f} s, idle share {100 * (1 - busy_ms / 1e3 / wall):.2f}% [{card}]")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {ms:.2f} ms ({100 * ms / busy_ms:.2f}%), {counts[g]} launches [{card}]")
    kernels.sort(reverse=True)
    for ms, count, name in kernels[:12]:
        print(f"    {ms:9.2f} ms  {count:5d} x  {name[:110]}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, out_name), "w") as f:
        json.dump({"card": card, "unit": label, "tier": args.tier, "kernels": args.kernels,
                   "frames": args.frames, "wall_s": wall, "device_busy_ms": busy_ms,
                   "groups_ms": groups, "launches": counts,
                   "top_kernels": [dict(ms=m, count=c, name=n) for m, c, n in kernels[:40]]},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
