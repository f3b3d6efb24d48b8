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

A request is also traced by the port's own spans (utils/profiling.py), which
record while the profiler does: the script prints each stage's device ms
split into its `linear` and `attention` spans and the rest (self time), the
linear spans' share of the bf16 or int8 peak, and every idle gap of the
device put down to the innermost span open on the host when the gap began.
The spans' host stamps and the profiler's events share one clock; probes
before the unit (`record_function` ranges between two `time.time_ns()`
reads) bound the offset between the two, printed in microseconds.
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
    ("add_layer_norm_kernel", "add_layer_norm"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
    ("nvjet", "library GEMMs"),
    ("gemm", "library GEMMs"),
    ("cutlass", "library GEMMs"),
    ("cublas", "library GEMMs"),
)
# Rows of the tracer's own bookkeeping: no work of the request.
TRACER_ROWS = ("Command Buffer Full", "Activity Buffer Request")
PROBE = "clock_probe_"
PEAK = {"bf16": 989e12, "int8": 1979e12}  # one H100 SXM, dense, at 700 W


def _ns(evt, what: str) -> int:
    fn = getattr(evt, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(evt, f"{what}_us")() * 1000)


def clock_probes(n: int = 64):
    """(host stamp before, host stamp inside) of n record_function probes."""
    from torch.profiler import record_function

    stamps = []
    for i in range(n):
        t0 = time.time_ns()
        with record_function(f"{PROBE}{i}"):
            t1 = time.time_ns()
        stamps.append((t0, t1))
    return stamps


def clock_offset_us(events, stamps):
    """Bounds on (profiler clock - time.time_ns), median over the probes: a
    probe's profiler start lies between its two host stamps on one clock."""
    import statistics

    starts = {e.name(): _ns(e, "start") for e in events if e.name().startswith(PROBE)}
    lo, hi = [], []
    for i, (t0, t1) in enumerate(stamps):
        s = starts.get(f"{PROBE}{i}")
        if s is not None:
            lo.append((s - t1) / 1e3)
            hi.append((s - t0) / 1e3)
    return (statistics.median(lo), statistics.median(hi)) if lo else None


def span_path(span, by_id) -> str:
    """The span's names from below the request down to it: 'tower/linear'."""
    names = []
    while span is not None and span.parent is not None:
        names.append(span.name)
        span = by_id[(span.request, span.parent)]
    return "/".join(reversed(names)) or "request"


def idle_by_span(device, spans, t0: int, t1: int):
    """Idle gaps of the device inside [t0, t1] (host ns), by the innermost
    program span open on the host at each gap's start: {path: [s, gaps]}."""
    busy = []
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in device if min(e, t1) > max(s, t0)):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [t0] + [t for iv in busy for t in iv] + [t1]
    by_id = {(sp.request, sp.id): sp for sp in spans}
    out = {}
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        inner = None
        for sp in spans:
            if sp.start_ns <= gs < sp.end_ns and (inner is None or sp.start_ns >= inner.start_ns):
                inner = sp
        key = span_path(inner, by_id) if inner is not None else "no span"
        row = out.setdefault(key, [0.0, 0])
        row[0] += (ge - gs) / 1e9
        row[1] += 1
    return out


def stage_table(spans):
    """Per stage: device ms, its linear and attention children's ms, the rest
    (self time), and the linear children's least time / their time."""
    from videoitg_tpu_torch.utils.profiling import self_ms

    rows = {}
    for st in spans:
        if st.parent != 0 or st.device_ms is None:
            continue
        kids = [k for k in spans if k.request == st.request and k.parent == st.id]
        row = rows.setdefault(st.name, dict(n=0, device_ms=0.0, linear_ms=0.0,
                                             attention_ms=0.0, rest_ms=0.0, least_ms=0.0))
        row["n"] += 1
        row["device_ms"] += st.device_ms
        row["rest_ms"] += self_ms(spans, st)
        for k in kids:
            if k.name == "linear":
                row["linear_ms"] += k.device_ms
                row["least_ms"] += 1e3 * k.args["ops"] / PEAK[k.args["kind"]]
            elif k.name == "attention":
                row["attention_ms"] += k.device_ms
    return rows


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

    from videoitg_tpu_torch.utils import profiling

    for _ in range(2):
        unit()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stamps = clock_probes()
        profiling.clear()
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        unit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1_ns = time.time_ns()
    spans = profiling.read().spans

    groups: dict[str, float] = {}
    counts: dict[str, int] = {}
    kernels = []
    for evt in prof.key_averages():
        # Device-side activities only: a CPU operator's row repeats the device
        # time of the kernels it launched.
        if (evt.device_type != DeviceType.CUDA or evt.key in TRACER_ROWS
                or evt.key.startswith(PROBE)):
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
    events = prof.profiler.kineto_results.events()
    offset = clock_offset_us(events, stamps)
    if offset is not None:
        print(f"clock: profiler - time.time_ns() lies in [{offset[0]:.1f}, {offset[1]:.1f}] us "
              f"(median bounds over {len(stamps)} probes)")
    stages, gaps = {}, {}
    if spans:
        stages = stage_table(spans)
        for name, r in stages.items():
            share = 100 * r["least_ms"] / r["linear_ms"] if r["linear_ms"] else 0.0
            print(f"  span {name} x{r['n']}: device {r['device_ms']:.2f} ms = linear "
                  f"{r['linear_ms']:.2f} + attention {r['attention_ms']:.2f} + rest "
                  f"{r['rest_ms']:.2f}; linear at {share:.2f}% of its peak [{card}]")
        device = [(_ns(e, "start"), _ns(e, "start") + _ns(e, "duration")) for e in events
                  if e.device_type() == DeviceType.CUDA and e.name() not in TRACER_ROWS
                  and not e.name().startswith(PROBE)]
        gaps = idle_by_span(device, spans, t0_ns, t1_ns)
        idle = sum(g for g, _ in gaps.values())
        print(f"  idle {1e3 * idle:.3f} ms of {1e3 * wall:.1f} by the innermost span open [{card}]:")
        for key, (g, n) in sorted(gaps.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"    {1e3 * g:9.3f} ms  {n:6d} gaps  {key}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, out_name), "w") as f:
        json.dump({"card": card, "unit": label, "tier": args.tier, "kernels": args.kernels,
                   "frames": args.frames, "wall_s": wall, "device_busy_ms": busy_ms,
                   "groups_ms": groups, "launches": counts,
                   "clock_offset_us": offset, "span_stages": stages,
                   "idle_by_span_s": {k: v[0] for k, v in gaps.items()},
                   "top_kernels": [dict(ms=m, count=c, name=n) for m, c, n in kernels[:40]]},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
