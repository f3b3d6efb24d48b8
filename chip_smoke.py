#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (videoitg_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. Device: refuses to run without CUDA; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for fp32 matmuls and convolutions
   (the fp32 resize and pool matmuls rely on full fp32).
2. Build: compiles the hand-written kernels (videoitg_tpu_torch/csrc/*.cu)
   into the ignored build directory and prints the build time.
3. Kernels: each kernel against its plain PyTorch version on the same
   bf16-rounded inputs at the main-path shapes, plus a long case whose
   length is not a multiple of the 64-key tile, a small causal case and a
   fully-masked-row case. Tolerance: 4 bf16 half-ulps of the case's
   max|reference| (see bf16_tol). Masked rows must be exactly 0. At each
   main-path shape, deliberately broken uses of the kernel (keys dropped,
   the key mask ignored) must exceed that tolerance, which shows that it
   discriminates.
4. Agreement: the engine's kernel path against its plain path on a small
   input at the full widths of VideoITG-8B (videoitg-8b-shallow: 3 vision,
   2 LM layers), tolerance E2E_ATOL on the sigmoid scores.
5. Slice: VideoITG-8B in bf16 with random weights from a seeded
   torch.Generator, through SelectionEngine: select on 512 frames (twice:
   cold, warm), select on 100 frames, select_many with 3 questions. Launch
   counters are zeroed right before this phase and read right after it;
   every kernel of the path must have launched. Scores must be finite in
   [0, 1], and each `index` a permutation of the sampled frames.

The last two lines are the per-kernel JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
E2E_ATOL = 2e-2     # sigmoid scores, bf16 kernel path vs bf16 plain path
FRAME_HW = (360, 640)  # a video-like decode resolution


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_tol(ref) -> float:
    """4 bf16 half-ulps of max|ref| (bf16 keeps 8 significant bits): the
    output's own rounding takes at most one, bf16 P and the fp32 summation
    order take the rest."""
    return 4 * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 8)


def max_err(out, ref) -> float:
    return (out.float() - ref).abs().max().item()


def lm_reference(q, k, v, valid, causal=False):
    """flash_mha_reference in fp32, head by head: one head's scores at
    S = 13,056 take 0.7 GB."""
    import torch

    from videoitg_tpu_torch.ops.flash_attention import flash_mha_reference

    group = q.shape[1] // k.shape[1]
    return torch.cat([flash_mha_reference(q[:, h:h + 1].float(),
                                          k[:, h // group:h // group + 1].float(),
                                          v[:, h // group:h // group + 1].float(),
                                          valid=valid, causal=causal)
                      for h in range(q.shape[1])], dim=1)


def check_kernels(dev) -> dict:
    """Each kernel vs its plain version; returns name -> record."""
    import torch

    from videoitg_tpu_torch.ops.flash_attention import flash_mha, flash_mha_reference
    from videoitg_tpu_torch.ops.flash_attention_short import (
        flash_mha_short,
        flash_mha_short_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    records = {}

    # Kernel A at the tower's shape: 128 frames x 16 heads x 729 x 72.
    q, k, v = (randn(128, 16, 729, 72) for _ in range(3))
    ref = torch.cat([flash_mha_short_reference(q[i:i + 32].float(), k[i:i + 32].float(),
                                               v[i:i + 32].float())
                     for i in range(0, 128, 32)])
    tol = bf16_tol(ref)
    err = max_err(flash_mha_short(q, k, v), ref)
    # What a kernel that dropped the last 64 keys would give (the kernel
    # takes k/v of q's length only, so the plain version stands in for it).
    drop = max(max_err(flash_mha_short_reference(q[i:i + 32].float(), k[i:i + 32, :, :665].float(),
                                                 v[i:i + 32, :, :665].float()), ref[i:i + 32])
               for i in range(0, 128, 32))
    ms = cuda_ms(lambda: flash_mha_short(q, k, v), 20)
    plain_ms = cuda_ms(lambda: [flash_mha_short_reference(q[i:i + 32], k[i:i + 32], v[i:i + 32])
                                for i in range(0, 128, 32)], 3)
    print(f"kernel flash_mha_short [128, 16, 729, 72] bf16: max_abs_err {err:.6g} "
          f"(tol {tol:.6g}, max|ref| {ref.abs().max().item():.6g}); broken: last 64 keys "
          f"dropped {drop:.6g}; {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    if not err <= tol:
        fail(f"flash_mha_short error {err} > {tol}")
    if not drop > tol:
        fail(f"flash_mha_short tolerance {tol} does not catch dropped keys ({drop})")
    records["flash_mha_short"] = dict(
        name="flash_mha_short", route="cuda",
        source="videoitg_tpu_torch/csrc/flash_attention_short.cu",
        replaces="videoitg_tpu/ops/flash_attention_short.py:81",
        max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del q, k, v, ref

    # Kernel B at the LM's shape: 512 frames x 25 slots + 256 text slots
    # (13,056 = 204 x 64 keys), ~1% invalid keys plus the padded text tail.
    s = 512 * 25 + 256
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    valid = torch.rand(1, s, generator=gen, device=dev) > 0.01
    valid[:, 512 * 25 + 40:] = False
    ref = lm_reference(q, k, v, valid)
    tol = bf16_tol(ref)
    out = flash_mha(q, k, v, valid=valid)
    err = max_err(out, ref)
    masked = out[0][:, ~valid[0]].abs().max().item()
    # Broken uses, compared on the query rows both keep valid: the key mask
    # ignored, and one 64-key tile dropped.
    rows = valid[0]
    no_mask = max_err(flash_mha(q, k, v)[:, :, rows], ref[:, :, rows])
    dropped = valid.clone()
    dropped[:, 6400:6464] = False
    rows = dropped[0]
    no_tile = max_err(flash_mha(q, k, v, valid=dropped)[:, :, rows], ref[:, :, rows])
    ms = cuda_ms(lambda: flash_mha(q, k, v, valid=valid), 10)
    plain_ms = cuda_ms(lambda: [flash_mha_reference(q[:, h:h + 1], k[:, h // 7:h // 7 + 1],
                                                    v[:, h // 7:h // 7 + 1], valid=valid)
                                for h in range(28)], 2)
    print(f"kernel flash_mha [1, 28/4, {s}, 128] bf16, {int((~valid).sum())} invalid keys: "
          f"max_abs_err {err:.6g} (tol {tol:.6g}, max|ref| {ref.abs().max().item():.6g}), "
          f"invalid rows max {masked}; broken: key mask ignored {no_mask:.6g}, one key tile "
          f"dropped {no_tile:.6g}; {ms:.4f} ms, plain {plain_ms:.4f} ms (plain head by head)",
          flush=True)
    if not err <= tol:
        fail(f"flash_mha error {err} > {tol}")
    if masked != 0.0:
        fail("flash_mha: invalid query rows are not exactly 0")
    if not (no_mask > tol and no_tile > tol):
        fail(f"flash_mha tolerance {tol} does not catch a broken kernel "
             f"({no_mask}, {no_tile})")
    records["flash_mha"] = dict(
        name="flash_mha", route="cuda", source="videoitg_tpu_torch/csrc/flash_attention.cu",
        replaces="videoitg_tpu/ops/flash_attention.py:59",
        max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del q, k, v, out, ref

    # A long length that is not a multiple of the 64-key tile (13,001 =
    # 203 x 64 + 9): the ragged last tile is masked in the kernel.
    s = 13001
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    valid = torch.rand(1, s, generator=gen, device=dev) > 0.01
    ref = lm_reference(q, k, v, valid)
    tol = bf16_tol(ref)
    out = flash_mha(q, k, v, valid=valid)
    err = max_err(out, ref)
    masked = out[0][:, ~valid[0]].abs().max().item()
    print(f"kernel flash_mha ragged [1, 28/4, {s}, 128]: max_abs_err {err:.6g} "
          f"(tol {tol:.6g}); invalid rows max {masked}", flush=True)
    if not err <= tol or masked != 0.0:
        fail("flash_mha ragged-length case")
    records["flash_mha"]["max_abs_err"] = max(records["flash_mha"]["max_abs_err"], err)
    del q, k, v, out, ref

    # Small causal GQA case, and a batch whose keys are all invalid.
    b, s = 2, 1000
    q, k, v = randn(b, 28, s, 128), randn(b, 4, s, 128), randn(b, 4, s, 128)
    valid = torch.rand(b, s, generator=gen, device=dev) > 0.1
    valid[0, :5] = False  # causal rows 0..4 of batch 0 see no valid key
    out = flash_mha(q, k, v, valid=valid, causal=True)
    ref = flash_mha_reference(q.float(), k.float(), v.float(), valid=valid, causal=True)
    tol = bf16_tol(ref)
    err = max_err(out, ref)
    zero_rows = out[0, :, :5].abs().max().item()
    valid[1] = False
    out = flash_mha(q, k, v, valid=valid)
    all_masked = out[1].abs().max().item()
    print(f"kernel flash_mha causal [2, 28/4, 1000, 128]: max_abs_err {err:.6g} "
          f"(tol {tol:.6g}); rows with no visible valid key max {zero_rows}; fully masked "
          f"batch max {all_masked}", flush=True)
    if not err <= tol or zero_rows != 0.0 or all_masked != 0.0:
        fail("flash_mha causal / fully-masked case")
    records["flash_mha"]["max_abs_err"] = max(records["flash_mha"]["max_abs_err"], err)
    torch.cuda.synchronize()
    return records


def frames_u8(rng, t: int):
    import numpy as np

    return rng.integers(0, 256, (t,) + FRAME_HW + (3,), dtype=np.uint8)


def check_agreement(dev) -> None:
    """Kernel path vs plain path of the engine at full width, small input."""
    import numpy as np
    import torch

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.engine import SelectionEngine

    model, cfg, tok = load_grounding_components(None, "videoitg-8b-shallow", True,
                                                torch.bfloat16, dev, seed=SEED)
    frames = frames_u8(np.random.default_rng(SEED + 1), 8)
    scores = {}
    for use_flash in (True, False):
        eng = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16,
                              use_flash=use_flash, buckets=(8,))
        scores[use_flash] = eng.select(frames, list(range(8)), "where is the dog?").raw_scores
    diff = float(np.abs(scores[True] - scores[False]).max())
    print(f"agreement videoitg-8b-shallow, 8 frames: kernel vs plain path max |score diff| "
          f"{diff:.6g} (atol {E2E_ATOL}); kernel {np.round(scores[True], 4).tolist()}",
          flush=True)
    if not diff <= E2E_ATOL:
        fail(f"kernel path disagrees with the plain path: {diff} > {E2E_ATOL}")
    del model
    torch.cuda.empty_cache()


def check_result(res, sampled) -> None:
    import numpy as np

    sc = np.asarray(res.raw_scores)
    if sc.shape != (len(sampled),) or not np.all(np.isfinite(sc)):
        fail(f"scores of shape {sc.shape} or not finite")
    if sc.min() < 0.0 or sc.max() > 1.0:
        fail("scores outside [0, 1]")
    if sorted(res.index) != sorted(sampled):
        fail("index is not a permutation of the sampled frames")


def run_slice(dev, card: str) -> dict:
    """The main path at full width; returns kernel launch counts."""
    import numpy as np
    import torch

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.ops.flash_attention import flash_mha
    from videoitg_tpu_torch.ops.flash_attention_short import flash_mha_short

    t0 = time.perf_counter()
    model, cfg, tok = load_grounding_components(None, "videoitg-8b", True, torch.bfloat16, dev,
                                                seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"videoitg-8b bf16 random init: {n_params / 1e9:.3f} B params, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    engine = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 2)
    video512, video100 = frames_u8(rng, 512), frames_u8(rng, 100)
    sampled512 = [2 * i for i in range(512)]
    sampled100 = [3 * i for i in range(100)]
    questions = ["What is the person holding?", "When does the car turn left?",
                 "Which scene shows the rocket launch?"]

    flash_mha.launches = 0
    flash_mha_short.launches = 0
    torch.cuda.reset_peak_memory_stats()
    requests = [
        ("select 512 frames (cold)", 512, lambda: [engine.select(video512, sampled512,
                                                                 questions[0])], sampled512),
        ("select 512 frames (warm)", 512, lambda: [engine.select(video512, sampled512,
                                                                 questions[1])], sampled512),
        ("select 100 frames", 100, lambda: [engine.select(video100, sampled100,
                                                          questions[2])], sampled100),
        ("select_many 512 frames x 3 questions", 512,
         lambda: engine.select_many(video512, sampled512, questions), sampled512),
    ]
    for name, n_frames, fn, sampled in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for res in results:
            check_result(res, sampled)
        print(f"request {name}: {wall:.4f} s, {n_frames / wall:.2f} frames/s, "
              f"top8 {results[0].topk(8)} [{card}]", flush=True)
    launches = {"flash_mha": flash_mha.launches, "flash_mha_short": flash_mha_short.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory {peak / 2**30:.3f} GiB; stages "
          f"{json.dumps(engine.timer.summary())} [{card}]", flush=True)
    print(f"main-path launches {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} never launched on the main path")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "videoitg_tpu_torch")):
        fail("run from a checkout of the repository (videoitg_tpu_torch/ not found)")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    from videoitg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'}) "
          f"-> {os.path.relpath(path, HERE)}", flush=True)

    records = check_kernels(dev)
    check_agreement(dev)
    launches = run_slice(dev, card)
    for name, rec in records.items():
        rec["launches"] = launches[name]
    if "jax" in sys.modules:
        fail("the port imported jax")
    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
