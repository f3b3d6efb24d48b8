#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (videoitg_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. Device: refuses to run without CUDA; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for fp32 matmuls and convolutions
   (the fp32 resize and pool matmuls rely on full fp32).
2. Build: compiles the hand-written kernels (videoitg_tpu_torch/csrc/*.cu,
   one nvcc per source, started together) into the ignored build directory
   and prints the build time and ptxas' resource lines.
3. Kernels: each kernel against its plain PyTorch version on the same
   inputs at the main-path shapes, timed with CUDA events beside its plain
   version, its bound (the larger of operations / peak rate and bytes /
   memory rate) and, for the attention kernels, one library call
   (scaled_dot_product_attention; timed here, never used by the port).
   * C, D, E (trainable attention: forward + lse, dQ, dK/dV) at the LM's
     training shape [1, 28/4, 16640, 128] with a 16,500-token valid prefix
     (plain versions run whole, one query head of each group at a time), a
     ragged S = 4,101, a causal two-row case with dead rows, two rows of
     different valid lengths, D = 72 with GQA, eight head dims from 8 to 128
     at S = 130 (every instantiation runs), each causal and not, causal at
     the VLM SFT step's [1, 28/4, 16,960, 128] with the packed layout's key
     mask (timed beside J's forward on the same tokens and the library call
     with the same boolean mask), and the tower's shape [32, 16, 729, 72]
     (forward only). C runs on the TMA + wgmma kernel of kernel B with the
     lse store, E on its own TMA + wgmma kernel
     (csrc/hopper_attention_dkv.cuh, shared with J's dK/dV), D on the
     query-stationary TMA + wgmma kernel it shares with J's dQ
     (csrc/hopper_attention_dq.cuh); `--only train-kernels` prints ptxas'
     lines for C, D, E and J's dQ. The backward is compared like with like: both sides
     get the kernel's own o and lse. Tolerance: 4 bf16
     half-ulps of each output's max|reference|, lse 1e-3 absolute. Invalid
     rows of o and dq and invalid keys of dk, dv must be exactly 0, and two
     runs of dQ and of dK/dV bit-equal. D causal at the VLM shape is timed
     beside J's dQ on the same tokens. Library call:
     scaled_dot_product_attention forward for C, its autograd backward for D
     and E together.
   * J (trainable MHA with segment ids: forward + lse, dQ, dK/dV; the
     `use_flash="train-jax"` arm) at the shapes `mha_trainable` hands it: the
     grounding LM's [1, 28 heads after the KV repeat, 16,640 padded to 16,896,
     128] with 16,500 valid (id 1; the 140 invalid tokens and the 256 of zero
     padding share id 0 and attend each other), non-causal; causal at the VLM
     SFT step's [1, 28, 16,960 padded to 17,408, 128] with the [pre | image |
     post] layout's holes mid-sequence; the tower's [32, 16, 729 padded to
     1024, 72]; a ragged S = 4,101 with scattered ids; a causal hole over two
     batch rows; three ids other than 0 / 1; ids for q and kv apart with
     queries that match no key (o exactly 0, lse +inf, dq exactly 0).
     Every row is compared, the id-0 rows included. The
     backward like with like, as C, D, E; the same tolerances; two runs of
     dQ and of dK/dV bit-equal. Broken uses: ids ignored (forward, dQ, dK/dV), the pad
     keys left out of the invalid rows, delta dropped, causal dropped. Timed
     beside C, D, E on the same inputs and the library call with the same
     boolean mask; bounds from the pairs this run's ids admit. J's forward
     runs on C's TMA + wgmma kernel (with a skip of the key tiles no row of
     a block can see), its dQ and dK/dV on D's and E's, each with the
     segment-id policy; `--only segment-kernels` prints ptxas' lines for
     them and E, and the library must hold J's forward instance and not the
     mma.sync kernel it replaced. Three uniform segments (1 / 2 / 0 over
     [0, 1280) / [1280, 3000) / [3000, 3200)), causal and not, run both
     the skip and the mixed tiles; the forward's o and lse are bit-equal
     over two runs; every head dim from 8 to 128 runs causal and not.
   * A, B (attention, bf16, the TMA + wgmma kernels): plus a long case whose
     length is not a multiple of the 128-key tile, a small causal case and a
     fully-masked-row case; A at ragged S = 577 and 1,000, at S = 500 with
     D = 128 (both past K resident: the two-pass kernel) and at every
     head-dim instantiation (D = 8 ... 128); B at every head-dim
     instantiation with a key mask, causal and not, and at GQA
     groups of 3, 8 and 1; B causal at the VLM prefill's [1, 28/4, 15,584,
     128] with the packed layout's holes, timed beside the library call with
     the same boolean mask. Tolerance: 4 bf16 half-ulps of the case's
     max|reference| (see bf16_tol). Masked rows must be exactly 0. Their
     printed lines name the first version's time (FIRST_VERSION_MS, from
     PERF.md: not measured by this script, and not in the JSON record).
   * K (splash MQA with segment ids, the LM's A/B arm) at the LM's serving
     shape [1, 28/4, 13056, 128] with a 12,840-token valid prefix, through
     `splash_lm` against its plain form; a ragged S = 13,001; two rows of
     different valid lengths; D = 72 with GQA; three segments with ids other
     than 0 / 1 (in runs and scattered); a group of 8 heads; a group of 1 at
     eight more head dims (ids 0 / 1 straight into `splash_mqa`, no final
     multiply: id-0 rows must come out computed, not zeroed). K runs on B's
     TMA + wgmma kernel with the segment-id policy; `--only splash-kernels`
     prints ptxas' lines for it. Tolerance: 4 bf16 half-ulps of
     max|reference|; invalid rows exactly 0. Timed beside kernel B on the
     same inputs and the same library call as B.
   * L (`double_literal`, `double_no_literal`) on [8, 128] fp32: bit-equal to
     each other and to their plain versions (8 KiB moved: the launch is the
     floor).
   * F (act8 GEMM: a row quantisation, then the TMA + s8 wgmma GEMM of
     csrc/hopper_int8_gemm.cuh with the `Act8Out` epilogue) at the LM's four
     shapes, M = 13,056, with the row scale made inside (the main path), plus
     a ragged M with a zero row. The integer sums are exact and the epilogue
     has the plain version's operation order; the row scale is a true
     division in both: the result must be bit-equal (the line also gives the
     error against 1 bf16 ulp of max|reference|). Before F, the plain scales
     (`ops/quant.symmetric_scale`: row scales and int8 / int4 weight scales)
     are held bit for bit to numpy's float32 division on amax values whose
     product with the reciprocal is an ulp off; the line also counts the
     values that `amax / 127.0` (a Python divisor) misses on the card.
   * G, H (both activations), I (fused int8 encoder kernels) at [93,312,
     1152], at a ragged row count and with a zero row. LN sums run in
     another order, which flips a few int8 roundings: tolerance 4 max|ref| /
     127 + 1e-5, the JAX package's own bound for these kernels. All three
     run on the same GEMM after a row quantisation launch: G in two (LN +
     quantise; the packed QKV product with `QkvOut`, split into q, k, v), H
     in four (LN + quantise; fc1 with the `RowAmax` epilogue; fc1 with
     `QuantStore`; fc2 with `BiasResidual`), I in two (F's row quantisation;
     o_proj with `BiasResidual`). H's two runs must be bit-equal, and its
     broken uses include an amax from fc1's first n tile only and the padded
     columns of fc1's last tile counted; G's include its k held to the plain
     q (a wrong split). I has no LN: it must be bit-equal in every case. Each
     line times the launches one by one and, for orientation, the bare
     `torch._int_mm` product. `--only int8-kernels` prints ptxas' lines for
     F's, G's, H's and I's instances, and the library must hold them and not
     the mma.sync kernels they replaced.
   At each main-path shape, deliberately broken uses (keys dropped, the key
   mask or the segment ids ignored, q not pre-scaled, a head of the group
   left out, a bias, the LN bias or the residual dropped, the last k tile of
   fc2 dropped, H's row amax from one n tile or with padded columns, G's
   outputs split at the wrong place) must
   exceed the tolerance, which shows that it discriminates.
4. Agreement: the engine's kernel path against its plain path on a small
   input at the full widths of VideoITG-8B (videoitg-8b-shallow: 3 vision,
   2 LM layers), in bf16, and under the act8 tier with both int8 switches
   on against both off; tolerance E2E_ATOL on the sigmoid scores.
5. Slices: VideoITG-8B with random weights from a seeded torch.Generator,
   through SelectionEngine. bf16: select on 512 frames (cold, warm), on 100
   frames, select_many with 3 questions. Tiers int8 and int4: one warm
   512-frame select each. act8 with both switches on: 512 frames cold and
   warm and select_many with 3 questions; act8 with both off: one warm
   select. Launch counters are zeroed right before each kernel-path slice
   and read right after it; every kernel of the path must have launched.
   Scores must be finite in [0, 1], and each `index` a permutation of the
   sampled frames.
6. Serving daemon: VideoITG-8B bf16 behind `cli/serve.SelectionServer` and
   a `ThreadingHTTPServer` on port 0 in this process, 512-frame 640x360
   requests sent over HTTP. The machine has no libav, so the port's file
   reader is swapped for one that hands out frames made from a seed;
   everything after the reader is the daemon's own code (decode-ahead with
   `preprocess_ahead` on worker threads, the encoded-video LRU, the response
   contract). Two videos with two prompts each, with the LM's splash arm off
   and again with it on, then a yuv420 daemon against the RGB daemon on
   frames made from the same planes by the plain `yuv420_to_rgb`. Per
   request the launch counts are exact: a miss A 104, a hit A 0; B 28 and K 0
   per LM pass with the arm off, K 28 and B 0 with it on. `/healthz` counts
   (`served`, `encode_cache_hits`), scores in [0, 1] and descending, `index`
   a permutation, `selected` the sorted first 32, a bad path answered with an
   error; splash against flash arm and yuv420 against rgb within E2E_ATOL.
   Then scripts/torch_repro_kernels.py's `main`, the path of kernels L.
7. Training: VideoITG-8B bf16 with LoRA r16 adapters (random weights and
   adapters from seeded generators), `make_lora_optimizer`, `make_train_step(
   use_flash=True, remat=True)`, through `run_step`. Three steps on a
   1024-frame feature batch [1, 1024, 729, 1152] made on the device (hw 4,
   16,640 LM tokens), then two steps on 32 uint8 frames through
   `collate_grounding` (the frozen tower in the step). At every step the
   loss is finite and the launch counts are exact: C twice a layer (forward
   and recompute) plus once per tower layer when frames come in, D and E
   once a layer, J never. Two more steps of the feature batch go through
   `use_flash="train-jax"`: J 56 / 28 / 28 a step, C, D, E never (the A/B the
   arm exists for). The frozen leaves must be bit-identical afterwards, lora_b
   and out_proj changed. Then, on videoitg-8b-shallow at 8 frames: the loss
   and LoRA gradients of the kernel path against the plain path (loss 2e-2
   relative; gradients 5e-2 of each leaf's largest entry), and two QLoRA
   steps each over an int8 and an int4 base (integer bytes unchanged).

8. Causal VLM: VideoITG-8B in its causal, tied variant, bf16, LoRA r16.
   Three SFT steps (`collate_vlm`, `make_vlm_train_step`, `run_step`) on one
   256-frame video sample (hw 8, 64 + 16,384 + 512 = 16,960 LM tokens, 150
   label tokens, the frozen tower in the step, remat) with `use_flash=True`
   (C, D, E causal: 82 / 28 / 28 launches a step), two with
   `use_flash="train-jax"` (J: the same counts), frozen leaves bit-identical,
   the two arms' losses on the same parameters within 1e-3 relative. Greedy
   `vlm_generate` at 32 frames (hw 22, 15,584 prompt slots), 16 new tokens,
   `use_flash=True`: kernel A in the tower, kernel B causal 28 times at
   prefill and nothing else; prefill seconds, and ms per decoded token from
   15 `vlm_decode_step`s timed alone after a prefill, three repeats. On
   videoitg-8b-shallow at 8 frames: each arm's loss and LoRA gradients
   against the plain path (loss 2e-2 relative; gradients 5e-2 of each leaf's
   largest entry, the 0-d leaves taken together), the kernel path's
   first-token logits and cache against the plain path's (2e-2 of the largest
   entry), and three offloaded steps (`train/offload.py`: Adam's moments in
   pinned host memory between steps) bit-equal to three plain steps.

`--only attention-kernels` prints ptxas' lines for kernels A and B and stops
after checking them (a short first run after editing them),
`--only int8-kernels` stops after building and checking kernels F-I,
`--only train-kernels` after C, D, E, `--only splash-kernels` after K and L
`--only segment-kernels` after J (a short first run for a new kernel);
`--only serve` runs phase 6 alone, `--only train` phase 7, `--only vlm` phase
8. None of them prints a result line.

The last two lines are the per-kernel JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
E2E_ATOL = 2e-2     # sigmoid scores, bf16 kernel path vs bf16 plain path
# Published dense peaks of an H100 SXM (NVIDIA's data sheet), for the bounds.
PEAK_BF16 = 989e12   # FLOP/s
PEAK_INT8 = 1979e12  # OP/s
PEAK_HBM = 3.35e12   # bytes/s
FRAME_HW = (360, 640)  # a video-like decode resolution
# Kernels A, B, F-I before their TMA + wgmma redesign: mma.sync, one tile staged
# at a time (PERF.md section 6; NVIDIA H100 80GB HBM3 at 700.00 W). Printed
# for comparison only: this run does not measure them.
FIRST_VERSION_MS = {"flash_mha_short": 6.7473, "flash_mha": 27.5702,
                    # F (the 7 launches of one LM layer), G, H (gelu_tanh) and I
                    # on mma.sync fed by cp.async
                    "act8_gemm": 28.6371, "fused_ln_qkv_int8": 2.4690,
                    "fused_ln_mlp_int8": 14.8783, "fused_proj_residual_int8": 0.9550}
# The mangled name of J's forward: stream_kernel<DP, false, true, SegmentIds, ...>.
J_FWD_INSTANCE = r"stream_kernelILi\d+ELb0ELb1ENS0_10SegmentIds"
# F's, G's, H's and I's launches: hgemm::gemm_kernel<policy> and the two
# row quantisers (F and I share `row_quant_kernel`, G and H `ln_quant_kernel`).
F_INSTANCES = r"row_quant_kernel|gemm_kernel.*7Act8Out"
G_INSTANCES = r"ln_quant_kernel|gemm_kernel.*6QkvOut"
H_INSTANCES = r"ln_quant_kernel|gemm_kernel.*(RowAmax|QuantStore|ScaleOfAmax)"
I_INSTANCES = r"row_quant_kernel|gemm_kernel.*ScaleGiven"
# Patterns of the mangled names of the kernel instances whose ptxas lines
# each `--only` run prints.
PTXAS = {
    "attention-kernels": (("A", r"resident_kernel|stream_kernelILi\d+ELb1E"),
                          ("B", r"stream_kernelILi\d+ELb0ELb0E.*KeyMask")),
    "train-kernels": (("C", r"stream_kernelILi\d+ELb0ELb1E.*KeyMask"),
                      ("D", r"dq_kernel.*KeyMask"), ("E", r"dkv_kernel.*KeyMask"),
                      ("J dq", r"dq_kernel.*SegmentIds")),
    "splash-kernels": (("K", r"stream_kernelILi\d+ELb0ELb0E.*SegmentIds"),),
    "int8-kernels": (("F", F_INSTANCES), ("G", G_INSTANCES), ("H", H_INSTANCES),
                     ("I", I_INSTANCES)),
    "segment-kernels": (("J fwd", J_FWD_INSTANCE), ("J dq", r"dq_kernel.*SegmentIds"),
                        ("J dkv", r"dkv_kernel.*SegmentIds"), ("E", r"dkv_kernel.*KeyMask")),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ptxas_lines(log: str, kernel: str) -> list:
    """ptxas' resource lines (registers, spills, shared memory, performance
    notes) of the entry functions whose mangled name matches the regular
    expression `kernel` (a plain fragment is one), each prefixed with that
    name."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else None
            continue
        if entry and re.search(kernel, entry) and any(w in line for w in (
                "registers", "spill", "Performance", "warning")):
            out.append(f"{entry}: {line.strip()}")
    return out


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


def bound(ops: float, peak: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes (inputs read once, outputs written once) over
    the memory rate."""
    t_ops, t_bytes = 1e3 * ops / peak, 1e3 * nbytes / PEAK_HBM
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


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
    """The attention kernels A and B vs their plain versions; returns name -> record."""
    import torch
    from torch.nn import functional as F

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
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
    # 4 S^2 D operations per (frame, head); q, k, v read and o written once.
    bnd = bound(4 * 729 * 729 * 72 * 128 * 16, PEAK_BF16, 4 * q.numel() * 2)
    print(f"kernel flash_mha_short [128, 16, 729, 72] bf16: max_abs_err {err:.6g} "
          f"(tol {tol:.6g}, max|ref| {ref.abs().max().item():.6g}); broken: last 64 keys "
          f"dropped {drop:.6g}; {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa) "
          f"{library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; first "
          f"version {FIRST_VERSION_MS['flash_mha_short']} ms (PERF.md, not this run)", flush=True)
    if not err <= tol:
        fail(f"flash_mha_short error {err} > {tol}")
    if not drop > tol:
        fail(f"flash_mha_short tolerance {tol} does not catch dropped keys ({drop})")
    records["flash_mha_short"] = dict(
        name="flash_mha_short", route="cuda",
        source="videoitg_tpu_torch/csrc/flash_attention_short.cu",
        replaces="videoitg_tpu/ops/flash_attention_short.py:81",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd)
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
    # The library call takes as many kv heads as q heads and the key mask as
    # a broadcast boolean attn_mask.
    k28, v28 = k.repeat_interleave(7, dim=1), v.repeat_interleave(7, dim=1)
    attn_mask = valid[:, None, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k28, v28,
                                                                attn_mask=attn_mask), 5)
    del k28, v28
    # 4 S^2 D operations per q head; q and o (28 heads), k and v (4 heads).
    bnd = bound(4 * s * s * 128 * 28, PEAK_BF16, (2 * q.numel() + 2 * k.numel()) * 2)
    print(f"kernel flash_mha [1, 28/4, {s}, 128] bf16, {int((~valid).sum())} invalid keys: "
          f"max_abs_err {err:.6g} (tol {tol:.6g}, max|ref| {ref.abs().max().item():.6g}), "
          f"invalid rows max {masked}; broken: key mask ignored {no_mask:.6g}, one key tile "
          f"dropped {no_tile:.6g}; {ms:.4f} ms, plain {plain_ms:.4f} ms (plain head by head), "
          f"library (sdpa, kv heads expanded, key mask as attn_mask) {library_ms:.4f} ms, "
          f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; first version "
          f"{FIRST_VERSION_MS['flash_mha']} ms (PERF.md, not this run)", flush=True)
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
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd)
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
    del q, k, v, out, ref

    # A at ragged lengths and at every head-dim instantiation (D = 8 ... 128:
    # the kernel pads D to a multiple of 16 through TMA's zero fill). S = 1000
    # at D = 72 and S = 500 at D = 128 are past what K resident in shared
    # memory holds, and take the two-pass streaming kernel.
    for shape in [(4, 16, 577, 72), (2, 16, 1000, 72), (2, 4, 500, 128)] + [
            (2, 4, 300, d) for d in (8, 24, 40, 56, 88, 104, 120, 128)]:
        q, k, v = (randn(*shape) for _ in range(3))
        ref = flash_mha_short_reference(q.float(), k.float(), v.float())
        tol = bf16_tol(ref)
        err = max_err(flash_mha_short(q, k, v), ref)
        print(f"kernel flash_mha_short {list(shape)}: max_abs_err {err:.6g} (tol {tol:.6g})",
              flush=True)
        if not err <= tol:
            fail(f"flash_mha_short {list(shape)}: error {err} > {tol}")
        records["flash_mha_short"]["max_abs_err"] = max(
            records["flash_mha_short"]["max_abs_err"], err)

    # B at every head-dim instantiation (GQA 28/4, key mask), causal and not,
    # and at GQA groups other than 7: 3, 8 and 1.
    cases = [(28, 4, d, causal) for d in (8, 24, 40, 56, 72, 88, 104, 120)
             for causal in (False, True)]
    cases += [(12, 4, 128, True), (16, 2, 72, False), (6, 6, 64, True)]
    for hq, hkv, d, causal in cases:
        b, s = 2, 700
        q, k, v = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
        valid = torch.rand(b, s, generator=gen, device=dev) > 0.1
        valid[1, 650:] = False
        out = flash_mha(q, k, v, valid=valid, causal=causal)
        ref = flash_mha_reference(q.float(), k.float(), v.float(), valid=valid, causal=causal)
        tol = bf16_tol(ref)
        err = max_err(out, ref)
        masked = out.permute(0, 2, 1, 3)[~valid].abs().max().item()
        print(f"kernel flash_mha [{b}, {hq}/{hkv}, {s}, {d}] causal={causal}: max_abs_err "
              f"{err:.6g} (tol {tol:.6g}); invalid rows max {masked}", flush=True)
        if not err <= tol or masked != 0.0:
            fail(f"flash_mha [{b}, {hq}/{hkv}, {s}, {d}] causal={causal}")
        records["flash_mha"]["max_abs_err"] = max(records["flash_mha"]["max_abs_err"], err)
    del q, k, v, out, ref

    # B causal at the VLM prefill's shape: 32 frames at hw 22 between 32
    # prompt and 64 answer slots (30 and 40 used: holes mid-sequence and at
    # the tail), 15,584 tokens.
    s = 32 + 32 * 22 * 22 + 64
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    valid = torch.ones(1, s, dtype=torch.bool, device=dev)
    valid[0, 30:32] = False
    valid[0, 32 + 32 * 22 * 22 + 40:] = False
    ref = lm_reference(q, k, v, valid, causal=True)
    tol = bf16_tol(ref)
    out = flash_mha(q, k, v, valid=valid, causal=True)
    err = max_err(out, ref)
    masked = out[0][:, ~valid[0]].abs().max().item()
    rows = valid[0]
    no_causal = max_err(flash_mha(q, k, v, valid=valid)[:, :, rows], ref[:, :, rows])
    ms = cuda_ms(lambda: flash_mha(q, k, v, valid=valid, causal=True), 10)
    k28, v28 = k.repeat_interleave(7, dim=1), v.repeat_interleave(7, dim=1)
    attn_mask = (torch.ones(s, s, dtype=torch.bool, device=dev).tril_() & valid[0][None, :])
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k28, v28, attn_mask=attn_mask[None, None]), 5)
    del k28, v28, attn_mask
    # The pairs this run's mask admits: each valid row with the valid keys at
    # or before it.
    pairs = valid[0].to(torch.int64).cumsum(0)[valid[0]].sum().item()
    bnd = bound(4 * pairs * 128 * 28, PEAK_BF16, (2 * q.numel() + 2 * k.numel()) * 2)
    print(f"kernel flash_mha causal [1, 28/4, {s}, 128] (VLM prefill, {int((~valid).sum())} "
          f"holes): max_abs_err {err:.6g} (tol {tol:.6g}), invalid rows max {masked}; broken: "
          f"causal dropped {no_causal:.6g}; {ms:.4f} ms, library (sdpa, kv heads expanded, "
          f"causal and key mask as one boolean attn_mask) {library_ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}", flush=True)
    if not err <= tol or masked != 0.0:
        fail("flash_mha causal VLM-prefill case")
    if not no_causal > tol:
        fail(f"flash_mha tolerance {tol} does not catch a dropped causal mask ({no_causal})")
    records["flash_mha"]["max_abs_err"] = max(records["flash_mha"]["max_abs_err"], err)
    records["flash_mha"].update(causal_vlm_ms=ms, causal_vlm_library_ms=library_ms,
                                causal_vlm_bound_ms=bnd["bound_ms"])
    torch.cuda.synchronize()
    return records


def int8_tol(ref) -> float:
    """The JAX package's bound for the fused int8 kernels
    (tests/test_fused_encoder.py): one int8 step of the row's dynamic range
    per product, doubled for the two-product MLP; it covers roundings that
    flip because fp32 sums (LN statistics) ran in another order."""
    return 4.0 * ref.abs().max().item() / 127.0 + 1e-5


def err_stats(out, ref):
    d = (out.float() - ref.float()).abs()
    return d.max().item(), d.mean().item()


def check_int8_kernels(dev) -> dict:
    """Kernels F, G, H, I vs their plain versions; returns name -> record."""
    import torch

    from videoitg_tpu_torch.models.common import Linear, Norm
    from videoitg_tpu_torch.ops import _build
    from videoitg_tpu_torch.ops import fused_encoder as fe
    from videoitg_tpu_torch.ops import quant_gemm as qg
    from videoitg_tpu_torch.ops.quant import (QuantLinear, quantize_linear_int8,
                                              quantize_weight_int4, quantize_weight_int8,
                                              row_quant, row_scale_of)

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def int8_linear(d_in, d_out, bias_std=None) -> QuantLinear:
        lin = Linear(d_in, d_out, bias=bias_std is not None, device=dev, generator=gen)
        if bias_std is not None:
            lin.b.data = randn(d_out, std=bias_std)
        q = quantize_linear_int8(lin)
        q.act_q = True
        return q.to(torch.bfloat16)  # the bias in the model dtype; int8 and scales stay

    records = {}
    with open(_build.build(), "rb") as f:
        lib = f.read()
    for old in (b"act8_gemm_kernel", b"ln_mlp_kernel", b"ln_qkv_kernel", b"proj_res_kernel",
                b"stream_gemm", b"WeightTileLoader"):
        if old in lib:
            fail(f"the library still holds the mma.sync code {old.decode()}")
    for pattern in (F_INSTANCES, G_INSTANCES, H_INSTANCES, I_INSTANCES) + tuple(
            rf"gemm_kernel.*{p}" for p in ("Act8Out", "QkvOut", "RowAmax", "QuantStore",
                                           "ScaleOfAmax", "ScaleGiven")):
        if not re.search(pattern.encode(), lib):
            fail(f"the library does not hold {pattern}")
    del lib
    library = _build.library()

    # The plain scales divide exactly on the card: amax values whose product
    # with the float32 reciprocal misses the quotient, as scales of rows
    # (row_scale_of) and of weight columns (int8, int4), against numpy.
    import numpy as np

    a = np.random.default_rng(SEED + 11).uniform(1e-3, 8.0, 100_000).astype(np.float32)
    amax = torch.from_numpy(a).to(dev)
    w = torch.stack([amax, -0.5 * amax])  # [in = 2, out]: column amax = a
    for qmax, scales in ((127.0, (row_scale_of(amax), quantize_weight_int8(w)[1])),
                         (7.0, (quantize_weight_int4(w)[1],))):
        want = a / np.float32(qmax)
        misses = int(np.sum(want != a * (np.float32(1.0) / np.float32(qmax))))
        wrong = [int(np.sum(t.cpu().numpy() != want)) for t in scales]
        recip = int(np.sum((amax / qmax).cpu().numpy() != want))
        print(f"plain scales / {qmax:g} on the card: {a.size} amax values, {misses} of them an "
              f"ulp off under the reciprocal; scales unequal to numpy's division: {wrong}; "
              f"broken: `amax / {qmax:g}` by a Python number {recip}", flush=True)
        if any(wrong) or not misses:
            fail(f"the plain scales / {qmax:g} do not divide exactly on the card ({wrong})")
    del amax, w

    # ---- F: the LM's four linears at 13,056 tokens, the row scale made
    # inside (act8_linear's call). ----
    m = 512 * 25 + 256
    per_layer = {(3584, 3584): 2, (3584, 512): 2, (3584, 18944): 2, (18944, 3584): 1}
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0, int_mm_ms=0.0)
    worst, shapes = 0.0, []
    for (k, n), count in per_layer.items():
        lin = int8_linear(k, n)
        x = randn(m, k).to(torch.bfloat16)
        ref = qg.act8_gemm_reference(x, None, lin.w_qt, lin.scale)
        out = qg.act8_gemm(x, None, lin.w_qt, lin.scale)
        # One ulp of bf16 (8 significant bits) at max|ref|.
        tol = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
        err, mean = err_stats(out, ref)
        equal = bool(torch.equal(out, ref))
        ms = cuda_ms(lambda: qg.act8_gemm(x, None, lin.w_qt, lin.scale), 10)
        plain_ms = cuda_ms(lambda: qg.act8_gemm_reference(x, None, lin.w_qt, lin.scale), 3)
        x_q, xs = row_quant(x.float())
        xs = xs.contiguous()
        x_q8 = torch.empty_like(x_q)
        stream = torch.cuda.current_stream().cuda_stream
        quant_ms = cuda_ms(lambda: library.videoitg_row_quant_int8_bf16(
            x.data_ptr(), xs.data_ptr(), x_q8.data_ptr(), m, k, 1, stream), 10)
        int_mm_ms = cuda_ms(lambda: torch._int_mm(x_q, lin.w_qt.t()), 10)
        bnd = bound(2 * m * k * n, PEAK_INT8, m * k * 2 + n * k + n * 4 + m * n * 2)
        print(f"kernel act8_gemm [{m}, {k}] x [{k}, {n}]: max_abs_err {err:.6g} mean {mean:.3g} "
              f"(tol {tol:.6g} = 1 bf16 ulp, bit-equal {equal}); {ms:.4f} ms "
              f"({2 * m * k * n / ms / 1e9:.1f} TOP/s; of it the row quantisation alone "
              f"{quant_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']}; for orientation, the bare torch._int_mm product alone "
              f"{int_mm_ms:.4f} ms", flush=True)
        if not (err <= tol and equal):
            fail(f"act8_gemm [{k} -> {n}] error {err} (tol {tol}), bit-equal {equal}")
        worst = max(worst, err)
        shapes.append(dict(k=k, n=n, per_layer=count, ms=ms, quant_ms=quant_ms,
                           plain_ms=plain_ms, int_mm_ms=int_mm_ms, bit_equal=equal, **bnd))
        total["ms"] += count * ms
        total["plain_ms"] += count * plain_ms
        total["int_mm_ms"] += count * int_mm_ms
        total["bound_ms"] += count * bnd["bound_ms"]
        total["ops_ms"] += count * 1e3 * 2 * m * k * n / PEAK_INT8
        total["bytes_ms"] += count * 1e3 * (m * k * 2 + n * k + m * n * 2) / PEAK_HBM
        if (k, n) == (3584, 512):
            # A ragged M (not a multiple of the 128-row tile) with a zero row,
            # the scale made inside and given; and what a use that forgot the
            # column scales would give.
            xr = x[:1001].clone()
            xr[5] = 0
            xsr = qg.row_scale(xr)
            refr = qg.act8_gemm_reference(xr, xsr, lin.w_qt, lin.scale)
            outr = qg.act8_gemm(xr, None, lin.w_qt, lin.scale)
            errr, _ = err_stats(outr, refr)
            errg, _ = err_stats(qg.act8_gemm(xr, xsr, lin.w_qt, lin.scale), refr)
            zero_row = outr[5].abs().max().item()
            broken, _ = err_stats(qg.act8_gemm(xr, xsr, lin.w_qt, torch.ones_like(lin.scale)),
                                  refr)
            print(f"kernel act8_gemm ragged [1001, {k}] x [{k}, {n}], row 5 zero: max_abs_err "
                  f"{errr:.6g}, scale given {errg:.6g} (tol {tol:.6g}); zero row max {zero_row}; "
                  f"broken: column scales dropped {broken:.6g}", flush=True)
            if errr != 0.0 or errg != 0.0 or zero_row != 0.0 or xsr[5].item() != 1.0:
                fail("act8_gemm ragged / zero-row case: not bit-equal")
            if not broken > tol:
                fail(f"act8_gemm tolerance {tol} does not catch dropped scales ({broken})")
            worst = max(worst, errr, errg)
        del lin, x, xs, ref, out, x_q, x_q8
    records["act8_gemm"] = dict(
        name="act8_gemm", route="cuda", source="videoitg_tpu_torch/csrc/quant_gemm.cu",
        replaces="videoitg_tpu/ops/quant_gemm.py:32", max_abs_err=worst, ms=total["ms"],
        plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
        bound_by="operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes",
        library_ms=None, int_mm_ms=total["int_mm_ms"],
        per="the 7 launches of one LM layer at 13,056 tokens", shapes=shapes)
    print(f"kernel act8_gemm, one LM layer (7 launches): {total['ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms, bare torch._int_mm "
          f"{total['int_mm_ms']:.4f} ms; the mma.sync version {FIRST_VERSION_MS['act8_gemm']} "
          f"ms (PERF.md, not this run)", flush=True)

    # ---- G, H, I: one tower chunk, 128 frames x 729 patches, H = 1152. ----
    rows, h, inter = 128 * 729, 1152, 4304
    sub = 8192  # rows on which the broken uses are compared
    eps = 1e-6
    ln = Norm(h, bias=True, device=dev, dtype=torch.bfloat16)
    ln.scale.data = (1.0 + randn(h, std=0.1)).to(torch.bfloat16)
    ln.bias.data = randn(h, std=0.3).to(torch.bfloat16)
    ln_no_bias = Norm(h, bias=True, device=dev, dtype=torch.bfloat16)
    ln_no_bias.scale.data = ln.scale.data
    x = (randn(rows, h) * (1.0 + randn(1, h).abs()) + randn(1, h, std=0.5)).to(torch.bfloat16)

    def without_bias(lin):
        return QuantLinear(w_qt=lin.w_qt, scale=lin.scale, b=None, act_q=True)

    # G. A zero row: LN of it is the LN bias, so without one it quantises to
    # zeros with scale 1 and each output row is its linear's bias.
    q_lin, k_lin, v_lin = (int8_linear(h, h, bias_std=0.5) for _ in range(3))
    refs = fe.fused_ln_qkv_int8_reference(x, ln, q_lin, k_lin, v_lin, eps)
    outs = fe.fused_ln_qkv_int8(x, ln, q_lin, k_lin, v_lin, eps)
    tol = min(int8_tol(r.float()) for r in refs)
    err, mean = (max(v) for v in zip(*(err_stats(o, r) for o, r in zip(outs, refs))))
    no_lnb = fe.fused_ln_qkv_int8_reference(x[:sub], ln_no_bias, q_lin, k_lin, v_lin, eps)
    no_b = fe.fused_ln_qkv_int8_reference(x[:sub], ln, *(without_bias(p) for p in
                                                       (q_lin, k_lin, v_lin)), eps)
    broken_lnb = max(err_stats(o[:sub], r)[0] for o, r in zip(outs, no_lnb))
    broken_b = max(err_stats(o[:sub], r)[0] for o, r in zip(outs, no_b))
    broken_split = err_stats(outs[1][:sub], refs[0][:sub])[0]  # k held to the plain q
    ragged = fe.fused_ln_qkv_int8(x[:1000], ln, q_lin, k_lin, v_lin, eps)
    err_r = max(err_stats(o, r[:1000])[0] for o, r in zip(ragged, refs))
    xz = x[:1000].clone()
    xz[7] = 0
    zero = fe.fused_ln_qkv_int8(xz, ln_no_bias, q_lin, k_lin, v_lin, eps)
    refs_z = fe.fused_ln_qkv_int8_reference(xz, ln_no_bias, q_lin, k_lin, v_lin, eps)
    err_z = max(err_stats(o, r)[0] for o, r in zip(zero, refs_z))
    zero_ok = all(torch.equal(o[7], lin.b) for o, lin in zip(zero, (q_lin, k_lin, v_lin)))
    ms = cuda_ms(lambda: fe.fused_ln_qkv_int8(x, ln, q_lin, k_lin, v_lin, eps), 5)
    plain_ms = cuda_ms(lambda: fe.fused_ln_qkv_int8_reference(x, ln, q_lin, k_lin, v_lin, eps), 2)
    yq, ys = fe.ln_row_quant(x, ln, eps)
    stage_ms = [cuda_ms(lambda: fe.ln_row_quant(x, ln, eps), 5),
                cuda_ms(lambda: fe.qkv_project(yq, ys, q_lin, k_lin, v_lin), 5)]
    w_qkv = fe._packed_qkv(q_lin, k_lin, v_lin, dev)[0]
    int_mm_ms = cuda_ms(lambda: torch._int_mm(yq, w_qkv.t()), 5)
    del yq, ys, w_qkv
    n_out = 3 * h
    bnd = bound(2 * rows * h * n_out, PEAK_INT8,
                rows * h * 2 + n_out * h + rows * n_out * 2 + 2 * n_out * 4 + 2 * h * 4)
    print(f"kernel fused_ln_qkv_int8 [{rows}, {h}] -> 3 x [{rows}, {h}]: max_abs_err {err:.6g} "
          f"mean {mean:.3g} (tol {tol:.6g}); ragged 1000 rows {err_r:.6g}; the same, no LN bias, "
          f"row 7 zero {err_z:.6g}, zero row = bias {zero_ok}; broken: LN bias ignored {broken_lnb:.6g}, bias dropped "
          f"{broken_b:.6g}, k held to the plain q {broken_split:.6g}; {ms:.4f} ms "
          f"({2 * rows * h * n_out / ms / 1e9:.1f} TOP/s); launches: LN + quantise "
          f"{stage_ms[0]:.4f}, QKV product {stage_ms[1]:.4f} ms "
          f"({2 * rows * h * n_out / stage_ms[1] / 1e9:.1f} TOP/s); plain {plain_ms:.4f} ms, "
          f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; for orientation, the bare "
          f"torch._int_mm product alone {int_mm_ms:.4f} ms; the mma.sync version "
          f"{FIRST_VERSION_MS['fused_ln_qkv_int8']} ms (PERF.md, not this run)", flush=True)
    if not (err <= tol and err_r <= tol and err_z <= tol and zero_ok):
        fail(f"fused_ln_qkv_int8 error {err} / {err_r} / {err_z} > {tol}, or zero row {zero_ok}")
    if not (broken_lnb > tol and broken_b > tol and broken_split > tol):
        fail(f"fused_ln_qkv_int8 tolerance {tol} does not catch a broken use "
             f"({broken_lnb}, {broken_b}, {broken_split})")
    records["fused_ln_qkv_int8"] = dict(
        name="fused_ln_qkv_int8", route="cuda",
        source="videoitg_tpu_torch/csrc/fused_encoder.cu",
        replaces="videoitg_tpu/ops/fused_encoder.py:84", max_abs_err=max(err, err_r, err_z),
        mean_abs_err=mean, ms=ms, plain_ms=plain_ms, stage_ms=stage_ms, int_mm_ms=int_mm_ms,
        library_ms=None, **bnd)
    del refs, outs, no_lnb, no_b, ragged, zero, refs_z

    # I. No LN: the quantiser is order-free and its division exact, so the
    # kernel must be bit-equal to its plain version, zero row included.
    o_lin = int8_linear(h, h, bias_std=0.5)
    attn = randn(rows, h).to(torch.bfloat16)
    ref = fe.fused_proj_residual_int8_reference(attn, x, o_lin)
    out = fe.fused_proj_residual_int8(attn, x, o_lin)
    tol = int8_tol(ref.float())
    err, mean = err_stats(out, ref)
    equal = bool(torch.equal(out, ref))
    no_res, _ = err_stats(out[:sub], fe.fused_proj_residual_int8_reference(
        attn[:sub], torch.zeros_like(x[:sub]), o_lin))
    no_b, _ = err_stats(out[:sub], fe.fused_proj_residual_int8_reference(
        attn[:sub], x[:sub], without_bias(o_lin)))
    ar = attn[:1000].clone()
    ar[7] = 0
    out_r = fe.fused_proj_residual_int8(ar, x[:1000], o_lin)
    ref_r = fe.fused_proj_residual_int8_reference(ar, x[:1000], o_lin)
    err_r, _ = err_stats(out_r, ref_r)
    equal_r = bool(torch.equal(out_r, ref_r))
    zero_ok = bool(torch.equal(out_r[7], (x[7].float() + o_lin.b.float()).to(x.dtype)))
    ms = cuda_ms(lambda: fe.fused_proj_residual_int8(attn, x, o_lin), 5)
    plain_ms = cuda_ms(lambda: fe.fused_proj_residual_int8_reference(attn, x, o_lin), 2)
    aq, a_scale = qg.row_quant_int8(attn)
    stage_ms = [cuda_ms(lambda: qg.row_quant_int8(attn), 5),
                cuda_ms(lambda: fe.proj_residual(aq, a_scale, x, o_lin), 5)]
    int_mm_ms = cuda_ms(lambda: torch._int_mm(aq, o_lin.w_qt.t()), 5)
    del aq, a_scale
    bnd = bound(2 * rows * h * h, PEAK_INT8, 3 * rows * h * 2 + h * h + 2 * h * 4)
    print(f"kernel fused_proj_residual_int8 [{rows}, {h}]: max_abs_err {err:.6g} mean "
          f"{mean:.3g} (tol {tol:.6g}), bit-equal {equal}; ragged 1000 rows, row 7 zero "
          f"{err_r:.6g}, bit-equal {equal_r}, zero row = residual + bias {zero_ok}; broken: "
          f"residual dropped {no_res:.6g}, bias dropped {no_b:.6g}; {ms:.4f} ms "
          f"({2 * rows * h * h / ms / 1e9:.1f} TOP/s); launches: row quantisation "
          f"{stage_ms[0]:.4f}, o_proj {stage_ms[1]:.4f} ms; plain {plain_ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; for orientation, the bare "
          f"torch._int_mm product alone {int_mm_ms:.4f} ms; the mma.sync version "
          f"{FIRST_VERSION_MS['fused_proj_residual_int8']} ms (PERF.md, not this run)",
          flush=True)
    if not (equal and equal_r and zero_ok):
        fail(f"fused_proj_residual_int8 not bit-equal to its plain version: error {err} / "
             f"{err_r} (tol {tol}), zero row {zero_ok}")
    if not (no_res > tol and no_b > tol):
        fail(f"fused_proj_residual_int8 tolerance {tol} does not catch a broken use "
             f"({no_res}, {no_b})")
    records["fused_proj_residual_int8"] = dict(
        name="fused_proj_residual_int8", route="cuda",
        source="videoitg_tpu_torch/csrc/fused_encoder.cu",
        replaces="videoitg_tpu/ops/fused_encoder.py:121", max_abs_err=max(err, err_r),
        mean_abs_err=mean, ms=ms, plain_ms=plain_ms, stage_ms=stage_ms, int_mm_ms=int_mm_ms,
        library_ms=None, **bnd)
    del attn, ref, out, out_r, ref_r

    # H, both activations. The last 16 intermediate channels get a large
    # fc1 bias, so that a kernel which dropped the last (ragged) k tile of
    # fc2 (bytes 4288..4303 of 4304) would stand out.
    fc1, fc2 = int8_linear(h, inter, bias_std=0.1), int8_linear(inter, h, bias_std=0.5)
    fc1.b.data[-16:] += 4.0
    fc2_cut = QuantLinear(w_qt=fc2.w_qt.clone(), scale=fc2.scale, b=fc2.b, act_q=True)
    fc2_cut.w_qt[:, -16:] = 0
    asked, done = 4 * rows * h * inter, 6 * rows * h * inter  # fc1 runs twice
    worst, worst_mean, times = 0.0, 0.0, {}
    for act in ("gelu_tanh", "quick_gelu"):
        ref = fe.fused_ln_mlp_int8_reference(x, ln, fc1, fc2, eps, act)
        out = fe.fused_ln_mlp_int8(x, ln, fc1, fc2, eps, act)
        again = fe.fused_ln_mlp_int8(x, ln, fc1, fc2, eps, act)
        tol = int8_tol(ref.float())
        err, mean = err_stats(out, ref)
        no_tile, _ = err_stats(out[:sub], fe.fused_ln_mlp_int8_reference(
            x[:sub], ln, fc1, fc2_cut, eps, act))
        no_lnb, _ = err_stats(out[:sub], fe.fused_ln_mlp_int8_reference(
            x[:sub], ln_no_bias, fc1, fc2, eps, act))
        no_res, _ = err_stats(out[:sub].float() - x[:sub].float(), ref[:sub])
        err_r, _ = err_stats(fe.fused_ln_mlp_int8(x[:1000], ln, fc1, fc2, eps, act), ref[:1000])
        ms = cuda_ms(lambda: fe.fused_ln_mlp_int8(x, ln, fc1, fc2, eps, act), 5)
        plain_ms = cuda_ms(lambda: fe.fused_ln_mlp_int8_reference(x, ln, fc1, fc2, eps, act), 2)
        yq, ys = fe.ln_row_quant(x, ln, eps)
        amax = fe.mlp_fc1_amax(yq, ys, fc1, act)
        gq = fe.mlp_fc1_quant(yq, ys, fc1, amax, act)
        stage_ms = [cuda_ms(lambda: fe.ln_row_quant(x, ln, eps), 5),
                    cuda_ms(lambda: fe.mlp_fc1_amax(yq, ys, fc1, act), 5),
                    cuda_ms(lambda: fe.mlp_fc1_quant(yq, ys, fc1, amax, act), 5),
                    cuda_ms(lambda: fe.mlp_fc2_residual(x, gq, amax, fc2), 5)]
        del yq, ys, amax, gq
        print(f"kernel fused_ln_mlp_int8 {act} [{rows}, {h}] via {inter}: max_abs_err {err:.6g} "
              f"mean {mean:.3g} (tol {tol:.6g}); ragged 1000 rows {err_r:.6g}; two runs "
              f"bit-equal {bool(torch.equal(out, again))}; broken: last k tile of fc2 dropped "
              f"{no_tile:.6g}, LN bias ignored {no_lnb:.6g}, residual dropped {no_res:.6g}; "
              f"{ms:.4f} ms ({asked / ms / 1e9:.1f} TOP/s of the 2 products asked for, "
              f"{done / ms / 1e9:.1f} of the 3 done); launches: LN + quantise "
              f"{stage_ms[0]:.4f}, fc1 amax {stage_ms[1]:.4f}, fc1 quantise {stage_ms[2]:.4f}, "
              f"fc2 {stage_ms[3]:.4f} ms; plain {plain_ms:.4f} ms", flush=True)
        if not (err <= tol and err_r <= tol):
            fail(f"fused_ln_mlp_int8 {act} error {err} / {err_r} > {tol}")
        if not torch.equal(out, again):
            fail(f"fused_ln_mlp_int8 {act}: two runs differ")
        if not (no_tile > tol and no_lnb > tol and no_res > tol):
            fail(f"fused_ln_mlp_int8 {act} tolerance {tol} does not catch a broken use "
                 f"({no_tile}, {no_lnb}, {no_res})")
        worst, worst_mean = max(worst, err, err_r), max(worst_mean, mean)
        times[act] = (ms, plain_ms, stage_ms)
        del ref, out, again

    # H's row amax, broken: from fc1's first n tile only, and with the 48
    # padded columns of fc1's last tile (4304 = 16 x 256 + 208) counted, as
    # a kernel that read a bias there would. The last 16 channels run hot
    # (+32) so that the tile that holds them sets each row's amax; the padded
    # columns carry a bias of 1024.
    act = "gelu_tanh"
    fc1_hot = QuantLinear(w_qt=fc1.w_qt, scale=fc1.scale, b=fc1.b.clone(), act_q=True)
    fc1_hot.b.data[-16:] += 28.0
    xs_ = x[:sub]
    ref = fe.fused_ln_mlp_int8_reference(xs_, ln, fc1_hot, fc2, eps, act)
    tol = int8_tol(ref.float())
    yq, ys = fe.ln_row_quant(xs_, ln, eps)
    good, _ = err_stats(fe.fused_ln_mlp_int8(xs_, ln, fc1_hot, fc2, eps, act), ref)

    def with_amax(amax):
        return fe.mlp_fc2_residual(xs_, fe.mlp_fc1_quant(yq, ys, fc1_hot, amax, act), amax, fc2)

    tile = fe.FC1_TILE
    first = QuantLinear(w_qt=fc1_hot.w_qt[:tile], scale=fc1_hot.scale[:tile],
                        b=fc1_hot.b[:tile], act_q=True)
    one_tile, _ = err_stats(with_amax(fe.mlp_fc1_amax(yq, ys, first, act)), ref)
    pad = -inter % tile
    padded = QuantLinear(
        w_qt=torch.cat([fc1_hot.w_qt, fc1_hot.w_qt.new_zeros(pad, h)]),
        scale=torch.cat([fc1_hot.scale, fc1_hot.scale.new_ones(pad)]),
        b=torch.cat([fc1_hot.b, fc1_hot.b.new_full((pad,), 1024.0)]), act_q=True)
    counted, _ = err_stats(with_amax(fe.mlp_fc1_amax(yq, ys, padded, act)), ref)
    print(f"kernel fused_ln_mlp_int8 {act} [{sub}, {h}], last 16 channels +32: max_abs_err "
          f"{good:.6g} (tol {tol:.6g}); broken: amax from fc1's first n tile only "
          f"{one_tile:.6g}, the {pad} padded columns counted {counted:.6g}", flush=True)
    if not good <= tol:
        fail(f"fused_ln_mlp_int8 hot channels error {good} > {tol}")
    if not (one_tile > tol and counted > tol):
        fail(f"fused_ln_mlp_int8 tolerance {tol} does not catch a broken row amax "
             f"({one_tile}, {counted})")
    worst = max(worst, good)
    del yq, ys, ref, padded, first
    # fc1 and fc2 once each; x read, out written, both weights read.
    bnd = bound(asked, PEAK_INT8,
                2 * rows * h * 2 + 2 * h * inter + 2 * (inter + h) * 4 + 2 * h * 4)
    print(f"kernel fused_ln_mlp_int8: bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; the "
          f"mma.sync version {FIRST_VERSION_MS['fused_ln_mlp_int8']} ms (gelu_tanh; PERF.md, "
          f"not this run)", flush=True)
    records["fused_ln_mlp_int8"] = dict(
        name="fused_ln_mlp_int8", route="cuda",
        source="videoitg_tpu_torch/csrc/fused_encoder.cu",
        replaces="videoitg_tpu/ops/fused_encoder.py:105", max_abs_err=worst,
        mean_abs_err=worst_mean, ms=times["gelu_tanh"][0], plain_ms=times["gelu_tanh"][1],
        quick_gelu_ms=times["quick_gelu"][0], stage_ms=times["gelu_tanh"][2],
        library_ms=None, **bnd)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def check_train_kernels(dev) -> dict:
    """Kernels C, D, E (trainable attention: forward + lse, dQ, dK/dV) vs
    their plain versions; returns name -> record. The backward is compared
    like with like: both sides get the kernel's own saved forward (o, lse)."""
    import torch
    from torch.nn import functional as F

    from videoitg_tpu_torch.ops import flash_attention_segment as fas
    from videoitg_tpu_torch.ops import flash_attention_train as fat

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def run_case(label, q, k, v, valid, causal, backward=True):
        """Forward and backward against the plain versions; returns the
        tensors, the errors and the tolerances for the caller's extra checks."""
        o, lse = fat.flash_train_fwd(q, k, v, valid, causal)
        ref_o, ref_lse = fat.flash_mha_train_reference(q, k, v, valid, causal)
        live = torch.isfinite(ref_lse)
        if not torch.equal(live, torch.isfinite(lse)):
            fail(f"{label}: dead rows of lse differ from the plain version")
        c = dict(o=o, lse=lse, err_o=max_err(o, ref_o.float()), tol_o=bf16_tol(ref_o.float()),
                 err_lse=(lse[live] - ref_lse[live]).abs().max().item())
        msg = (f"kernel flash_train {label}: fwd max_abs_err {c['err_o']:.6g} (tol "
               f"{c['tol_o']:.6g}), lse {c['err_lse']:.6g} (tol 0.001)")
        if not (c["err_o"] <= c["tol_o"] and c["err_lse"] <= 1e-3):
            fail(msg)
        if valid is not None and o.transpose(1, 2)[~valid].abs().sum().item() != 0.0:
            fail(f"{label}: invalid query rows of o are not exactly 0")
        del ref_o, ref_lse
        if backward:
            do = randn(*q.shape)
            c["do"] = do
            dq, dk, dv = fat.flash_train_bwd(q, k, v, valid, o, lse, do, causal)
            refs = fat.flash_mha_train_backward_reference(q, k, v, valid, o, lse, do, causal)
            for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                c[name], c["ref_" + name] = out, ref
                c["err_" + name] = max_err(out, ref.float())
                c["tol_" + name] = bf16_tol(ref.float())
                msg += f"; {name} {c['err_' + name]:.6g} (tol {c['tol_' + name]:.6g})"
                if not c["err_" + name] <= c["tol_" + name]:
                    fail(msg)
            if valid is not None:
                if dq.transpose(1, 2)[~valid].abs().sum().item() != 0.0:
                    fail(f"{label}: invalid query rows of dq are not exactly 0")
                if (dk.transpose(1, 2)[~valid].abs().sum().item() != 0.0
                        or dv.transpose(1, 2)[~valid].abs().sum().item() != 0.0):
                    fail(f"{label}: invalid keys of dk / dv are not exactly 0")
        print(msg, flush=True)
        return c

    # The training shape of the LM: 1024 frames x 16 slots + 256 text slots,
    # a 16,500-token valid prefix (the plain versions run whole, one query
    # head of each group at a time).
    s, n_valid = 1024 * 16 + 256, 16500
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    valid = torch.arange(s, device=dev)[None] < n_valid
    c = run_case(f"[1, 28/4, {s}, 128] bf16, {n_valid} valid", q, k, v, valid, False)
    o, lse, do = c["o"], c["lse"], c["do"]
    do0, delta = fat.prepare_backward(valid, o, do)
    dk2, dv2 = fat.flash_train_dkv(q, k, v, valid, do0, lse, delta)
    if not (torch.equal(dk2, c["dk"]) and torch.equal(dv2, c["dv"])):
        fail("flash_train_dkv: two runs differ")
    if not torch.equal(fat.flash_train_dq(q, k, v, valid, do0, lse, delta), c["dq"]):
        fail("flash_train_dq: two runs differ")
    del dk2, dv2

    # Deliberately broken uses, through the kernels themselves.
    def worst(outs, names):
        return max(max_err(out, c["ref_" + n].float()) / c["tol_" + n]
                   for out, n in zip(outs, names))

    broken = {}
    broken["key mask ignored in dK/dV"] = worst(
        fat.flash_train_dkv(q, k, v, None, do0, lse, delta), ("dk", "dv"))
    raw_delta = (do.float() * o.float()).sum(dim=-1)
    broken["dO of invalid rows not zeroed"] = worst(
        (fat.flash_train_dq(q, k, v, valid, do, lse, raw_delta),
         *fat.flash_train_dkv(q, k, v, valid, do, lse, raw_delta)), ("dq", "dk", "dv"))
    zero = torch.zeros_like(delta)
    broken["delta dropped"] = worst(
        (fat.flash_train_dq(q, k, v, valid, do0, lse, zero),
         *fat.flash_train_dkv(q, k, v, valid, do0, lse, zero)), ("dq", "dk", "dv"))
    # A head whose dO and delta are zero adds nothing: the same as skipping it.
    do_skip, delta_skip = do0.clone(), delta.clone()
    do_skip[:, 6], delta_skip[:, 6] = 0, 0
    broken["one query head of the group skipped in dK/dV"] = worst(
        fat.flash_train_dkv(q, k, v, valid, do_skip, lse, delta_skip), ("dk", "dv"))
    fewer = valid.clone()
    fewer[:, 6400:6464] = False
    broken["one key tile skipped in dQ"] = worst(
        (fat.flash_train_dq(q, k, v, fewer, do0, lse, delta),), ("dq",))
    del do_skip, delta_skip, zero, raw_delta
    print("kernel flash_train broken uses, worst error over its tolerance: "
          + "; ".join(f"{name} {ratio:.3g}x" for name, ratio in broken.items()), flush=True)
    for name, ratio in broken.items():
        if not ratio > 1.0:
            fail(f"flash_train tolerance does not catch: {name} ({ratio}x)")

    # Times at the training shape, beside the plain versions, the bounds (the
    # work this run's valid prefix needs) and the library call.
    ms = dict(fwd=cuda_ms(lambda: fat.flash_train_fwd(q, k, v, valid), 5),
              dq=cuda_ms(lambda: fat.flash_train_dq(q, k, v, valid, do0, lse, delta), 3),
              dkv=cuda_ms(lambda: fat.flash_train_dkv(q, k, v, valid, do0, lse, delta), 3))
    plain_fwd = cuda_ms(lambda: fat.flash_mha_train_reference(q, k, v, valid), 1)
    plain_bwd = cuda_ms(lambda: fat.backward_on_kernel_inputs(q, k, v, valid, do0, lse, delta,
                                                              False), 1)
    k28 = k.repeat_interleave(7, dim=1).requires_grad_()
    v28 = v.repeat_interleave(7, dim=1).requires_grad_()
    qg = q.clone().requires_grad_()
    attn_mask = valid[:, None, None, :]
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k28.detach(), v28.detach(),
                                                             attn_mask=attn_mask), 3)
    lib_out = F.scaled_dot_product_attention(qg, k28, v28, attn_mask=attn_mask)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, k28, v28), do0,
                                                  retain_graph=True), 3)
    del k28, v28, qg, lib_out
    unit = n_valid * n_valid * 128 * 28  # one S x S x D product over the q heads, in MACs
    big, small, stat = q.numel() * 2, k.numel() * 2, lse.numel() * 4
    bounds = dict(fwd=bound(4 * unit, PEAK_BF16, 2 * big + 2 * small + stat),
                  dq=bound(6 * unit, PEAK_BF16, 3 * big + 2 * small + 2 * stat),
                  dkv=bound(8 * unit, PEAK_BF16, 2 * big + 4 * small + 2 * stat))
    print(f"kernel flash_train [1, 28/4, {s}, 128]: fwd {ms['fwd']:.4f} ms, dq {ms['dq']:.4f} ms, "
          f"dkv {ms['dkv']:.4f} ms; plain fwd {plain_fwd:.4f} ms, plain backward (dq, dk, dv "
          f"together) {plain_bwd:.4f} ms; library (sdpa, kv heads expanded, key mask as "
          f"attn_mask) fwd {lib_fwd:.4f} ms, its autograd backward (dq, dk, dv together) "
          f"{lib_bwd:.4f} ms; bounds fwd {bounds['fwd']['bound_ms']:.4f}, dq "
          f"{bounds['dq']['bound_ms']:.4f}, dkv {bounds['dkv']['bound_ms']:.4f} ms by "
          f"{bounds['dkv']['bound_by']}", flush=True)
    src = "videoitg_tpu_torch/csrc/flash_attention_train.cu"
    tpu = "videoitg_tpu/ops/flash_attention_train.py"
    records = {
        "flash_train_fwd": dict(name="flash_train_fwd", route="cuda", source=src,
                                replaces=f"{tpu}:41", max_abs_err=c["err_o"], ms=ms["fwd"],
                                plain_ms=plain_fwd, library_ms=lib_fwd, **bounds["fwd"]),
        "flash_train_dq": dict(name="flash_train_dq", route="cuda", source=src,
                               replaces=f"{tpu}:106", max_abs_err=c["err_dq"], ms=ms["dq"],
                               plain_ms=plain_bwd, library_ms=lib_bwd,
                               note="plain_ms and library_ms are the whole backward "
                                    "(dq, dk, dv), one number for both backward kernels",
                               **bounds["dq"]),
        "flash_train_dkv": dict(name="flash_train_dkv", route="cuda", source=src,
                                replaces=f"{tpu}:153",
                                max_abs_err=max(c["err_dk"], c["err_dv"]), ms=ms["dkv"],
                                plain_ms=plain_bwd, library_ms=lib_bwd,
                                note="plain_ms and library_ms are the whole backward "
                                     "(dq, dk, dv), one number for both backward kernels",
                                **bounds["dkv"]),
    }
    del q, k, v, c, o, lse, do, do0, delta
    torch.cuda.empty_cache()

    def widen(case):
        records["flash_train_fwd"]["max_abs_err"] = max(
            records["flash_train_fwd"]["max_abs_err"], case["err_o"])
        if "err_dq" in case:
            records["flash_train_dq"]["max_abs_err"] = max(
                records["flash_train_dq"]["max_abs_err"], case["err_dq"])
            records["flash_train_dkv"]["max_abs_err"] = max(
                records["flash_train_dkv"]["max_abs_err"], case["err_dk"], case["err_dv"])

    # A length that is not a multiple of the 64-row tile (4,101 = 64 x 64 + 5),
    # with scattered invalid tokens.
    s = 4101
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    valid = torch.rand(1, s, generator=gen, device=dev) > 0.02
    widen(run_case(f"ragged [1, 28/4, {s}, 128]", q, k, v, valid, False))

    # Causal, two batch rows; rows 0..4 of the first see no valid key.
    b, s = 2, 1000
    q, k, v = randn(b, 28, s, 128), randn(b, 4, s, 128), randn(b, 4, s, 128)
    valid = torch.rand(b, s, generator=gen, device=dev) > 0.1
    valid[0, :5] = False
    case = run_case(f"causal [2, 28/4, {s}, 128]", q, k, v, valid, True)
    if torch.isfinite(case["lse"][0, :, :5]).any() or case["dq"][0, :, :5].abs().max() != 0:
        fail("causal rows with no visible valid key: lse not dead or dq not 0")
    widen(case)

    # Two batch rows with different valid lengths, and a narrow ragged head
    # dim (72, padded to 80 in shared memory only) with GQA.
    b, s = 2, 2000
    q, k, v = randn(b, 28, s, 128), randn(b, 4, s, 128), randn(b, 4, s, 128)
    valid = torch.arange(s, device=dev)[None] < torch.tensor([[1990], [1203]], device=dev)
    widen(run_case(f"[2, 28/4, {s}, 128], valid lengths 1990 and 1203", q, k, v, valid, False))
    q, k, v = randn(2, 6, 300, 72), randn(2, 2, 300, 72), randn(2, 2, 300, 72)
    widen(run_case("[2, 6/2, 300, 72], valid lengths 300 and 170", q, k, v,
                   torch.arange(300, device=dev)[None] < torch.tensor([[300], [170]], device=dev),
                   False))

    # The other head dims the wrappers take (each its own instantiation,
    # padded to a multiple of 16 in shared memory), and the main path's 128,
    # at a small ragged length, each causal and not.
    for d in (8, 24, 40, 56, 88, 104, 120, 128):
        q, k, v = randn(1, 4, 130, d), randn(1, 2, 130, d), randn(1, 2, 130, d)
        for causal in (False, True):
            widen(run_case(f"[1, 4/2, 130, {d}], 100 valid, causal={causal}", q, k, v,
                           torch.arange(130, device=dev)[None] < 100, causal=causal))

    # Causal at the VLM SFT step's shape: [pre 64 | image 16,384 | post 512]
    # with 30 and 200 text slots used, so the key mask has holes. Timed
    # beside J's forward on the same tokens as `mha_trainable` hands them over
    # (KV heads repeated to 28, zero padding to 17,408, ids from the mask) and
    # the library call with the same boolean mask (kv heads expanded).
    s = 64 + 16384 + 512
    pos = torch.arange(s, device=dev)
    valid = ((pos < 30) | ((pos >= 64) & (pos < 64 + 16384 + 200)))[None].contiguous()
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    case = run_case(f"causal [1, 28/4, {s}, 128], VLM layout", q, k, v, valid, True)
    widen(case)
    do0, delta = fat.prepare_backward(valid, case["o"], case["do"])
    lse = case["lse"]
    ratio = max_err(fat.flash_train_dq(q, k, v, valid, do0, lse, delta, False),
                    case["ref_dq"].float()) / case["tol_dq"]
    print(f"kernel flash_train causal [1, 28/4, {s}, 128], VLM layout: broken use, worst error "
          f"over its tolerance: causal ignored in dQ {ratio:.3g}x", flush=True)
    if not ratio > 1.0:
        fail(f"flash_train tolerance does not catch: causal ignored in dQ ({ratio}x)")
    del case
    vlm = dict(fwd=cuda_ms(lambda: fat.flash_train_fwd(q, k, v, valid, True), 5),
               dq=cuda_ms(lambda: fat.flash_train_dq(q, k, v, valid, do0, lse, delta, True), 3),
               dkv=cuda_ms(lambda: fat.flash_train_dkv(q, k, v, valid, do0, lse, delta, True), 3))
    plain_vlm = cuda_ms(lambda: fat.flash_mha_train_reference(q, k, v, valid, True), 1)
    del do0, delta, lse
    k28, v28 = k.repeat_interleave(7, dim=1), v.repeat_interleave(7, dim=1)
    attn_mask = valid[:, None, None, :] & torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    lib_vlm = cuda_ms(lambda: F.scaled_dot_product_attention(q, k28, v28, attn_mask=attn_mask), 3)
    del attn_mask
    pad = -(-s // 512) * 512 - s
    qp, kp, vp = (F.pad(x, (0, 0, 0, pad)) for x in (q, k28, v28))
    ids = F.pad(valid.to(torch.int32), (0, pad)).contiguous()
    j_vlm = cuda_ms(lambda: fas.flash_segment_fwd(qp, kp, vp, ids, ids, True), 3)
    o_j, lse_j = fas.flash_segment_fwd(qp, kp, vp, ids, ids, True)
    do_j = F.pad(randn(*q.shape), (0, 0, 0, pad))
    delta_j = fas.segment_delta(o_j, do_j)
    j_dq_vlm = cuda_ms(lambda: fas.flash_segment_dq(qp, kp, vp, ids, ids, do_j, lse_j, delta_j,
                                                    True), 3)
    del k28, v28, qp, kp, vp, ids, o_j, lse_j, do_j, delta_j
    # Pairs on or below the diagonal whose key is valid: for every query row
    # in the forward (an invalid row's lse is stored too), for the valid rows
    # only in the backward (dq is 0 and dO zeroed on an invalid row).
    seen = valid.cumsum(dim=1)
    pairs = int(seen.sum().item())
    pairs_valid = int((seen * valid).sum().item())
    big, small, stat = q.numel() * 2, k.numel() * 2, 28 * s * 4
    vlm_bounds = {name: bound(n * npairs * 128 * 28, PEAK_BF16, nbytes)
                  for name, n, npairs, nbytes in (
                      ("fwd", 4, pairs, 2 * big + 2 * small + stat),
                      ("dq", 6, pairs_valid, 3 * big + 2 * small + 2 * stat),
                      ("dkv", 8, pairs_valid, 2 * big + 4 * small + 2 * stat))}
    print(f"kernel flash_train causal [1, 28/4, {s}, 128], VLM layout: fwd {vlm['fwd']:.4f} ms, "
          f"dq {vlm['dq']:.4f} ms, dkv {vlm['dkv']:.4f} ms; plain fwd {plain_vlm:.4f} ms; "
          f"kernel J fwd on the same tokens [1, 28, {s + pad}, 128] {j_vlm:.4f} ms, J dq "
          f"{j_dq_vlm:.4f} ms; library "
          f"(sdpa, the same boolean mask) fwd {lib_vlm:.4f} ms; bounds fwd "
          f"{vlm_bounds['fwd']['bound_ms']:.4f}, dq {vlm_bounds['dq']['bound_ms']:.4f}, dkv "
          f"{vlm_bounds['dkv']['bound_ms']:.4f} ms (operations, {pairs} pairs per head forward, "
          f"{pairs_valid} backward)",
          flush=True)
    for part, rec in (("fwd", "flash_train_fwd"), ("dq", "flash_train_dq"),
                      ("dkv", "flash_train_dkv")):
        records[rec]["causal"] = dict(shape=[1, 28, s, 128], ms=vlm[part], **vlm_bounds[part])
    records["flash_train_fwd"]["causal"].update(plain_ms=plain_vlm, library_ms=lib_vlm,
                                                flash_segment_fwd_ms=j_vlm)
    records["flash_train_dq"]["causal"]["flash_segment_dq_ms"] = j_dq_vlm
    del q, k, v, valid
    torch.cuda.empty_cache()

    # The vision tower's shape under training (frozen: forward only).
    q, k, v = (randn(32, 16, 729, 72) for _ in range(3))
    case = run_case("tower [32, 16, 729, 72], no mask, forward only", q, k, v, None, False,
                    backward=False)
    widen(case)
    tower_ms = cuda_ms(lambda: fat.flash_train_fwd(q, k, v), 10)
    print(f"kernel flash_train_fwd tower [32, 16, 729, 72]: {tower_ms:.4f} ms", flush=True)
    records["flash_train_fwd"]["tower_ms"] = tower_ms
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def check_splash_kernels(dev) -> dict:
    """Kernel K (splash MQA with segment ids) and the two kernels L against
    their plain versions; returns name -> record. K is timed beside kernel B
    on the same inputs in the same run."""
    import torch
    from torch.nn import functional as F

    from videoitg_tpu_torch.ops import repro_kernels as rk
    from videoitg_tpu_torch.ops import splash_attention as sa
    from videoitg_tpu_torch.ops.flash_attention import flash_mha

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def mqa_reference(qs, k, v, q_seg, kv_seg):
        """splash_mqa_reference in fp32, one query head at a time."""
        group = qs.shape[1] // k.shape[1]
        return torch.cat([sa.splash_mqa_reference(
            qs[:, h:h + 1].float(), k[:, h // group:h // group + 1].float(),
            v[:, h // group:h // group + 1].float(), q_seg, kv_seg)
            for h in range(qs.shape[1])], dim=1)

    def lm_case(label, q, k, v, valid):
        """splash_lm against its plain form; invalid rows must be exactly 0."""
        seg = valid.to(torch.int32)
        ref = mqa_reference(sa.prescale(q), k, v, seg, seg) * valid[:, None, :, None]
        out = sa.splash_lm(q, k, v, valid)
        err, tol = max_err(out, ref), bf16_tol(ref)
        masked = out.transpose(1, 2)[~valid].abs().sum().item()
        print(f"kernel splash_mqa {label}: max_abs_err {err:.6g} (tol {tol:.6g}, max|ref| "
              f"{ref.abs().max().item():.6g}); invalid rows sum {masked}", flush=True)
        if not err <= tol:
            fail(f"splash_mqa {label}: error {err} > {tol}")
        if masked != 0.0:
            fail(f"splash_mqa {label}: invalid query rows are not exactly 0")
        return out, ref, err, tol

    # The LM's serving shape: 512 frames x 25 slots + 256 text slots, of which
    # the 40 first are valid (a valid prefix of 12,840 tokens).
    s, n_valid = 512 * 25 + 256, 512 * 25 + 40
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    valid = torch.arange(s, device=dev)[None] < n_valid
    out, ref, err, tol = lm_case(f"[1, 28/4, {s}, 128] bf16, {n_valid} valid", q, k, v, valid)
    # Broken uses, on the valid rows: every key given the queries' segment,
    # q not pre-scaled, and one head of the group left out (its output zero).
    seg = valid.to(torch.int32)
    qs = sa.prescale(q)
    rows = valid[0]
    ones = torch.ones_like(seg)
    broken = {
        "segment ids ignored": max_err(sa.splash_mqa(qs, k, v, ones, ones)[:, :, rows],
                                       ref[:, :, rows]),
        "q not pre-scaled": max_err(sa.splash_mqa(q, k, v, seg, seg)[:, :, rows],
                                    ref[:, :, rows]),
    }
    skipped = out.clone()
    skipped[:, 6] = 0
    broken["one head of the group skipped"] = max_err(skipped, ref)
    del skipped
    print("kernel splash_mqa broken uses: "
          + "; ".join(f"{name} {e:.6g}" for name, e in broken.items()) + f" (tol {tol:.6g})",
          flush=True)
    for name, e in broken.items():
        if not e > tol:
            fail(f"splash_mqa tolerance {tol} does not catch: {name} ({e})")

    ms = cuda_ms(lambda: sa.splash_mqa(qs, k, v, seg, seg), 10)
    arm_ms = cuda_ms(lambda: sa.splash_lm(q, k, v, valid), 10)
    flash_ms = cuda_ms(lambda: flash_mha(q, k, v, valid=valid), 10)
    ms2 = cuda_ms(lambda: sa.splash_mqa(qs, k, v, seg, seg), 10)
    plain_ms = cuda_ms(lambda: [sa.splash_mqa_reference(qs[:, h:h + 1], k[:, h // 7:h // 7 + 1],
                                                        v[:, h // 7:h // 7 + 1], seg, seg)
                                for h in range(28)], 2)
    k28, v28 = k.repeat_interleave(7, dim=1), v.repeat_interleave(7, dim=1)
    attn_mask = valid[:, None, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k28, v28,
                                                                attn_mask=attn_mask), 5)
    del k28, v28
    # This run's data: a valid query attends the n_valid valid keys, an
    # invalid one the others; q and o (28 heads), k and v (4 heads), the ids.
    pairs = n_valid * n_valid + (s - n_valid) * (s - n_valid)
    bnd = bound(4 * pairs * 128 * 28, PEAK_BF16,
                (2 * q.numel() + 2 * k.numel()) * 2 + 2 * seg.numel() * 4)
    print(f"kernel splash_mqa [1, 28/4, {s}, 128] bf16: {ms:.4f} ms (again after the others "
          f"{ms2:.4f} ms), the arm with its pre-scale and final multiply {arm_ms:.4f} ms; "
          f"kernel B (flash_mha) on the same inputs {flash_ms:.4f} ms (K / B "
          f"{ms / flash_ms:.4f}); plain {plain_ms:.4f} ms "
          f"(head by head); library (sdpa, kv heads expanded, key mask as attn_mask) "
          f"{library_ms:.4f} ms; bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}",
          flush=True)
    records = {"splash_mqa": dict(
        name="splash_mqa", route="cuda", source="videoitg_tpu_torch/csrc/splash_attention.cu",
        replaces="videoitg_tpu/ops/attention.py:154", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, arm_ms=arm_ms, flash_mha_ms_same_inputs=flash_ms, **bnd)}
    del q, k, v, qs, out, ref

    def widen(e):
        records["splash_mqa"]["max_abs_err"] = max(records["splash_mqa"]["max_abs_err"], e)

    # A length that is not a multiple of any tile (13,001), scattered invalid
    # tokens; two batch rows of different valid lengths; D = 72 with GQA.
    s = 13001
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    widen(lm_case(f"ragged [1, 28/4, {s}, 128]", q, k, v,
                  torch.rand(1, s, generator=gen, device=dev) > 0.01)[2])
    s = 2000
    q, k, v = randn(2, 28, s, 128), randn(2, 4, s, 128), randn(2, 4, s, 128)
    widen(lm_case(f"[2, 28/4, {s}, 128], valid lengths 1990 and 1203", q, k, v,
                  torch.arange(s, device=dev)[None] < torch.tensor([[1990], [1203]],
                                                                   device=dev))[2])
    q, k, v = randn(2, 6, 300, 72), randn(2, 2, 300, 72), randn(2, 2, 300, 72)
    widen(lm_case("[2, 6/2, 300, 72], valid lengths 300 and 170", q, k, v,
                  torch.arange(300, device=dev)[None] < torch.tensor([[300], [170]],
                                                                     device=dev))[2])

    def mqa_case(label, q, k, v, q_seg, kv_seg):
        ref = mqa_reference(q, k, v, q_seg, kv_seg)
        e, t = max_err(sa.splash_mqa(q, k, v, q_seg, kv_seg), ref), bf16_tol(ref)
        print(f"kernel splash_mqa {label}: max_abs_err {e:.6g} (tol {t:.6g})", flush=True)
        if not e <= t:
            fail(f"splash_mqa {label}: error {e} > {t}")
        widen(e)

    # Three segments with ids other than 0 / 1, in runs and scattered; then a
    # group of 8 heads, a group of one, and the other head dims (each its own
    # instantiation).
    s = 1500
    q, k, v = randn(2, 28, s, 128) * 0.3, randn(2, 4, s, 128), randn(2, 4, s, 128)
    ids = torch.tensor([-3, 5, 1000], dtype=torch.int32, device=dev)
    runs = ids[(torch.arange(s, device=dev) * 3 // s)][None].expand(2, s).contiguous()
    mqa_case(f"three segments in runs [2, 28/4, {s}, 128]", q, k, v, runs, runs)
    scattered = ids[torch.randint(0, 3, (2, s), generator=gen, device=dev)]
    mqa_case(f"three segments scattered [2, 28/4, {s}, 128]", q, k, v, scattered, scattered)
    q, k, v = randn(1, 16, 333, 64) * 0.3, randn(1, 2, 333, 64), randn(1, 2, 333, 64)
    two = (torch.arange(333, device=dev)[None] < 200).to(torch.int32)
    mqa_case("group of 8 [1, 16/2, 333, 64]", q, k, v, two, two)
    for d in (8, 16, 24, 40, 56, 88, 104, 120):
        q, k, v = randn(1, 3, 130, d) * 0.3, randn(1, 3, 130, d), randn(1, 3, 130, d)
        two = (torch.arange(130, device=dev)[None] < 100).to(torch.int32)
        mqa_case(f"group of 1 [1, 3/3, 130, {d}]", q, k, v, two, two)

    # Kernels L on the original's [8, 128] fp32 shape: bit-equal to each other
    # and to their plain versions. 8 KiB moved: the launch is the floor.
    x = torch.randn(8, 128, generator=gen, device=dev)
    lit, no_lit = rk.double_literal(x), rk.double_no_literal(x)
    if not (torch.equal(lit, no_lit) and torch.equal(lit, rk.double_literal_reference(x))
            and torch.equal(no_lit, rk.double_no_literal_reference(x))):
        fail("double_literal / double_no_literal are not bit-equal to their plain versions")
    bnd = bound(x.numel(), 67e12, 2 * x.numel() * 4)
    for name, fn, plain, line in (
            ("double_literal", rk.double_literal, rk.double_literal_reference, 51),
            ("double_no_literal", rk.double_no_literal, rk.double_no_literal_reference, 55)):
        ms = cuda_ms(lambda: fn(x), 200)
        plain_ms = cuda_ms(lambda: plain(x), 200)
        print(f"kernel {name} [8, 128] fp32: bit-equal; {ms:.5f} ms, plain (one PyTorch call, "
              f"also the library call) {plain_ms:.5f} ms, bound {bnd['bound_ms']:.3g} ms by "
              f"{bnd['bound_by']}: the launch is the floor", flush=True)
        records[name] = dict(
            name=name, route="cuda", source="videoitg_tpu_torch/csrc/repro_kernels.cu",
            replaces=f"scripts/repro_pallas_interpret_vma.py:{line}", max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, library_ms=plain_ms, **bnd)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def check_segment_kernels(dev) -> dict:
    """Kernel J (trainable MHA with segment ids: forward + lse, dQ, dK/dV)
    against its plain versions; returns name -> record. The backward is
    compared like with like: both sides get the kernel's own o and lse.
    Every row is compared, the id-0 ("invalid") rows included. Kernels C, D,
    E are timed beside J on the same inputs (KV heads not repeated, the ids
    as their key mask)."""
    import torch
    from torch.nn import functional as F

    from videoitg_tpu_torch.ops import _build
    from videoitg_tpu_torch.ops import flash_attention_segment as fas
    from videoitg_tpu_torch.ops import flash_attention_train as fat

    with open(_build.build(), "rb") as f:
        lib = f.read()
    if b"flash_segment_fwd_kernel" in lib or not re.search(J_FWD_INSTANCE.encode(), lib):
        fail("the library does not hold J's forward as stream_kernel<DP, false, true, "
             "SegmentIds, ...> alone")
    del lib
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def run_case(label, q, k, v, q_ids, kv_ids, causal, backward=True):
        o, lse = fas.flash_segment_fwd(q, k, v, q_ids, kv_ids, causal)
        ref_o, ref_lse = fas.flash_segment_fwd_reference(q, k, v, q_ids, kv_ids, causal)
        live = torch.isfinite(ref_lse)
        if not torch.equal(live, torch.isfinite(lse)):
            fail(f"{label}: rows that see no key differ from the plain version")
        c = dict(o=o, lse=lse, ref_o=ref_o.float(), err_o=max_err(o, ref_o.float()),
                 tol_o=bf16_tol(ref_o.float()),
                 err_lse=(lse[live] - ref_lse[live]).abs().max().item(),
                 empty=int((~live).sum().item()))
        msg = (f"kernel flash_segment {label}: fwd max_abs_err {c['err_o']:.6g} (tol "
               f"{c['tol_o']:.6g}), lse {c['err_lse']:.6g} (tol 0.001), rows that see no key "
               f"{c['empty']}")
        if not (c["err_o"] <= c["tol_o"] and c["err_lse"] <= 1e-3):
            fail(msg)
        if c["empty"] and o.transpose(1, 2)[~live.transpose(1, 2)].abs().sum().item() != 0.0:
            fail(f"{label}: a row that sees no key is not exactly 0")
        del ref_o, ref_lse
        if backward:
            do = randn(*q.shape)
            c["do"] = do
            dq, dk, dv = fas.flash_segment_bwd(q, k, v, q_ids, kv_ids, o, lse, do, causal)
            refs = fas.flash_mha_segment_backward_reference(q, k, v, q_ids, kv_ids, o, lse, do,
                                                            causal)
            for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                c[name], c["ref_" + name] = out, ref
                c["err_" + name] = max_err(out, ref.float())
                c["tol_" + name] = bf16_tol(ref.float())
                msg += f"; {name} {c['err_' + name]:.6g} (tol {c['tol_' + name]:.6g})"
                if not c["err_" + name] <= c["tol_" + name]:
                    fail(msg)
            if c["empty"] and dq.transpose(1, 2)[~live.transpose(1, 2)].abs().sum().item() != 0.0:
                fail(f"{label}: dq of a row that sees no key is not exactly 0")
        print(msg, flush=True)
        return c

    def admitted_pairs(q_ids, kv_ids, causal) -> int:
        """(query, key) pairs the mask admits in this run's ids, per head."""
        total = 0
        for u in torch.unique(torch.cat([q_ids.flatten(), kv_ids.flatten()])).tolist():
            qm, km = (q_ids == u), (kv_ids == u)
            if causal:
                total += int((km.cumsum(dim=1) * qm).sum().item())
            else:
                total += int((qm.sum(dim=1) * km.sum(dim=1)).sum().item())
        return total

    def timed(label, q, k, v, ids, causal, c, valid_for_cde):
        """J's three kernels, their plain versions, the library call and C, D, E
        on the same inputs; returns (ms, plain, library, bounds, cde)."""
        o, lse, do = c["o"], c["lse"], c["do"]
        delta = fas.segment_delta(o, do)
        ms = dict(
            fwd=cuda_ms(lambda: fas.flash_segment_fwd(q, k, v, ids, ids, causal), 3),
            dq=cuda_ms(lambda: fas.flash_segment_dq(q, k, v, ids, ids, do, lse, delta, causal), 2),
            dkv=cuda_ms(lambda: fas.flash_segment_dkv(q, k, v, ids, ids, do, lse, delta, causal),
                        2))
        plain_fwd = cuda_ms(lambda: fas.flash_segment_fwd_reference(q, k, v, ids, ids, causal), 1)
        plain_bwd = cuda_ms(lambda: fas.backward_on_kernel_inputs(q, k, v, ids, ids, do, lse,
                                                                  delta, causal), 1)
        group = 7
        kg, vg = k[:, ::group].contiguous(), v[:, ::group].contiguous()
        o2, lse2 = fat.flash_train_fwd(q, kg, vg, valid_for_cde, causal)
        do2, delta2 = fat.prepare_backward(valid_for_cde, o2, do)
        cde = dict(
            fwd=cuda_ms(lambda: fat.flash_train_fwd(q, kg, vg, valid_for_cde, causal), 3),
            dq=cuda_ms(lambda: fat.flash_train_dq(q, kg, vg, valid_for_cde, do2, lse2, delta2,
                                                  causal), 2),
            dkv=cuda_ms(lambda: fat.flash_train_dkv(q, kg, vg, valid_for_cde, do2, lse2, delta2,
                                                    causal), 2))
        del kg, vg, o2, lse2, do2, delta2
        attn_mask = fas.segment_visible(ids, ids, causal)
        qg, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), 2)
        lib_out = F.scaled_dot_product_attention(qg, kk, vv, attn_mask=attn_mask)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kk, vv), do,
                                                      retain_graph=True), 2)
        del qg, kk, vv, lib_out, attn_mask
        unit = admitted_pairs(ids, ids, causal) * q.shape[-1] * q.shape[1]  # MACs of a product
        big, stat, idb = q.numel() * 2, lse.numel() * 4, 2 * ids.numel() * 4
        bounds = dict(fwd=bound(4 * unit, PEAK_BF16, 4 * big + stat + idb),
                      dq=bound(6 * unit, PEAK_BF16, 5 * big + 2 * stat + idb),
                      dkv=bound(8 * unit, PEAK_BF16, 6 * big + 2 * stat + idb))
        print(f"kernel flash_segment {label}: fwd {ms['fwd']:.4f} ms, dq {ms['dq']:.4f} ms, dkv "
              f"{ms['dkv']:.4f} ms; plain fwd {plain_fwd:.4f} ms, plain backward (dq, dk, dv "
              f"together) {plain_bwd:.4f} ms; library (sdpa, the same boolean mask) fwd "
              f"{lib_fwd:.4f} ms, its autograd backward (dq, dk, dv together) {lib_bwd:.4f} ms; "
              f"dq, dkv at {ms['dq'] / (lib_bwd * 3 / 7):.4f}x, {ms['dkv'] / (lib_bwd * 4 / 7):.4f}x "
              f"their shares (3/7, 4/7) of it; "
              f"bounds fwd {bounds['fwd']['bound_ms']:.4f}, dq {bounds['dq']['bound_ms']:.4f}, dkv "
              f"{bounds['dkv']['bound_ms']:.4f} ms by {bounds['dkv']['bound_by']}; kernels C, D, E "
              f"on the same inputs (4 KV heads, ids as key mask) fwd {cde['fwd']:.4f}, dq "
              f"{cde['dq']:.4f}, dkv {cde['dkv']:.4f} ms", flush=True)
        return ms, dict(fwd=plain_fwd, bwd=plain_bwd), dict(fwd=lib_fwd, bwd=lib_bwd), bounds, cde

    def worst(c, outs, names):
        return max(max_err(out, c["ref_" + n].float()) / c["tol_" + n]
                   for out, n in zip(outs, names))

    def repeated_kv(s_pad, s):
        """k, v of 4 KV heads repeated to 28, zero beyond s: what the arm hands
        the kernel."""
        k, v = randn(1, 4, s_pad, 128), randn(1, 4, s_pad, 128)
        k[:, :, s:], v[:, :, s:] = 0, 0
        return k.repeat_interleave(7, dim=1), v.repeat_interleave(7, dim=1)

    # ---- the grounding LM's training shape as `mha_trainable` hands it over:
    # 28 heads after the KV repeat, S = 16,640 padded to 16,896, id 1 for the
    # 16,500 valid tokens, id 0 for the 140 invalid ones and the 256 of padding.
    s, n_valid = 1024 * 16 + 256, 16500
    s_pad = -(-s // 512) * 512
    q = randn(1, 28, s_pad, 128)
    q[:, :, s:] = 0
    k, v = repeated_kv(s_pad, s)
    ids = (torch.arange(s_pad, device=dev)[None] < n_valid).to(torch.int32)
    label = f"[1, 28, {s_pad} padded from {s}, 128] bf16, {n_valid} valid"
    c = run_case(label, q, k, v, ids, ids, False)
    o2, lse2 = fas.flash_segment_fwd(q, k, v, ids, ids)
    if not (torch.equal(o2, c["o"]) and torch.equal(lse2, c["lse"])):
        fail("flash_segment_fwd: two runs differ")
    del o2, lse2
    delta = fas.segment_delta(c["o"], c["do"])
    dk2, dv2 = fas.flash_segment_dkv(q, k, v, ids, ids, c["do"], c["lse"], delta)
    if not (torch.equal(dk2, c["dk"]) and torch.equal(dv2, c["dv"])):
        fail("flash_segment_dkv: two runs differ")
    if not torch.equal(fas.flash_segment_dq(q, k, v, ids, ids, c["do"], c["lse"], delta),
                       c["dq"]):
        fail("flash_segment_dq: two runs differ")
    del dk2, dv2
    invalid_rows = slice(n_valid, s)
    inv_max = c["o"][:, :, invalid_rows].float().abs().max().item()
    ones = torch.ones_like(ids)
    broken = {
        "ids ignored in the forward": max_err(
            fas.flash_segment_fwd(q, k, v, ones, ones)[0], c["ref_o"]) / c["tol_o"],
        "ids ignored in dK/dV": worst(c, fas.flash_segment_dkv(
            q, k, v, ones, ones, c["do"], c["lse"], delta), ("dk", "dv")),
        "ids ignored in dQ": worst(c, (fas.flash_segment_dq(
            q, k, v, ones, ones, c["do"], c["lse"], delta),), ("dq",)),
        # The same call without the padding: an invalid row then misses the 256
        # zero keys it has to see.
        "pad keys left out of the invalid rows": max_err(
            fas.flash_segment_fwd(q[:, :, :s].contiguous(), k[:, :, :s].contiguous(),
                                  v[:, :, :s].contiguous(), ids[:, :s].contiguous(),
                                  ids[:, :s].contiguous())[0][:, :, invalid_rows],
            c["ref_o"][:, :, invalid_rows]) / c["tol_o"],
        "delta dropped": worst(c, (
            fas.flash_segment_dq(q, k, v, ids, ids, c["do"], c["lse"], torch.zeros_like(delta)),
            *fas.flash_segment_dkv(q, k, v, ids, ids, c["do"], c["lse"],
                                   torch.zeros_like(delta))), ("dq", "dk", "dv")),
    }
    print(f"kernel flash_segment {label}: invalid rows max |o| {inv_max:.4g} (computed, not "
          "zeroed); broken uses, worst error over its tolerance: "
          + "; ".join(f"{name} {ratio:.3g}x" for name, ratio in broken.items()), flush=True)
    if not inv_max > 0.0:
        fail("flash_segment: invalid rows came out zero")
    for name, ratio in broken.items():
        if not ratio > 1.0:
            fail(f"flash_segment tolerance does not catch: {name} ({ratio}x)")
    ms, plain, lib, bounds, cde = timed(label, q, k, v, ids, False, c, ids.bool())
    src = "videoitg_tpu_torch/csrc/flash_attention_segment.cu"
    note = ("plain_ms and library_ms are the whole backward (dq, dk, dv), one number for both "
            "backward kernels")
    records = {
        "flash_segment_fwd": dict(
            name="flash_segment_fwd", route="cuda", source=src,
            replaces="videoitg_tpu/ops/attention.py:90", max_abs_err=c["err_o"], ms=ms["fwd"],
            plain_ms=plain["fwd"], library_ms=lib["fwd"], flash_train_ms_same_inputs=cde["fwd"],
            **bounds["fwd"]),
        "flash_segment_dq": dict(
            name="flash_segment_dq", route="cuda", source=src,
            replaces="videoitg_tpu/ops/attention.py:90", max_abs_err=c["err_dq"], ms=ms["dq"],
            plain_ms=plain["bwd"], library_ms=lib["bwd"], note=note,
            flash_train_ms_same_inputs=cde["dq"], **bounds["dq"]),
        "flash_segment_dkv": dict(
            name="flash_segment_dkv", route="cuda", source=src,
            replaces="videoitg_tpu/ops/attention.py:90",
            max_abs_err=max(c["err_dk"], c["err_dv"]), ms=ms["dkv"], plain_ms=plain["bwd"],
            library_ms=lib["bwd"], note=note, flash_train_ms_same_inputs=cde["dkv"],
            **bounds["dkv"]),
    }
    del q, k, v, c, delta
    torch.cuda.empty_cache()

    def widen(case):
        records["flash_segment_fwd"]["max_abs_err"] = max(
            records["flash_segment_fwd"]["max_abs_err"], case["err_o"])
        if "err_dq" in case:
            records["flash_segment_dq"]["max_abs_err"] = max(
                records["flash_segment_dq"]["max_abs_err"], case["err_dq"])
            records["flash_segment_dkv"]["max_abs_err"] = max(
                records["flash_segment_dkv"]["max_abs_err"], case["err_dk"], case["err_dv"])

    # ---- causal, at the VLM SFT step's shape: [pre 64 | image 16,384 | post
    # 512] = 16,960 padded to 17,408, each text segment a valid prefix, so the
    # ids have holes mid-sequence.
    s = 64 + 16384 + 512
    s_pad = -(-s // 512) * 512
    pos = torch.arange(s_pad, device=dev)
    ids = ((pos < 30) | ((pos >= 64) & (pos < 64 + 16384 + 200))).to(torch.int32)[None]
    ids = ids.contiguous()
    q = randn(1, 28, s_pad, 128)
    q[:, :, s:] = 0
    k, v = repeated_kv(s_pad, s)
    label = f"causal [1, 28, {s_pad} padded from {s}, 128] bf16, VLM layout with holes"
    c = run_case(label, q, k, v, ids, ids, True)
    delta = fas.segment_delta(c["o"], c["do"])
    broken = {
        "causal dropped in the forward": max_err(
            fas.flash_segment_fwd(q, k, v, ids, ids, False)[0], c["ref_o"]) / c["tol_o"],
        "causal dropped in dQ": worst(c, (fas.flash_segment_dq(
            q, k, v, ids, ids, c["do"], c["lse"], delta, False),), ("dq",)),
        "causal dropped in dK/dV": worst(c, fas.flash_segment_dkv(
            q, k, v, ids, ids, c["do"], c["lse"], delta, False), ("dk", "dv")),
    }
    print(f"kernel flash_segment {label}: broken uses, worst error over its tolerance: "
          + "; ".join(f"{name} {ratio:.3g}x" for name, ratio in broken.items()), flush=True)
    for name, ratio in broken.items():
        if not ratio > 1.0:
            fail(f"flash_segment tolerance does not catch: {name} ({ratio}x)")
    cms, cplain, clib, cbounds, ccde = timed(label, q, k, v, ids, True, c, ids.bool())
    for part, rec in (("fwd", "flash_segment_fwd"), ("dq", "flash_segment_dq"),
                      ("dkv", "flash_segment_dkv")):
        records[rec]["causal"] = dict(
            shape=[1, 28, s_pad, 128], ms=cms[part],
            plain_ms=cplain["fwd" if part == "fwd" else "bwd"],
            library_ms=clib["fwd" if part == "fwd" else "bwd"],
            flash_train_ms_same_inputs=ccde[part], **cbounds[part])
    widen(c)
    del q, k, v, c, delta
    torch.cuda.empty_cache()

    # ---- the tower's shape under the arm: 729 patches padded to 1024, id 1
    # for the patches and 0 for the padding, D = 72.
    q, k, v = (randn(32, 16, 1024, 72) for _ in range(3))
    for x in (q, k, v):
        x[:, :, 729:] = 0
    ids = (torch.arange(1024, device=dev)[None] < 729).to(torch.int32).expand(32, 1024)
    ids = ids.contiguous()
    c = run_case("tower [32, 16, 1024 padded from 729, 72]", q, k, v, ids, ids, False)
    widen(c)
    tower_ms = cuda_ms(lambda: fas.flash_segment_fwd(q, k, v, ids, ids), 10)
    print(f"kernel flash_segment_fwd tower [32, 16, 1024 padded from 729, 72]: {tower_ms:.4f} ms",
          flush=True)
    records["flash_segment_fwd"]["tower_ms"] = tower_ms
    del q, k, v, c

    # ---- small cases: a ragged length (4,101 = 64 x 64 + 5) with scattered
    # ids; a causal hole mid-sequence over two batch rows; three ids other
    # than 0 / 1; ids for q and kv apart, with queries whose id no key has.
    s = 4101
    q, k, v = (randn(1, 28, s, 128) for _ in range(3))
    ids = (torch.rand(1, s, generator=gen, device=dev) > 0.02).to(torch.int32)
    widen(run_case(f"ragged [1, 28, {s}, 128], scattered ids", q, k, v, ids, ids, False))
    b, s = 2, 1000
    q, k, v = (randn(b, 8, s, 128) for _ in range(3))
    pos = torch.arange(s, device=dev)[None]
    ids = ((pos < torch.tensor([[300], [120]], device=dev))
           | (pos >= torch.tensor([[420], [600]], device=dev))).to(torch.int32).contiguous()
    widen(run_case(f"causal [2, 8, {s}, 128], a hole mid-sequence", q, k, v, ids, ids, True))
    three = torch.tensor([-3, 5, 1000], dtype=torch.int32, device=dev)
    ids = three[torch.randint(0, 3, (b, s), generator=gen, device=dev)]
    for causal in (False, True):
        widen(run_case(f"three ids scattered [2, 8, {s}, 128] causal={causal}", q, k, v, ids, ids,
                       causal))
    q_ids = ids.clone()
    q_ids[:, 100:140] = 77  # no key has id 77: these rows see nothing
    case = run_case(f"q ids and kv ids apart [2, 8, {s}, 128]", q, k, v, q_ids, ids, False)
    if case["empty"] != 2 * 8 * 40:
        fail(f"expected {2 * 8 * 40} rows that see no key, got {case['empty']}")
    widen(case)

    # ---- three uniform segments, ids 1 / 2 / 0 over [0, 1280) / [1280, 3000)
    # / [3000, 3200): the first edge on a tile edge, the second not. Blocks
    # and tiles of one id skip the tiles of another; those across an edge
    # take the per-key test.
    s = 3200
    q, k, v = (randn(1, 8, s, 128) for _ in range(3))
    pos = torch.arange(s, device=dev)[None]
    ids = torch.where(pos < 1280, 1, torch.where(pos < 3000, 2, 0)).to(torch.int32).contiguous()
    for causal in (False, True):
        widen(run_case(f"segments 1 / 2 / 0 over 1280 / 1720 / 200 [1, 8, {s}, 128] "
                       f"causal={causal}", q, k, v, ids, ids, causal))

    # ---- every head dim (each its own instantiation, padded to a multiple of
    # 16 in shared memory only), causal and not, at a small ragged length.
    for d in range(8, 129, 8):
        q, k, v = (randn(2, 3, 130, d) for _ in range(3))
        ids = (torch.arange(130, device=dev)[None] < torch.tensor([[100], [130]], device=dev)
               ).to(torch.int32).contiguous()
        for causal in (False, True):
            widen(run_case(f"[2, 3, 130, {d}], 100 and 130 valid, causal={causal}", q, k, v,
                           ids, ids, causal))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def frames_u8(rng, t: int):
    import numpy as np

    return rng.integers(0, 256, (t,) + FRAME_HW + (3,), dtype=np.uint8)


def check_agreement(dev) -> None:
    """Kernel path vs plain path of the engine at full width, small input:
    in bf16 (attention kernels on / off), then under the act8 tier (both int8
    switches on / off, attention kernels on in both)."""
    import numpy as np
    import torch

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.ops.quant import apply_quantization_tier

    model, cfg, tok = load_grounding_components(None, "videoitg-8b-shallow", True,
                                                torch.bfloat16, dev, seed=SEED)
    frames = frames_u8(np.random.default_rng(SEED + 1), 8)

    def scores(**kw):
        eng = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16,
                              buckets=(8,), **kw)
        return eng.select(frames, list(range(8)), "where is the dog?").raw_scores

    def compare(what, a, b):
        diff = float(np.abs(a - b).max())
        print(f"agreement videoitg-8b-shallow, 8 frames, {what}: max |score diff| {diff:.6g} "
              f"(atol {E2E_ATOL}); kernels {np.round(a, 4).tolist()}", flush=True)
        if not diff <= E2E_ATOL:
            fail(f"{what}: {diff} > {E2E_ATOL}")

    compare("bf16, kernel vs plain path", scores(use_flash=True), scores(use_flash=False))
    apply_quantization_tier(model, "act8")
    compare("act8, int8 kernels on vs off",
            scores(use_flash=True, qgemm=True, fused=True),
            scores(use_flash=True, qgemm=False, fused=False))
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


QUESTIONS = ["What is the person holding?", "When does the car turn left?",
             "Which scene shows the rocket launch?"]


def wrappers() -> dict:
    """name -> kernel wrapper (each carries a `launches` count)."""
    from videoitg_tpu_torch.ops import flash_attention_segment as fas
    from videoitg_tpu_torch.ops import flash_attention_train as fat
    from videoitg_tpu_torch.ops import fused_encoder as fe
    from videoitg_tpu_torch.ops.flash_attention import flash_mha
    from videoitg_tpu_torch.ops.flash_attention_short import flash_mha_short
    from videoitg_tpu_torch.ops.quant_gemm import act8_gemm
    from videoitg_tpu_torch.ops.repro_kernels import double_literal, double_no_literal
    from videoitg_tpu_torch.ops.splash_attention import splash_mqa

    return {"flash_mha_short": flash_mha_short, "flash_mha": flash_mha, "splash_mqa": splash_mqa,
            "double_literal": double_literal, "double_no_literal": double_no_literal,
            "act8_gemm": act8_gemm,
            "fused_ln_qkv_int8": fe.fused_ln_qkv_int8, "fused_ln_mlp_int8": fe.fused_ln_mlp_int8,
            "fused_proj_residual_int8": fe.fused_proj_residual_int8,
            "flash_train_fwd": fat.flash_train_fwd, "flash_train_dq": fat.flash_train_dq,
            "flash_train_dkv": fat.flash_train_dkv,
            "flash_segment_fwd": fas.flash_segment_fwd, "flash_segment_dq": fas.flash_segment_dq,
            "flash_segment_dkv": fas.flash_segment_dkv}


SERVING_KERNELS = ("flash_mha_short", "flash_mha", "act8_gemm", "fused_ln_qkv_int8",
                   "fused_ln_mlp_int8", "fused_proj_residual_int8")
TRAIN_KERNELS = ("flash_train_fwd", "flash_train_dq", "flash_train_dkv")
SEGMENT_KERNELS = ("flash_segment_fwd", "flash_segment_dq", "flash_segment_dkv")


def expect_launches(arm, n_layers: int, tower_layers: int = 0) -> dict:
    """Launches of one training step with remat over `n_layers` decoder layers
    (forward and recompute, dQ, dK/dV), plus one forward per tower layer when
    frames come in: the kernels of `arm` ("train": C, D, E; "train-jax": J)
    launch so often, the other arm's not at all."""
    mine, other = ((TRAIN_KERNELS, SEGMENT_KERNELS) if arm == "train"
                   else (SEGMENT_KERNELS, TRAIN_KERNELS))
    counts = dict(zip(mine, (tower_layers + 2 * n_layers, n_layers, n_layers)))
    counts.update({name: 0 for name in other})
    return counts


def run_requests(tier: str, requests, expect_launches, card: str) -> dict:
    """Drive `requests` ((name, frames, fn, sampled) tuples) with every
    launch count set to 0 just before and read just after; the kernels named
    in `expect_launches` must have launched. Returns the counts."""
    import torch

    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for name, n_frames, fn, sampled in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for res in results:
            check_result(res, sampled)
        print(f"request [{tier}] {name}: {wall:.4f} s, {n_frames / wall:.2f} frames/s, "
              f"top8 {results[0].topk(8)} [{card}]", flush=True)
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tier}] peak device memory {peak / 2**30:.3f} GiB; launches {launches} [{card}]",
          flush=True)
    for name in expect_launches:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the {tier} path")
    return launches


def run_slices(dev, card: str) -> dict:
    """The main paths at full width: bf16, then the int8 / int4 / act8 tiers.
    Returns the launch counts of the bf16 path (kernels A, B) merged with
    those of the act8 path with both switches on (kernels A, B, F-I)."""
    import numpy as np
    import torch

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.engine import SelectionEngine

    rng = np.random.default_rng(SEED + 2)
    video512, video100 = frames_u8(rng, 512), frames_u8(rng, 100)
    sampled512 = [2 * i for i in range(512)]
    sampled100 = [3 * i for i in range(100)]

    def load(tier):
        t0 = time.perf_counter()
        model, cfg, tok = load_grounding_components(None, "videoitg-8b", True, torch.bfloat16,
                                                    dev, seed=SEED, quantize=tier)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in model.state_dict().values())
        print(f"videoitg-8b {tier or 'bf16'} random init: {n_params / 1e9:.3f} B weights, "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        return model, cfg, tok

    def select512(engine, q):
        return lambda: [engine.select(video512, sampled512, QUESTIONS[q])]

    model, cfg, tok = load(None)
    engine = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16)
    launches = run_requests("bf16", [
        ("select 512 frames (cold)", 512, select512(engine, 0), sampled512),
        ("select 512 frames (warm)", 512, select512(engine, 1), sampled512),
        ("select 100 frames", 100,
         lambda: [engine.select(video100, sampled100, QUESTIONS[2])], sampled100),
        ("select_many 512 frames x 3 questions", 512,
         lambda: engine.select_many(video512, sampled512, QUESTIONS), sampled512),
    ], ("flash_mha", "flash_mha_short"), card)
    print(f"[bf16] stages {json.dumps(engine.timer.summary())}", flush=True)
    bf16_launches = {k: launches[k] for k in ("flash_mha", "flash_mha_short")}
    del model, engine
    torch.cuda.empty_cache()

    for tier in ("int8", "int4"):
        model, cfg, tok = load(tier)
        engine = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16)
        engine.select(video512, sampled512, QUESTIONS[0])  # untimed first request
        run_requests(tier, [("select 512 frames (warm)", 512, select512(engine, 1),
                             sampled512)], ("flash_mha", "flash_mha_short"), card)
        del model, engine
        torch.cuda.empty_cache()

    model, cfg, tok = load("act8")
    engine = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16,
                             qgemm=True, fused=True)
    launches = run_requests("act8, int8 kernels on", [
        ("select 512 frames (cold)", 512, select512(engine, 0), sampled512),
        ("select 512 frames (warm)", 512, select512(engine, 1), sampled512),
        ("select_many 512 frames x 3 questions", 512,
         lambda: engine.select_many(video512, sampled512, QUESTIONS), sampled512),
    ], SERVING_KERNELS, card)
    print(f"[act8, int8 kernels on] stages {json.dumps(engine.timer.summary())}", flush=True)
    kernels_on = engine.select(video512, sampled512, QUESTIONS[1]).raw_scores
    engine_off = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16,
                                 qgemm=False, fused=False)
    engine_off.select(video512, sampled512, QUESTIONS[0])  # untimed first request
    off = run_requests("act8, int8 kernels off", [
        ("select 512 frames (warm)", 512, select512(engine_off, 1), sampled512),
    ], ("flash_mha", "flash_mha_short"), card)
    if any(off[name] for name in ("act8_gemm", "fused_ln_qkv_int8", "fused_ln_mlp_int8",
                                  "fused_proj_residual_int8")):
        fail("an int8 kernel launched with its switch off")
    kernels_off = engine_off.select(video512, sampled512, QUESTIONS[1]).raw_scores
    print(f"[act8] 512 frames, full depth, int8 kernels on vs off: max |score diff| "
          f"{float(np.abs(kernels_on - kernels_off).max()):.6g}", flush=True)
    return {**launches, **{k: launches[k] + v for k, v in bf16_launches.items()}}


def run_serving(dev, card: str) -> dict:
    """The serving daemon at full width: VideoITG-8B bf16 behind
    `SelectionServer` and `ThreadingHTTPServer` on port 0 in this process,
    requests sent over HTTP. Two 512-frame videos with two prompts each (two
    misses, two LRU hits) with the LM's splash arm off, the same with it on,
    then a third video through a `transfer="yuv420"` daemon and, as RGB frames
    made from the same planes by the plain `yuv420_to_rgb`, through the RGB
    daemon (and a fourth through the yuv420 daemon, for a warm time). The
    machine has no libav, so the file reader is swapped for one that hands
    out frames made from a seed; everything after the reader is
    the daemon's own code. Launch counts are set to 0 right before each
    request and read right after it. Returns the counts summed over the
    requests of the splash-on daemon (kernels A and K) and, for B, of the
    splash-off daemon."""
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from videoitg_tpu_torch.cli import serve
    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.data import video as video_mod
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.ops.preprocess import yuv420_to_rgb

    t_frames, (h, w) = 512, FRAME_HW
    rng = np.random.default_rng(SEED + 50)
    sampled = [3 * i for i in range(t_frames)]
    planes = video_mod.YUVFrames(
        rng.integers(16, 236, (t_frames, h, w), dtype=np.uint8),
        rng.integers(16, 241, (t_frames, h // 2, w // 2), dtype=np.uint8),
        rng.integers(16, 241, (t_frames, h // 2, w // 2), dtype=np.uint8))
    with torch.inference_mode():
        rgb_of_planes = yuv420_to_rgb(*(torch.from_numpy(p).to(dev) for p in planes)
                                      ).to(torch.uint8).cpu().numpy()
    torch.cuda.empty_cache()
    clips = {"/videos/a.mp4": {"rgb": frames_u8(rng, t_frames)},
             "/videos/b.mp4": {"rgb": frames_u8(rng, t_frames)},
             "/videos/c.mp4": {"rgb": rgb_of_planes, "yuv420": planes},
             "/videos/d.mp4": {"yuv420": video_mod.YUVFrames(
                 *(np.ascontiguousarray(p[::-1]) for p in planes))}}
    handed_out = []  # (path, pix_fmt, bytes) per read: what goes host to device

    def synthetic_reader(path, num_frames=512, target_fps=1.0, sampling="eval", multiple=1,
                         pix_fmt="rgb"):
        if path not in clips:
            raise FileNotFoundError(path)
        frames = clips[path][pix_fmt]
        handed_out.append((path, pix_fmt, frames.nbytes))
        return frames, list(sampled)

    def post(base, payload):
        req = urllib.request.Request(f"{base}/select", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(base, path):
        with urllib.request.urlopen(f"{base}{path}", timeout=60) as r:
            return json.loads(r.read())

    t0 = time.perf_counter()
    model, cfg, tok = load_grounding_components(None, "videoitg-8b", True, torch.bfloat16, dev,
                                                seed=SEED)
    torch.cuda.synchronize()
    weights_gib = torch.cuda.memory_allocated() / 2**30
    print(f"serve: videoitg-8b bf16 random init, {weights_gib:.3f} GiB on the card, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counted = wrappers()
    n_layers, tower_launches = cfg.lm.num_layers, 4 * cfg.vision.num_effective_layers

    def daemon(tag, requests, **engine_kw):
        """One engine + server + HTTP listener; drives `requests` ((path,
        prompt, expect) with expect 'miss' or 'hit'), checks every response
        and its launch counts, returns (server, raw scores by request)."""
        engine = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16,
                                 num_frames=t_frames, target_fps=1.0, **engine_kw)
        server = serve.SelectionServer(engine, decode_workers=2, decode_ahead=4, encode_cache=2)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(server))
        import threading

        listener = threading.Thread(target=httpd.serve_forever, daemon=True)
        listener.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        total = {name: 0 for name in counted}
        attention = "splash_mqa" if engine.lm_splash else "flash_mha"
        other = "flash_mha" if engine.lm_splash else "splash_mqa"
        raw = {}
        try:
            hits = 0
            for i, (path, prompt, expect) in enumerate(requests):
                for fn in counted.values():
                    fn.launches = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                status, out = post(base, {"video_path": path, "prompt": prompt, "topk": 32,
                                          "doc_id": i})
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                launches = {name: fn.launches for name, fn in counted.items() if fn.launches}
                if status != 200:
                    fail(f"serve [{tag}] request {i}: HTTP {status} {out}")
                hits += expect == "hit"
                health = get(base, "/healthz")
                if (health["served"], health["encode_cache_hits"], health["pending"]) != \
                        (i + 1, hits, 0):
                    fail(f"serve [{tag}] request {i}: /healthz says {health}")
                if sorted(out["index"]) != sampled or out["doc_id"] != i:
                    fail(f"serve [{tag}] request {i}: index is not a permutation of the "
                         f"sampled frames")
                if out["selected"] != sorted(out["index"][:32]):
                    fail(f"serve [{tag}] request {i}: selected is not the sorted first 32")
                sc = np.asarray(out["logits"], dtype=np.float64)
                if sc.shape != (t_frames,) or not np.all(np.isfinite(sc)) or sc.min() < 0 \
                        or sc.max() > 1 or np.any(np.diff(sc) > 0):
                    fail(f"serve [{tag}] request {i}: scores not finite, outside [0, 1] or "
                         f"not descending")
                want = {attention: n_layers,
                        "flash_mha_short": tower_launches if expect == "miss" else 0}
                got = {name: launches.get(name, 0) for name in (*want, other)}
                if got != {**want, other: 0}:
                    fail(f"serve [{tag}] request {i} ({expect}): launches {launches}, expected "
                         f"{want} and {other} 0")
                grown = (torch.cuda.memory_allocated() - before) / 2**30
                print(f"serve [{tag}] request {i} {os.path.basename(path)} ({expect}): "
                      f"{wall:.4f} s over HTTP, {t_frames / wall:.2f} frames/s, launches "
                      f"{launches}, peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, held after the "
                      f"request +{grown:.3f} GiB, top8 {sorted(out['index'][:8])} [{card}]",
                      flush=True)
                for name, n in launches.items():
                    total[name] += n
                # The unrounded scores behind the response (it carries them
                # to 2 decimals), from the slot the request left in the LRU;
                # this extra LM pass is outside the counted window.
                enc, _ = server._cache[server._encode_key(path, "eval")]
                raw[(path, prompt)] = engine.score_encoded(enc, [prompt])[0]
            print(f"serve [{tag}] /healthz {json.dumps(get(base, '/healthz'))}; /stats "
                  f"{json.dumps(get(base, '/stats'))}", flush=True)
            status, out = post(base, {"video_path": "/videos/none.mp4", "prompt": "x"})
            if status != 500 or "FileNotFoundError" not in out.get("error", ""):
                fail(f"serve [{tag}]: a bad path answered {status} {out}")
            slot = next(iter(server._cache.values()))[0].feats
            print(f"serve [{tag}] one LRU slot: {list(slot.shape)} {slot.dtype}, "
                  f"{slot.numel() * slot.element_size() / 2**30:.3f} GiB on the card",
                  flush=True)
        finally:
            httpd.shutdown()
            httpd.server_close()
            listener.join(timeout=60)
            server.close()  # stops the worker, drops the engine and the LRU's slots
        del server, engine
        torch.cuda.empty_cache()
        return total, raw

    four = [("/videos/a.mp4", QUESTIONS[0], "miss"), ("/videos/a.mp4", QUESTIONS[1], "hit"),
            ("/videos/b.mp4", QUESTIONS[0], "miss"), ("/videos/b.mp4", QUESTIONS[2], "hit")]
    real_reader = video_mod.read_video_frames
    video_mod.read_video_frames = synthetic_reader
    try:
        off_total, off_raw = daemon("rgb, splash off", four + [("/videos/c.mp4", QUESTIONS[0],
                                                               "miss")], lm_splash=False)
        on_total, on_raw = daemon("rgb, splash on", four, lm_splash=True)
        yuv_total, yuv_raw = daemon(
            "yuv420, splash off",
            [("/videos/c.mp4", QUESTIONS[0], "miss"), ("/videos/d.mp4", QUESTIONS[0], "miss")],
            lm_splash=False, transfer="yuv420")
    finally:
        video_mod.read_video_frames = real_reader

    # Splash arm against flash arm, request by request. The arms differ by the
    # bf16 rounding of q * D^-0.5 (a relative 2^-9 on every q entry, where the
    # flash arm scales the fp32 scores) and by the order of the fp32 sums:
    # bf16 noise of the size the kernel path has against the plain path, so
    # the same tolerance, E2E_ATOL on the sigmoid scores.
    worst = 0.0
    for key, on in on_raw.items():
        off = off_raw[key]
        diff = float(np.abs(on - off).max())
        overlap = len(set(np.argsort(-on, kind="stable")[:32])
                      & set(np.argsort(-off, kind="stable")[:32]))
        print(f"serve splash vs flash arm, {os.path.basename(key[0])} {key[1]!r}: max |score "
              f"diff| {diff:.6g} (atol {E2E_ATOL}), Top-32 overlap {overlap}/32 (random weights "
              f"make near ties; not asserted), score range [{off.min():.4f}, {off.max():.4f}]",
              flush=True)
        worst = max(worst, diff)
    if not worst <= E2E_ATOL:
        fail(f"splash arm and flash arm disagree: {worst} > {E2E_ATOL}")
    key = ("/videos/c.mp4", QUESTIONS[0])
    diff = float(np.abs(yuv_raw[key] - off_raw[key]).max())
    by_fmt = {fmt: n for _, fmt, n in handed_out}
    print(f"serve yuv420 daemon vs rgb daemon on frames made from the same planes by the plain "
          f"yuv420_to_rgb: max |score diff| {diff:.6g} (atol {E2E_ATOL}); host-to-device bytes "
          f"a 512-frame {w}x{h} video: rgb {by_fmt['rgb']}, yuv420 {by_fmt['yuv420']}",
          flush=True)
    if not diff <= E2E_ATOL:
        fail(f"yuv420 daemon and rgb daemon disagree: {diff} > {E2E_ATOL}")
    if by_fmt["yuv420"] * 2 != by_fmt["rgb"]:
        fail("yuv420 is not half the bytes of rgb")
    del model
    torch.cuda.empty_cache()
    return {"splash_mqa": on_total["splash_mqa"], "flash_mha": off_total["flash_mha"],
            "flash_mha_short": on_total["flash_mha_short"]}


def run_repro_script() -> dict:
    """The path of kernels L is their own script: run its `main` with the two
    launch counts set to 0 just before and read just after."""
    import importlib.util

    from videoitg_tpu_torch.ops import repro_kernels as rk

    spec = importlib.util.spec_from_file_location(
        "torch_repro_kernels", os.path.join(HERE, "scripts", "torch_repro_kernels.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    rk.double_literal.launches = rk.double_no_literal.launches = 0
    if script.main([]) != 0:
        fail("scripts/torch_repro_kernels.py failed")
    launches = {"double_literal": rk.double_literal.launches,
                "double_no_literal": rk.double_no_literal.launches}
    if min(launches.values()) <= 0:
        fail(f"scripts/torch_repro_kernels.py launched {launches}")
    return launches


def bit_checksums(tensors) -> list:
    """One exact integer per tensor over its bit pattern: equal lists mean
    bit-identical tensors (up to a collision no update would produce)."""
    import torch

    sums = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int8 if t.element_size() == 1 else torch.int16)
        sums.append(int(bits.to(torch.int64).sum().item()))
    return sums


def train_steps(tag, state, step_fn, batch, n_steps, expect, card):
    """`n_steps` calls of run_step on `batch`, each with the launch counts set
    to 0 just before and read just after; `expect` (kernel -> launches per
    step) must hold at every step and the loss must be finite. Returns the
    counts summed over the steps."""
    import torch

    from videoitg_tpu_torch.train.train_step import run_step

    counted = wrappers()
    total = {name: 0 for name in counted}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n_steps):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = run_step(step_fn, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        m = {k: float(v) for k, v in metrics.items()}
        others = ", ".join(f"{k} {v:.4f}" for k, v in m.items() if k not in ("loss", "grad_norm"))
        print(f"train [{tag}] step {state.step}: {wall:.4f} s, loss {m['loss']:.6f}, grad_norm "
              f"{m['grad_norm']:.6f}, {others}, launches "
              f"{ {k: launches[k] for k in TRAIN_KERNELS + SEGMENT_KERNELS if launches[k]} } "
              f"[{card}]", flush=True)
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            fail(f"[{tag}] loss or grad_norm not finite at step {state.step}")
        for name, n in expect.items():
            if launches[name] != n:
                fail(f"[{tag}] kernel {name} launched {launches[name]} times in a step, "
                     f"expected {n}")
        if any(launches[name] for name in SERVING_KERNELS):
            fail(f"[{tag}] an inference kernel launched in a training step")
        for name, n in launches.items():
            total[name] += n
    print(f"train [{tag}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"over {n_steps} steps [{card}]", flush=True)
    return state, total


def run_training(dev, card: str) -> dict:
    """The training path: LoRA steps of VideoITG-8B at full width (features
    in, then frames in), the kernel path against the plain path on
    videoitg-8b-shallow, and QLoRA steps over int8 and int4 bases. Returns the
    launch counts of the full-width feature-batch steps."""
    import numpy as np
    import torch

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.models.grounding import GroundingBatch, grounding_loss
    from videoitg_tpu_torch.ops.quant import quantize_grounding_int8, quantize_qwen2_int4
    from videoitg_tpu_torch.train.collate import collate_grounding
    from videoitg_tpu_torch.train.dataset import GroundingSample
    from videoitg_tpu_torch.train.lora import add_lora, make_lora_optimizer
    from videoitg_tpu_torch.train.train_step import create_train_state, make_train_step

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    rng = np.random.default_rng(SEED + 31)

    def frame_samples(cfg, t, tok):
        labels = (rng.random(t) < 0.2).astype(np.float32)
        labels[0] = 1.0
        from videoitg_tpu_torch.data.tokenizer import grounding_text_ids

        ids = grounding_text_ids(QUESTIONS[0], tok, cfg.max_text_len)
        return [GroundingSample(frames_u8(rng, t), ids, labels, "synthetic")]

    # ---- full width: VideoITG-8B, LoRA r16, 1024 frames of features ----
    t0 = time.perf_counter()
    model, cfg, tok = load_grounding_components(None, "videoitg-8b", True, torch.bfloat16, dev,
                                                seed=SEED)
    add_lora(model, gen, rank=16)
    tx = make_lora_optimizer(model, learning_rate=2e-4, out_proj_lr=2e-4, total_steps=10)
    state = create_train_state(model, tx)
    trainable = set(tx.trainable_names())
    base = [p for n, p in model.named_parameters() if n not in trainable]
    n_train = sum(p.numel() for p in tx.params)
    torch.cuda.synchronize()
    print(f"videoitg-8b bf16 + LoRA r16: {sum(p.numel() for p in base) / 1e9:.3f} B frozen, "
          f"{n_train / 1e6:.3f} M trainable parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    before = bit_checksums(base)
    lora_b0 = model.lm.layers[0].q.lora_b.detach().clone()
    out_w0 = model.out_proj.w.detach().clone()

    t_frames, hw = 1024, 4
    n_layers = cfg.lm.num_layers
    feats = torch.randn(1, t_frames, cfg.vision.num_patches, cfg.vision.hidden_size,
                        generator=gen, device=dev, dtype=torch.bfloat16)
    text_valid = torch.arange(cfg.max_text_len, device=dev)[None] < 40
    batch = GroundingBatch(
        frames=feats,
        frame_valid=torch.ones(1, t_frames, dtype=torch.bool, device=dev),
        text_ids=torch.randint(0, cfg.lm.vocab_size, (1, cfg.max_text_len), generator=gen,
                               device=dev),
        text_valid=text_valid,
        labels=(torch.rand(1, t_frames, generator=gen, device=dev) < 0.1).float())
    tokens = t_frames * hw * hw + cfg.max_text_len
    print(f"train [8b lora, features] batch {list(feats.shape)} bf16 "
          f"({feats.numel() * 2 / 1e9:.2f} GB), hw {hw}, {tokens} LM tokens", flush=True)
    step_fn = make_train_step(cfg, tx, hw=hw, use_flash=True, remat=True)
    state, launches = train_steps("8b lora, features", state, step_fn, batch, 3,
                                  expect_launches("train", n_layers), card)
    # The A/B the "train-jax" arm exists for: the same cell through kernel J.
    step_fn = make_train_step(cfg, tx, hw=hw, use_flash="train-jax", remat=True)
    state, _ = train_steps("8b lora, features, train-jax arm", state, step_fn, batch, 2,
                           expect_launches("train-jax", n_layers), card)
    if bit_checksums(base) != before:
        fail("a frozen base weight changed during the LoRA steps")
    if torch.equal(model.lm.layers[0].q.lora_b, lora_b0) or torch.equal(model.out_proj.w, out_w0):
        fail("lora_b or out_proj did not change over the LoRA steps")
    print("train [8b lora, features] frozen leaves bit-identical; lora_b and out_proj changed",
          flush=True)
    del feats, batch

    # ---- the tower in the step: 32 uint8 frames through collate_grounding ----
    t_frames = 32
    hw = cfg.projector.tokens_hw(t_frames, cfg.vision.num_patches_per_side)
    batch = collate_grounding(frame_samples(cfg, t_frames, tok), t_frames, cfg,
                              dtype=torch.bfloat16, device=dev)
    print(f"train [8b lora, frames] batch {list(batch.frames.shape)}, hw {hw}, "
          f"{t_frames * hw * hw + cfg.max_text_len} LM tokens", flush=True)
    step_fn = make_train_step(cfg, tx, hw=hw, use_flash=True, remat=True)
    expect = expect_launches("train", n_layers, cfg.vision.num_effective_layers)
    state, _ = train_steps("8b lora, frames", state, step_fn, batch, 2, expect, card)
    if bit_checksums(base) != before:
        fail("a frozen base weight changed during the LoRA steps with the tower")
    del model, tx, state, base, batch, step_fn
    torch.cuda.empty_cache()

    # ---- kernel path vs plain path, one LoRA loss and its gradients ----
    model, cfg, tok = load_grounding_components(None, "videoitg-8b-shallow", True,
                                                torch.bfloat16, dev, seed=SEED)
    add_lora(model, gen, rank=16)
    for layer in model.lm.layers:  # B = 0 would leave A without gradient
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            getattr(layer, name).lora_b.data.normal_(0.0, 0.02, generator=gen)
    tx = make_lora_optimizer(model, out_proj_lr=2e-4, total_steps=10)
    batch = collate_grounding(frame_samples(cfg, 8, tok), 8, cfg, dtype=torch.bfloat16,
                              device=dev)
    hw = cfg.projector.tokens_hw(8, cfg.vision.num_patches_per_side)
    results = {}
    for use_flash in (True, False):
        loss, _ = grounding_loss(model, batch, cfg, hw, use_flash=use_flash, remat=True)
        results[use_flash] = (loss.item(), torch.autograd.grad(loss, tx.params))
    (loss_k, grads_k), (loss_p, grads_p) = results[True], results[False]
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    # Relative to each leaf's own largest gradient; both paths round to bf16
    # at different points (the plain path normalises p before rounding it,
    # and keeps no fp32 lse), a few bf16 ulps per layer.
    grad_tol = 5e-2
    rel_grad = max((gk.float() - gp.float()).abs().max().item() / gp.float().abs().max().item()
                   for gk, gp in zip(grads_k, grads_p) if gp.abs().max().item() > 0)
    print(f"agreement videoitg-8b-shallow, 8 frames, one LoRA step's loss and gradients, kernel "
          f"vs plain path: loss {loss_k:.6f} vs {loss_p:.6f} (relative {rel_loss:.3g}, tol 2e-2); "
          f"gradients of {len(grads_k)} leaves, worst max|diff| / max|plain| {rel_grad:.3g} "
          f"(tol {grad_tol})", flush=True)
    if not (rel_loss <= 2e-2 and rel_grad <= grad_tol):
        fail("training: kernel path and plain path disagree")
    del model, tx, results, grads_k, grads_p
    torch.cuda.empty_cache()

    # ---- QLoRA: int8 then int4 base, two steps each (the first has lr 0) ----
    for bits in (8, 4):
        model, cfg, tok = load_grounding_components(None, "videoitg-8b-shallow", True,
                                                    torch.bfloat16, dev, seed=SEED)
        if bits == 8:
            quantize_grounding_int8(model)
        else:
            quantize_qwen2_int4(model.lm)
        add_lora(model, gen, rank=16)
        tx = make_lora_optimizer(model, out_proj_lr=2e-4, total_steps=10)
        ints = [b for b in model.buffers() if b.dtype == torch.int8]
        before = bit_checksums(ints)
        lora_b0 = model.lm.layers[0].q.lora_b.detach().clone()
        state = create_train_state(model, tx)
        step_fn = make_train_step(cfg, tx, hw=hw, use_flash=True, remat=True)
        expect = expect_launches("train", cfg.lm.num_layers, cfg.vision.num_effective_layers)
        train_steps(f"shallow qlora int{bits}", state, step_fn, batch, 2, expect, card)
        if bit_checksums(ints) != before or not ints:
            fail(f"int{bits} base bytes changed during QLoRA steps")
        if torch.equal(model.lm.layers[0].q.lora_b, lora_b0):
            fail(f"lora_b did not change over the int{bits} QLoRA steps")
        print(f"train [shallow qlora int{bits}] {len(ints)} integer tensors bit-identical; "
              f"lora_b changed", flush=True)
        del model, tx, state, step_fn, ints
        torch.cuda.empty_cache()
    return launches


def causal_tied(cfg):
    """The preset's causal variant with tied embeddings: what `cli/train.py
    --objective vlm --random-init` trains."""
    import dataclasses

    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, causal=True,
                                                           tie_word_embeddings=True))


def run_vlm(dev, card: str) -> dict:
    """The causal-VLM path at full width: LoRA SFT steps of VideoITG-8B on a
    256-frame video sample through `collate_vlm` and `make_vlm_train_step`
    (hw 8, 16,960 LM tokens, tower frozen in the step, remat), three with
    `use_flash=True` (kernels C, D, E, causal) and two with
    `use_flash="train-jax"` (kernel J); the two arms' losses on the same
    parameters; greedy generation at 32 frames, 16 new tokens, through
    kernels A (tower) and B (causal prefill). Then, on videoitg-8b-shallow:
    each kernel arm's loss and LoRA gradients against the plain path, the
    kernel path's prefill logits and cache against the plain path's, and the
    optimizer offload against the plain step. Returns the launch counts of
    the "train-jax" steps (kernel J) and of the generation (A, B)."""
    import numpy as np
    import torch

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.models import qwen2 as qwen2_mod
    from videoitg_tpu_torch.models import vlm
    from videoitg_tpu_torch.train import offload
    from videoitg_tpu_torch.train.lora import add_lora, make_lora_optimizer
    from videoitg_tpu_torch.train.train_step import create_train_state, run_step
    from videoitg_tpu_torch.train.vlm_sft import VLMSample, collate_vlm, make_vlm_train_step

    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    rng = np.random.default_rng(SEED + 71)
    counted = wrappers()

    def sample(cfg, t, n_pre=30, n_post=200, n_labels=150):
        post = rng.integers(1, cfg.lm.vocab_size, n_post).tolist()
        labels = [-100] * (n_post - n_labels) + post[n_post - n_labels:]
        return VLMSample(frames_u8(rng, t), rng.integers(1, cfg.lm.vocab_size, n_pre).tolist(),
                         post, labels)

    # ---- full width: VideoITG-8B causal, LoRA r16, a 256-frame video sample ----
    t0 = time.perf_counter()
    model, cfg, _ = load_grounding_components(None, "videoitg-8b", True, torch.bfloat16, dev,
                                              seed=SEED)
    cfg = causal_tied(cfg)
    add_lora(model, gen, rank=16)
    tx = make_lora_optimizer(model, learning_rate=2e-4, total_steps=10)
    state = create_train_state(model, tx)
    trainable = set(tx.trainable_names())
    base = [p for n, p in model.named_parameters() if n not in trainable]
    torch.cuda.synchronize()
    print(f"vlm: videoitg-8b causal bf16 + LoRA r16: {sum(p.numel() for p in base) / 1e9:.3f} B "
          f"frozen, {sum(p.numel() for p in tx.params) / 1e6:.3f} M trainable parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    before = bit_checksums(base)
    lora_b0 = model.lm.layers[0].q.lora_b.detach().clone()

    t_frames, hw = 256, 8
    n_layers, tower_layers = cfg.lm.num_layers, cfg.vision.num_effective_layers
    batch = collate_vlm([sample(cfg, t_frames)], t_frames, cfg, dtype=torch.bfloat16, device=dev)
    tokens = batch.pre_ids.shape[1] + t_frames * hw * hw + batch.post_ids.shape[1]
    print(f"train [8b vlm lora] batch frames {list(batch.frames.shape)} bf16, hw {hw}, pre "
          f"{batch.pre_ids.shape[1]} / post {batch.post_ids.shape[1]} slots, {tokens} LM tokens, "
          f"{int(batch.post_labels.ne(-100).sum())} label tokens", flush=True)
    step_fn = make_vlm_train_step(cfg, tx, hw=hw, use_flash=True, remat=True)
    state, _ = train_steps("8b vlm lora, train arm", state, step_fn, batch, 3,
                           expect_launches("train", n_layers, tower_layers), card)
    step_fn = make_vlm_train_step(cfg, tx, hw=hw, use_flash="train-jax", remat=True)
    state, launches = train_steps("8b vlm lora, train-jax arm", state, step_fn, batch, 2,
                                  expect_launches("train-jax", n_layers, tower_layers), card)
    if bit_checksums(base) != before:
        fail("a frozen base weight changed during the VLM LoRA steps")
    if torch.equal(model.lm.layers[0].q.lora_b, lora_b0):
        fail("lora_b did not change over the VLM LoRA steps")
    # The two arms on the same parameters: they differ on invalid rows only,
    # which reach neither the loss nor a valid row.
    with torch.no_grad():
        arm_loss = {arm: vlm.vlm_loss(model, batch, cfg, hw=hw, use_flash=arm)[0].item()
                    for arm in ("train", "train-jax")}
    rel = abs(arm_loss["train"] - arm_loss["train-jax"]) / abs(arm_loss["train"])
    print(f"train [8b vlm lora] frozen leaves bit-identical, lora_b changed; loss on the same "
          f"parameters: train arm {arm_loss['train']:.6f}, train-jax arm "
          f"{arm_loss['train-jax']:.6f} (relative {rel:.3g}, tol 1e-3)", flush=True)
    if not rel <= 1e-3:
        fail(f"the two training arms disagree: {arm_loss}")
    del state, tx, step_fn, batch, base
    torch.cuda.empty_cache()

    # ---- generation at full width: 32 frames (hw 22, 15,488 image tokens) ----
    t_frames = 32
    hw = cfg.projector.tokens_hw(t_frames, cfg.vision.num_patches_per_side)
    s = sample(cfg, t_frames, n_pre=30, n_post=40)
    prompt = collate_vlm([s], t_frames, cfg, max_pre=32, max_post=64, dtype=torch.bfloat16,
                         device=dev)._replace(post_labels=None)

    def generate(n_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vlm.vlm_generate(model, prompt, cfg, hw=hw, max_new_tokens=n_new, use_flash=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    generate(2)  # warm-up
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    _, prefill_s = generate(1)  # tower, packing, prefill and the first token: no decode step
    first = {name: fn.launches for name, fn in counted.items() if fn.launches}
    for fn in counted.values():
        fn.launches = 0
    n_new = 16
    out, total_s = generate(n_new)
    gen_launches = {name: fn.launches for name, fn in counted.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # ms per decoded token from the decode steps themselves, in this process:
    # one prefill, then n_new - 1 `vlm_decode_step`s between two synchronises,
    # three times (two separate generate calls differ by the prefill's noise).
    decode_ms = []
    with torch.no_grad():
        x, valid, positions, _ = vlm._pack_embeds(model, prompt, cfg, hw, True, False, True)
        for _ in range(3):
            last, cache = vlm.vlm_prefill(model.lm, x, valid, positions, cfg.lm,
                                          x.shape[1] + n_new, use_flash=True)
            tok = qwen2_mod.lm_logits(model.lm, last[:, None], cfg.lm)[:, 0].argmax(dim=-1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_new - 1):
                logits, cache = vlm.vlm_decode_step(model, tok, cache, cfg.lm)
                tok = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0) / (n_new - 1))
        del x, valid, positions, last, cache
    toks = out[0].tolist()
    print(f"generate [8b vlm] {t_frames} frames, hw {hw}, prompt of "
          f"{32 + t_frames * hw * hw + 64} slots, {n_new} new tokens: prefill (tower + packing + "
          f"causal prefill + first token) {prefill_s:.4f} s, total {total_s:.4f} s, peak device "
          f"memory {peak:.3f} GiB, launches {gen_launches}, tokens {toks}; decode, "
          f"{n_new - 1} steps timed alone after a prefill, three repeats in this process: "
          f"{', '.join(f'{ms:.3f}' for ms in decode_ms)} ms per decoded token [{card}]",
          flush=True)
    if tuple(out.shape) != (1, n_new) or out.dtype != torch.int32 or \
            not all(0 <= tok < cfg.lm.vocab_size for tok in toks):
        fail(f"generation returned {out}")
    if gen_launches != first or gen_launches.get("flash_mha") != n_layers or \
            gen_launches.get("flash_mha_short", 0) <= 0 or len(gen_launches) != 2:
        fail(f"generation launched {gen_launches} (first token alone {first}): expected kernel "
             f"B {n_layers} times, kernel A, and nothing else")
    del model, prompt
    torch.cuda.empty_cache()

    # ---- kernel arms vs plain path on videoitg-8b-shallow, 8 frames ----
    model, cfg, _ = load_grounding_components(None, "videoitg-8b-shallow", True, torch.bfloat16,
                                              dev, seed=SEED)
    cfg = causal_tied(cfg)
    add_lora(model, gen, rank=16)
    for layer in model.lm.layers:  # B = 0 would leave A without gradient
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            getattr(layer, name).lora_b.data.normal_(0.0, 0.02, generator=gen)
    tx = make_lora_optimizer(model, total_steps=10)
    hw = 8
    batch = collate_vlm([sample(cfg, 8, n_pre=20, n_post=60, n_labels=40)], 8, cfg, max_pre=32,
                        max_post=64, dtype=torch.bfloat16, device=dev)
    results = {}
    for arm in (False, True, "train-jax"):
        loss, _ = vlm.vlm_loss(model, batch, cfg, hw, use_flash=arm, remat=True)
        results[arm] = (loss.item(), torch.autograd.grad(loss, tx.params, allow_unused=True))
    loss_p, grads_p = results[False]
    for arm in (True, "train-jax"):
        loss_k, grads_k = results[arm]
        rel_loss = abs(loss_k - loss_p) / abs(loss_p)
        # Relative to each leaf's own largest gradient. A 0-d leaf (`lora_scale`)
        # has no other entry to be measured against and its gradient is one sum
        # with cancellation (1e-4 here, where its neighbours' are 1e-2), so the
        # 0-d leaves are taken together as one vector.
        named = [(n, gk.float(), gp.float())
                 for n, gk, gp in zip(tx.trainable_names(), grads_k, grads_p) if gp is not None]
        scalars = [(gk, gp) for _, gk, gp in named if gp.dim() == 0]
        named = [x for x in named if x[2].dim() > 0]
        named.append(("all 0-d leaves (lora_scale)", torch.stack([gk for gk, _ in scalars]),
                      torch.stack([gp for _, gp in scalars])))
        per_leaf = sorted(((gk - gp).abs().max().item() / gp.abs().max().item(), name,
                           gp.abs().max().item())
                          for name, gk, gp in named if gp.abs().max().item() > 0)
        rel_grad = per_leaf[-1][0]
        print(f"agreement videoitg-8b-shallow causal, 8 frames, VLM loss and LoRA gradients, "
              f"use_flash={arm!r} vs plain path: loss {loss_k:.6f} vs {loss_p:.6f} (relative "
              f"{rel_loss:.3g}, tol 2e-2); worst max|diff| / max|plain| over the leaves "
              f"{rel_grad:.3g} (tol 5e-2); the three worst (leaf, ratio, max|plain|) "
              f"{[(n, round(r, 4), float(f'{m:.3g}')) for r, n, m in per_leaf[-3:]]}", flush=True)
        if not (rel_loss <= 2e-2 and rel_grad <= 5e-2):
            fail(f"VLM training: use_flash={arm!r} and the plain path disagree")
    del results, grads_p

    # Generation: kernel path (A, B causal) vs plain path. The decode steps
    # run the same code on both; what can differ is the prefill.
    prompt = batch._replace(post_labels=None)
    with torch.no_grad():
        packed = {}
        for use_flash in (True, False):
            x, valid, positions, _ = vlm._pack_embeds(model, prompt, cfg, hw, use_flash, False,
                                                      True)
            last, cache = vlm.vlm_prefill(model.lm, x, valid, positions, cfg.lm,
                                          x.shape[1] + 4, use_flash=use_flash)
            logits = qwen2_mod.lm_logits(model.lm, last[:, None], cfg.lm)[0, 0]
            packed[use_flash] = (logits, cache, valid)
        (lk, ck, valid), (lp, cp, _) = packed[True], packed[False]
        diff = (lk - lp).abs().max().item()
        top2 = lp.topk(2).values
        margin = (top2[0] - top2[1]).item()
        tol = 2e-2 * lp.abs().max().item()
        s0 = valid.shape[1]
        keys = valid[0].nonzero()[:, 0]
        cache_diff = max((ck.k[:, 0, :, keys] .float() - cp.k[:, 0, :, keys].float()).abs().max(),
                         (ck.v[:, 0, :, keys].float() - cp.v[:, 0, :, keys].float()).abs().max()
                         ).item()
        cache_tol = 2e-2 * max(cp.k[:, :, :, :s0].abs().max().item(),
                               cp.v[:, :, :, :s0].abs().max().item())
        tok_k = vlm.vlm_generate(model, prompt, cfg, hw=hw, max_new_tokens=8, use_flash=True)
        tok_p = vlm.vlm_generate(model, prompt, cfg, hw=hw, max_new_tokens=8, use_flash=False)
    same = int((tok_k == tok_p)[0].to(torch.int32).cumprod(dim=0).sum().item())
    print(f"agreement videoitg-8b-shallow causal, 8 frames, generation, kernel vs plain path: "
          f"first-token logits max |diff| {diff:.6g} (tol {tol:.6g} = 2e-2 max|logit|; plain "
          f"top-1 margin {margin:.6g}), cache at valid slots max |diff| {cache_diff:.6g} (tol "
          f"{cache_tol:.6g}); tokens kernel {tok_k[0].tolist()} plain {tok_p[0].tolist()} "
          f"({same} of 8 leading tokens equal)", flush=True)
    if not (diff <= tol and cache_diff <= cache_tol):
        fail("VLM prefill: kernel path and plain path disagree")
    if margin > 2 * diff and tok_k[0, 0] != tok_p[0, 0]:
        fail("VLM generation: first token differs although the logits agree")

    # ---- optimizer offload: the same steps, Adam's moments on the host between them ----
    ends = []
    for wrap in (False, True):
        for p, p0 in zip(tx.params, ends[0]["start"] if ends else ()):
            p.data.copy_(p0)
        tx = make_lora_optimizer(model, learning_rate=2e-4, total_steps=10)
        state = create_train_state(model, tx)
        start = [p.detach().clone() for p in tx.params]
        step_fn = make_vlm_train_step(cfg, tx, hw=hw, use_flash=True, remat=True)
        if wrap:
            step_fn = offload.make_offloaded_train_step(step_fn)
        for _ in range(3):
            state, _ = run_step(step_fn, state, batch)
        ends.append(dict(start=start, end=[p.detach().clone() for p in tx.params]))
        if wrap:
            moments = [s[k] for s in tx.optimizer.state.values() for k in ("exp_avg", "exp_avg_sq")]
            parked = sum(m.numel() * m.element_size() for m in moments)
            if not moments or not all(m.device.type == "cpu" and m.is_pinned() for m in moments):
                fail("offload: Adam's moments are not in pinned host memory between steps")
    if not all(torch.equal(a, b) for a, b in zip(ends[0]["end"], ends[1]["end"])):
        fail("offload: the offloaded steps differ from the plain steps")
    if all(torch.equal(a, b) for a, b in zip(ends[0]["start"], ends[0]["end"])):
        fail("offload: nothing trained")
    print(f"offload videoitg-8b-shallow causal LoRA: 3 steps with Adam's moments parked in pinned "
          f"host memory between steps ({parked / 2**20:.2f} MiB) equal the plain steps bit for "
          f"bit", flush=True)
    del model, tx, state, batch
    torch.cuda.empty_cache()
    return {**{name: launches[name] for name in SEGMENT_KERNELS},
            "flash_mha": gen_launches["flash_mha"],
            "flash_mha_short": gen_launches["flash_mha_short"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["attention-kernels", "int8-kernels", "train-kernels",
                                          "splash-kernels",
                                          "segment-kernels", "vlm",
                                          "serve", "train"],
                        default=None,
                        help="build, then only: check kernels A, B (attention-kernels), F-I "
                             "(int8-kernels), C, D, E (train-kernels), K, L (splash-kernels) "
                             "or J (segment-kernels) against their plain versions, with "
                             "ptxas' lines for the TMA + wgmma instances among them; or run "
                             "the daemon phase (serve), "
                             "the training phases (train) or the causal-VLM phases (vlm)")
    args = parser.parse_args(argv)
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
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Performance")) or \
                "warning" in line.lower():
            print(f"  ptxas: {line.strip()}", flush=True)

    if args.only in PTXAS:
        if _build.build_seconds is None:
            print("  ptxas: cached build, no lines (remove the build directory to see them)",
                  flush=True)
        for tag, pattern in PTXAS[args.only]:
            for line in ptxas_lines(_build.build_log, pattern):
                print(f"  ptxas {tag}: {line}", flush=True)
    if args.only == "attention-kernels":
        check_kernels(dev)
        print("attention kernels A and B agree with their plain versions", flush=True)
        return 0
    if args.only == "int8-kernels":
        check_int8_kernels(dev)
        print("int8 kernels agree with their plain versions", flush=True)
        return 0
    if args.only == "train-kernels":
        check_train_kernels(dev)
        print("training attention kernels agree with their plain versions", flush=True)
        return 0
    if args.only == "splash-kernels":
        check_splash_kernels(dev)
        print("splash and repro kernels agree with their plain versions", flush=True)
        return 0
    if args.only == "segment-kernels":
        check_segment_kernels(dev)
        print("segment-id attention kernels agree with their plain versions", flush=True)
        return 0
    if args.only == "serve":
        run_serving(dev, card)
        print("serving phase passed", flush=True)
        return 0
    if args.only == "train":
        run_training(dev, card)
        print("training phases passed", flush=True)
        return 0
    if args.only == "vlm":
        run_vlm(dev, card)
        print("causal-VLM phases passed", flush=True)
        return 0
    records = check_kernels(dev)
    records.update(check_train_kernels(dev))
    records.update(check_int8_kernels(dev))
    records.update(check_splash_kernels(dev))
    records.update(check_segment_kernels(dev))
    check_agreement(dev)
    launches = run_slices(dev, card)
    torch.cuda.empty_cache()
    for name, n in run_serving(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    launches.update(run_repro_script())
    train_launches = run_training(dev, card)
    launches.update({name: train_launches[name] for name in TRAIN_KERNELS})
    for name, n in run_vlm(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    for name, rec in records.items():
        rec["launches"] = launches[name]
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "videoitg_tpu"))
    if loaded:
        fail(f"the port imported {loaded}")
    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
