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
     different valid lengths, D = 72 with GQA, seven more head dims from 8
     to 120 (every instantiation runs), and the tower's shape
     [32, 16, 729, 72] (forward only). The backward is compared like with
     like: both sides get the kernel's own o and lse. Tolerance: 4 bf16
     half-ulps of each output's max|reference|, lse 1e-3 absolute. Invalid
     rows of o and dq and invalid keys of dk, dv must be exactly 0, and two
     runs of dK/dV bit-equal. Library call: scaled_dot_product_attention
     forward for C, its autograd backward for D and E together.
   * A, B (attention, bf16): plus a long case whose length is not a multiple
     of the 64-key tile, a small causal case and a fully-masked-row case.
     Tolerance: 4 bf16 half-ulps of the case's max|reference| (see
     bf16_tol). Masked rows must be exactly 0.
   * F (act8 GEMM) at the LM's four shapes, M = 13,056, plus a ragged M with
     a zero row. The integer sums are exact and the epilogue has the plain
     version's operation order: tolerance 1 bf16 ulp of max|reference|.
   * G, H (both activations), I (fused int8 encoder kernels) at [93,312,
     1152] and at a ragged row count. LN sums run in another order, which
     flips a few int8 roundings: tolerance 4 max|ref| / 127 + 1e-5, the JAX
     package's own bound for these kernels.
   At each main-path shape, deliberately broken uses (keys dropped, the key
   mask ignored, a bias, the LN bias or the residual dropped, the last k
   tile of fc2 dropped) must exceed the tolerance, which shows that it
   discriminates.
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
6. Training: VideoITG-8B bf16 with LoRA r16 adapters (random weights and
   adapters from seeded generators), `make_lora_optimizer`, `make_train_step(
   use_flash=True, remat=True)`, through `run_step`. Three steps on a
   1024-frame feature batch [1, 1024, 729, 1152] made on the device (hw 4,
   16,640 LM tokens), then two steps on 32 uint8 frames through
   `collate_grounding` (the frozen tower in the step). At every step the
   loss is finite and the launch counts are exact: C twice a layer (forward
   and recompute) plus once per tower layer when frames come in, D and E
   once a layer. The frozen leaves must be bit-identical afterwards, lora_b
   and out_proj changed. Then, on videoitg-8b-shallow at 8 frames: the loss
   and LoRA gradients of the kernel path against the plain path (loss 2e-2
   relative; gradients 5e-2 of each leaf's largest entry), and two QLoRA
   steps each over an int8 and an int4 base (integer bytes unchanged).

`--only int8-kernels` stops after building and checking kernels F-I,
`--only train-kernels` after C, D, E (a short first run for a new kernel);
`--only train` runs phase 6 alone. None of them prints a result line.

The last two lines are the per-kernel JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
          f"{library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}",
          flush=True)
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
          f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}", flush=True)
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
    from videoitg_tpu_torch.ops import fused_encoder as fe
    from videoitg_tpu_torch.ops import quant_gemm as qg
    from videoitg_tpu_torch.ops.quant import QuantLinear, quantize_linear_int8, row_quant

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

    # ---- F: the LM's four linears at 13,056 tokens. ----
    m = 512 * 25 + 256
    per_layer = {(3584, 3584): 2, (3584, 512): 2, (3584, 18944): 2, (18944, 3584): 1}
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    worst, shapes = 0.0, []
    for (k, n), count in per_layer.items():
        lin = int8_linear(k, n)
        x = randn(m, k).to(torch.bfloat16)
        xs = qg.row_scale(x)
        ref = qg.act8_gemm_reference(x, xs, lin.w_qt, lin.scale)
        out = qg.act8_gemm(x, xs, lin.w_qt, lin.scale)
        # One ulp of bf16 (8 significant bits) at max|ref|.
        tol = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
        err, mean = err_stats(out, ref)
        equal = bool(torch.equal(out, ref))
        ms = cuda_ms(lambda: qg.act8_gemm(x, xs, lin.w_qt, lin.scale), 10)
        plain_ms = cuda_ms(lambda: qg.act8_gemm_reference(x, xs, lin.w_qt, lin.scale), 3)
        x_q, _ = row_quant(x.float())
        int_mm_ms = cuda_ms(lambda: torch._int_mm(x_q, lin.w_qt.t()), 10)
        bnd = bound(2 * m * k * n, PEAK_INT8, m * k * 2 + m * 4 + n * k + n * 4 + m * n * 2)
        print(f"kernel act8_gemm [{m}, {k}] x [{k}, {n}]: max_abs_err {err:.6g} mean {mean:.3g} "
              f"(tol {tol:.6g} = 1 bf16 ulp, bit-equal {equal}); {ms:.4f} ms "
              f"({2 * m * k * n / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; for orientation, the bare "
              f"torch._int_mm product alone {int_mm_ms:.4f} ms", flush=True)
        if not err <= tol:
            fail(f"act8_gemm [{k} -> {n}] error {err} > {tol}")
        worst = max(worst, err)
        shapes.append(dict(k=k, n=n, per_layer=count, ms=ms, plain_ms=plain_ms,
                           int_mm_ms=int_mm_ms, **bnd))
        total["ms"] += count * ms
        total["plain_ms"] += count * plain_ms
        total["bound_ms"] += count * bnd["bound_ms"]
        total["ops_ms"] += count * 1e3 * 2 * m * k * n / PEAK_INT8
        total["bytes_ms"] += count * 1e3 * (m * k * 2 + n * k + m * n * 2) / PEAK_HBM
        if (k, n) == (3584, 512):
            # A ragged M (not a multiple of the 128-row tile) with a zero row,
            # and what a use that forgot the column scales would give.
            xr = x[:1001].clone()
            xr[5] = 0
            xsr = qg.row_scale(xr)
            refr = qg.act8_gemm_reference(xr, xsr, lin.w_qt, lin.scale)
            outr = qg.act8_gemm(xr, xsr, lin.w_qt, lin.scale)
            errr, _ = err_stats(outr, refr)
            zero_row = outr[5].abs().max().item()
            broken, _ = err_stats(qg.act8_gemm(xr, xsr, lin.w_qt, torch.ones_like(lin.scale)),
                                  refr)
            print(f"kernel act8_gemm ragged [1001, {k}] x [{k}, {n}], row 5 zero: max_abs_err "
                  f"{errr:.6g} (tol {tol:.6g}); zero row max {zero_row}; broken: column scales "
                  f"dropped {broken:.6g}", flush=True)
            if not errr <= tol or zero_row != 0.0 or xsr[5].item() != 1.0:
                fail("act8_gemm ragged / zero-row case")
            if not broken > tol:
                fail(f"act8_gemm tolerance {tol} does not catch dropped scales ({broken})")
            worst = max(worst, errr)
        del lin, x, xs, ref, out, x_q
    records["act8_gemm"] = dict(
        name="act8_gemm", route="cuda", source="videoitg_tpu_torch/csrc/quant_gemm.cu",
        replaces="videoitg_tpu/ops/quant_gemm.py:32", max_abs_err=worst, ms=total["ms"],
        plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
        bound_by="operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes",
        library_ms=None, per="the 7 launches of one LM layer at 13,056 tokens", shapes=shapes)
    print(f"kernel act8_gemm, one LM layer (7 launches): {total['ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms", flush=True)

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

    # G
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
    ragged = fe.fused_ln_qkv_int8(x[:1000], ln, q_lin, k_lin, v_lin, eps)
    err_r = max(err_stats(o, r[:1000])[0] for o, r in zip(ragged, refs))
    ms = cuda_ms(lambda: fe.fused_ln_qkv_int8(x, ln, q_lin, k_lin, v_lin, eps), 5)
    plain_ms = cuda_ms(lambda: fe.fused_ln_qkv_int8_reference(x, ln, q_lin, k_lin, v_lin, eps), 2)
    n_out = 3 * h
    bnd = bound(2 * rows * h * n_out, PEAK_INT8,
                rows * h * 2 + n_out * h + rows * n_out * 2 + 2 * n_out * 4 + 2 * h * 4)
    print(f"kernel fused_ln_qkv_int8 [{rows}, {h}] -> 3 x [{rows}, {h}]: max_abs_err {err:.6g} "
          f"mean {mean:.3g} (tol {tol:.6g}); ragged 1000 rows {err_r:.6g}; broken: LN bias "
          f"ignored {broken_lnb:.6g}, bias dropped {broken_b:.6g}; {ms:.4f} ms "
          f"({2 * rows * h * n_out / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}", flush=True)
    if not (err <= tol and err_r <= tol):
        fail(f"fused_ln_qkv_int8 error {err} / {err_r} > {tol}")
    if not (broken_lnb > tol and broken_b > tol):
        fail(f"fused_ln_qkv_int8 tolerance {tol} does not catch a broken use "
             f"({broken_lnb}, {broken_b})")
    records["fused_ln_qkv_int8"] = dict(
        name="fused_ln_qkv_int8", route="cuda",
        source="videoitg_tpu_torch/csrc/fused_encoder.cu",
        replaces="videoitg_tpu/ops/fused_encoder.py:84", max_abs_err=max(err, err_r),
        mean_abs_err=mean, ms=ms, plain_ms=plain_ms, library_ms=None, **bnd)
    del refs, outs, no_lnb, no_b, ragged

    # I
    o_lin = int8_linear(h, h, bias_std=0.5)
    attn = randn(rows, h).to(torch.bfloat16)
    ref = fe.fused_proj_residual_int8_reference(attn, x, o_lin)
    out = fe.fused_proj_residual_int8(attn, x, o_lin)
    tol = int8_tol(ref.float())
    err, mean = err_stats(out, ref)
    no_res, _ = err_stats(out[:sub], fe.fused_proj_residual_int8_reference(
        attn[:sub], torch.zeros_like(x[:sub]), o_lin))
    no_b, _ = err_stats(out[:sub], fe.fused_proj_residual_int8_reference(
        attn[:sub], x[:sub], without_bias(o_lin)))
    err_r, _ = err_stats(fe.fused_proj_residual_int8(attn[:1000], x[:1000], o_lin), ref[:1000])
    ms = cuda_ms(lambda: fe.fused_proj_residual_int8(attn, x, o_lin), 5)
    plain_ms = cuda_ms(lambda: fe.fused_proj_residual_int8_reference(attn, x, o_lin), 2)
    bnd = bound(2 * rows * h * h, PEAK_INT8, 3 * rows * h * 2 + h * h + 2 * h * 4)
    print(f"kernel fused_proj_residual_int8 [{rows}, {h}]: max_abs_err {err:.6g} mean "
          f"{mean:.3g} (tol {tol:.6g}); ragged 1000 rows {err_r:.6g}; broken: residual dropped "
          f"{no_res:.6g}, bias dropped {no_b:.6g}; {ms:.4f} ms "
          f"({2 * rows * h * h / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}", flush=True)
    if not (err <= tol and err_r <= tol):
        fail(f"fused_proj_residual_int8 error {err} / {err_r} > {tol}")
    if not (no_res > tol and no_b > tol):
        fail(f"fused_proj_residual_int8 tolerance {tol} does not catch a broken use "
             f"({no_res}, {no_b})")
    records["fused_proj_residual_int8"] = dict(
        name="fused_proj_residual_int8", route="cuda",
        source="videoitg_tpu_torch/csrc/fused_encoder.cu",
        replaces="videoitg_tpu/ops/fused_encoder.py:121", max_abs_err=max(err, err_r),
        mean_abs_err=mean, ms=ms, plain_ms=plain_ms, library_ms=None, **bnd)
    del attn, ref, out

    # H, both activations. The last 16 intermediate channels get a large
    # fc1 bias, so that a kernel which dropped the last (ragged) k tile of
    # fc2 (bytes 4288..4303 of 4304) would stand out.
    fc1, fc2 = int8_linear(h, inter, bias_std=0.1), int8_linear(inter, h, bias_std=0.5)
    fc1.b.data[-16:] += 4.0
    fc2_cut = QuantLinear(w_qt=fc2.w_qt.clone(), scale=fc2.scale, b=fc2.b, act_q=True)
    fc2_cut.w_qt[:, -16:] = 0
    worst, worst_mean, times = 0.0, 0.0, {}
    for act in ("gelu_tanh", "quick_gelu"):
        ref = fe.fused_ln_mlp_int8_reference(x, ln, fc1, fc2, eps, act)
        out = fe.fused_ln_mlp_int8(x, ln, fc1, fc2, eps, act)
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
        print(f"kernel fused_ln_mlp_int8 {act} [{rows}, {h}] via {inter}: max_abs_err {err:.6g} "
              f"mean {mean:.3g} (tol {tol:.6g}); ragged 1000 rows {err_r:.6g}; broken: last k "
              f"tile of fc2 dropped {no_tile:.6g}, LN bias ignored {no_lnb:.6g}, residual "
              f"dropped {no_res:.6g}; {ms:.4f} ms ({4 * rows * h * inter / ms / 1e9:.1f} TOP/s "
              f"of the 2 products asked for), plain {plain_ms:.4f} ms", flush=True)
        if not (err <= tol and err_r <= tol):
            fail(f"fused_ln_mlp_int8 {act} error {err} / {err_r} > {tol}")
        if not (no_tile > tol and no_lnb > tol and no_res > tol):
            fail(f"fused_ln_mlp_int8 {act} tolerance {tol} does not catch a broken use "
                 f"({no_tile}, {no_lnb}, {no_res})")
        worst, worst_mean = max(worst, err, err_r), max(worst_mean, mean)
        times[act] = (ms, plain_ms)
        del ref, out
    # fc1 and fc2 once each; x read, out written, both weights read.
    bnd = bound(4 * rows * h * inter, PEAK_INT8,
                2 * rows * h * 2 + 2 * h * inter + 2 * (inter + h) * 4 + 2 * h * 4)
    print(f"kernel fused_ln_mlp_int8: bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}",
          flush=True)
    records["fused_ln_mlp_int8"] = dict(
        name="fused_ln_mlp_int8", route="cuda",
        source="videoitg_tpu_torch/csrc/fused_encoder.cu",
        replaces="videoitg_tpu/ops/fused_encoder.py:105", max_abs_err=worst,
        mean_abs_err=worst_mean, ms=times["gelu_tanh"][0], plain_ms=times["gelu_tanh"][1],
        quick_gelu_ms=times["quick_gelu"][0], library_ms=None, **bnd)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def check_train_kernels(dev) -> dict:
    """Kernels C, D, E (trainable attention: forward + lse, dQ, dK/dV) vs
    their plain versions; returns name -> record. The backward is compared
    like with like: both sides get the kernel's own saved forward (o, lse)."""
    import torch
    from torch.nn import functional as F

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
    # padded to a multiple of 16 in shared memory), at a small ragged length.
    for d in (8, 24, 40, 56, 88, 104, 120):
        q, k, v = randn(1, 4, 130, d), randn(1, 2, 130, d), randn(1, 2, 130, d)
        widen(run_case(f"[1, 4/2, 130, {d}], 100 valid", q, k, v,
                       torch.arange(130, device=dev)[None] < 100, causal=d % 32 == 24))

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
    from videoitg_tpu_torch.ops import flash_attention_train as fat
    from videoitg_tpu_torch.ops import fused_encoder as fe
    from videoitg_tpu_torch.ops.flash_attention import flash_mha
    from videoitg_tpu_torch.ops.flash_attention_short import flash_mha_short
    from videoitg_tpu_torch.ops.quant_gemm import act8_gemm

    return {"flash_mha_short": flash_mha_short, "flash_mha": flash_mha, "act8_gemm": act8_gemm,
            "fused_ln_qkv_int8": fe.fused_ln_qkv_int8, "fused_ln_mlp_int8": fe.fused_ln_mlp_int8,
            "fused_proj_residual_int8": fe.fused_proj_residual_int8,
            "flash_train_fwd": fat.flash_train_fwd, "flash_train_dq": fat.flash_train_dq,
            "flash_train_dkv": fat.flash_train_dkv}


SERVING_KERNELS = ("flash_mha_short", "flash_mha", "act8_gemm", "fused_ln_qkv_int8",
                   "fused_ln_mlp_int8", "fused_proj_residual_int8")
TRAIN_KERNELS = ("flash_train_fwd", "flash_train_dq", "flash_train_dkv")


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
        print(f"train [{tag}] step {state.step}: {wall:.4f} s, loss {m['loss']:.6f}, grad_norm "
              f"{m['grad_norm']:.6f}, pos_weight {m['pos_weight']:.4f}, launches "
              f"{ {k: launches[k] for k in TRAIN_KERNELS} } [{card}]", flush=True)
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
    expect = {"flash_train_fwd": 2 * n_layers, "flash_train_dq": n_layers,
              "flash_train_dkv": n_layers}
    state, launches = train_steps("8b lora, features", state, step_fn, batch, 3, expect, card)
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
    expect = {"flash_train_fwd": cfg.vision.num_effective_layers + 2 * n_layers,
              "flash_train_dq": n_layers, "flash_train_dkv": n_layers}
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
        n_layers = cfg.lm.num_layers
        expect = {"flash_train_fwd": cfg.vision.num_effective_layers + 2 * n_layers,
                  "flash_train_dq": n_layers, "flash_train_dkv": n_layers}
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["int8-kernels", "train-kernels", "train"],
                        default=None,
                        help="build, check kernels F-I (int8-kernels) or C, D, E "
                             "(train-kernels) against their plain versions, stop")
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
        if "registers" in line or "spill" in line or "warning" in line.lower():
            print(f"  ptxas: {line.strip()}", flush=True)

    if args.only == "int8-kernels":
        check_int8_kernels(dev)
        print("int8 kernels agree with their plain versions", flush=True)
        return 0
    if args.only == "train-kernels":
        check_train_kernels(dev)
        print("training attention kernels agree with their plain versions", flush=True)
        return 0
    if args.only == "train":
        run_training(dev, card)
        print("training phases passed", flush=True)
        return 0
    records = check_kernels(dev)
    records.update(check_train_kernels(dev))
    records.update(check_int8_kernels(dev))
    check_agreement(dev)
    launches = run_slices(dev, card)
    torch.cuda.empty_cache()
    train_launches = run_training(dev, card)
    launches.update({name: train_launches[name] for name in TRAIN_KERNELS})
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
