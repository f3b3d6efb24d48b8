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
     fully-masked-row case; A at the CLIP tower's chunk [128, 16, 577, 64]
     and at the 8 frames [8, 16, 577, 64] of the mlp2x_gelu checkpoint cell
     (each with the broken use, timed beside its plain version, the library
     call and its bound, as at SigLIP's chunk), at ragged
     S = 577 and 1,000, at S = 500 with
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
     `torch._int_mm` products (H's fc1 and fc2 each). G, H with quick_gelu and I run again, every
     check and broken use included, at the CLIP tower's widths: [73,856,
     1024] via 4096 (128 frames x 577 tokens), LN eps 1e-5 (fc1's last n
     tile is whole there, so the padded-columns use has nothing to count).
     `--only int8-kernels` prints ptxas' lines for F's, G's, H's and I's
     instances, and the library must hold them and not the mma.sync kernels
     they replaced.
   At each main-path shape, deliberately broken uses (keys dropped, the key
   mask or the segment ids ignored, q not pre-scaled, a head of the group
   left out, a bias, the LN bias or the residual dropped, fc2's last 16 k
   channels dropped, H's row amax from one n tile or with padded columns, G's
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
   Checkpoints: HF-format directories written by `save_hf_checkpoint` (fp32
   safetensors) into a temporary directory and read back in bf16 by
   `load_grounding_model`, bit-equal to the model written: videoitg-8b-shallow
   (one 512-frame select through the written and the loaded model: the same
   scores and Top-K index), the same LM under CLIP ViT-L/14-336's tower (3
   layers; a 512-frame select, then act8 with the int8 kernels on against
   off within E2E_ATOL) and that tower with the mlp2x_gelu projector (8
   frames, 4,608 image tokens). Each prints its file bytes, write and load
   seconds and GB/s, the load's device memory peak, and the host's peak
   resident set over the write and over the load (/proc/self/statm read
   every 2 ms by a thread); the launch counts of
   each select are exact (A, B, and F-I under act8). At videoitg-8b-shallow
   the act8 cold start from that HF file (read, then quantised at load) is
   timed against the serving checkpoint of the same model, twice each,
   alternated; both models bit-equal.
   Serving checkpoints: VideoITG-8B at full width and depth in the int8,
   int4 and act8 tiers, each a seeded bf16 model quantised in place on the
   card (timed), written by `save_serving_checkpoint` (bytes, seconds,
   GB/s, the host's peak rise) and read back onto the card by
   `load_serving_checkpoint` (seconds, device memory peak, host peak rise),
   bit-equal to the saved model; one 512-frame select through each (act8
   with F-I on) gives bit-equal raw scores and Top-K, with exact launches:
   A 104, B 28, under act8 also F 196, G, H, I 104.
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

9. Eval stage A: VideoITG-8B bf16 (random weights) through the port's
   `cli/evaluate.main` in this process, task videomme, a --docs_json of 6
   docs over 4 videos of 512 frames at target_fps=1 (one video with 3
   questions: `select_many`; three with one each: the `score_frames` group
   path), the frame reader swapped as in phase 6. Run at batch_size 1 and 2.
   The batch_size=1 rows equal the adapter's engine called directly on the
   same frames and prompts; the batch_size=2 raw scores are within E2E_ATOL
   of batch_size 1's; A launches 416 times a run, B 168 (batch_size 1) and
   140 (batch_size 2), nothing else. Prints docs per second, seconds per
   video, peak device memory and the report's videomme_perception_score.

10. Eval stage B: stage A at batch_size 1 as in phase 9 (its model freed
   after it), then `cli/evaluate.main --model videoitg-vlm` on its
   results.jsonl: VideoITG-8B's causal, tied variant in bf16 with random
   weights, num_frame=32 (hw 22), 16 new tokens, the libav reader of
   `frames_for_doc` swapped for one that hands out the same seeded frames.
   Videomme on the same 6 docs (generate_until), a loglikelihood task of two
   candidates on the first doc of each video, and the generation again with
   quantize=act8, VIDEOITG_QGEMM=1, VIDEOITG_FUSED=1. The frames asked for
   are stage A's first 32, ascending; every response and loglikelihood
   equals the adapter's model called directly; A launches 26 times and B 28
   times a request, and under act8 G, H and I 26 times a request and F 7
   times a layer for the prefill and for every decode step, nothing else.
   F is held to its plain version at M = 1 and at the prefill's M on the
   model's layer-0 weights, and timed for one LM layer at M = 1. Prints each
   run's evaluate_task seconds, docs per second, tower and prefill seconds,
   ms per decoded token, peak device memory and launches.

11. The mesh path (`--only mesh`), VideoITG-8B bf16: (a) a NCCL group of
   world size 1 (a FileStore in a temporary directory) and `make_mesh()`,
   every axis 1: the engine with that mesh returns the no-mesh engine's
   Top-K and scores bit for bit on a 512-frame `select` and a `select_many`
   of 3 questions, with A launching 104 times and B 28 times an LM pass on
   both; (b) A at one tensor-parallel rank's shapes ([128, 16/tp, 729, 72],
   tp 2 and 4) and B and K at [1, 28/tp q, 4/tp kv, 13,056, 128], each held
   to its plain version at the tolerances above, with CUDA-event ms and the
   bound; (c) every rank's steps of a ring of 2 and of 4 in one process
   (`parallel/ring_attention.ring_shard`: C's key-mask-only forward on each
   visiting block, then the merge) at [1, 28/4, 13,056, 128] with the keys
   past 9,792 masked (the ring of 4's last block has no valid key), the
   merged output held to the fp32 reference, to B on the unsplit sequence
   and to the ring's plain (einsum) blocks; C's ms at S/sp = 6,528 and 3,264
   beside its plain version and its bound; (d) on the same world-size-1
   mesh, phase 7's LoRA step (VideoITG-8B, r16, the 1024-frame feature
   batch, 16,640 tokens, remat) three times through `run_step(mesh=...)`
   and three times with no mesh, from the same start, without and with the
   optimizer's host offload: loss, grad_norm, the trainable leaves and the
   AdamW moments bit-equal, C, D and E launching 56, 28 and 28 times a step;
   (e) every rank's backward ring steps for rings of 2 and 4 in one process
   (`ring_shard_backward`: D and E on each visiting block with the global
   lse) at [1, 28/4, 16,640, 128] with the keys and rows past 12,480 masked
   (the ring of 4's last block has no valid key and no valid row), dq, dk
   and dv held to D and E on the unsplit sequence, to the fp32 autograd
   reference and to the ring through the plain versions, and D and E timed
   on a block at S/sp = 8,320 and 4,160 beside the plain version, the bound
   and their 3/7 and 4/7 shares of memory-efficient sdpa's autograd
   backward. No collective across devices is timed: the machine has one
   card (`scripts/torch_mesh_check.py` runs the layouts on several).

12. Lane-padded tower heads (`--only pad-heads`, `models/siglip.pad_attention_heads`):
   kernel A at [128, 16, 729, 128] (head_dim 72 zero-padded to 128, sm_scale
   72**-0.5: S = 729 is past K resident at D = 128, so the two-pass streaming
   form) against its plain version at the bf16 tolerance, its padded lanes
   exactly 0, its first 72 lanes against A at D = 72 on the same numbers, a
   broken use (keys dropped), timed beside A at D = 72 with both bounds, sdpa
   as the library call; then VideoITG-8B's tower (random bf16 weights) on one
   128-frame chunk, padded against unpadded, dense and act8: each layer on the
   same input within bf16_tol of its output, and the 26 layers' features
   within the larger of E2E_ATOL and twice the unpadded tower's own kernel vs
   plain path (relative to max|features|), A 26 launches a pass.

13. The overfit trajectory (`--only overfit`, scripts/train/torch_overfit_smoke.py):
   the JAX package's recorded recipe at videoitg-2b, LoRA 16, 400 steps, batch
   2, lr 2e-4 (out_proj 2e-3), a checkpoint every 25 steps, 32 videos, 8
   targets. The script's train CLI runs in child processes launched as
   `python3 chip_smoke.py --train-child -- ARGS`, which swaps
   `data/video.read_video_frames` for the fixtures' frames (frame i the solid
   colour `expected_fixture_color(i)` at 64x48, at the indices the port's own
   sampling gives) before calling `cli/train.main(ARGS)`, then prints the
   child's peak device memory and launch counts; the evaluation runs in this
   process under the same swap. Phase 1 must reach a checkpoint and be
   SIGKILLed, phase 2 must auto-resume and reach step 400, Top-1 on the 32
   training videos must reach 0.9; C 82, D 28, E 28 launches a step in phase
   2 (the frozen tower's C 26, the LM's C 56, D 28, E 28), A 26 and B 28 a
   video in the evaluation. Prints the step killed at and resumed from, the
   first and last logged loss, seconds a step with and without the
   checkpoints, the phase's seconds and Top-1.

14. The add + LayerNorm kernel (`--only layer-norm`, `ops/layer_norm.py`,
   ptxas' lines for its instances): against its plain version at the towers'
   chunks [93,312, 1152] and [73,856, 1024], with a delta and a bias, a delta
   alone and neither: r bit-equal, y within 1 bf16 ulp, timed beside its
   bound and `F.layer_norm` after the adds; VideoITG-8B's tower on a
   128-frame chunk, the carried loop against the plain loop in turns, no
   further from it than twice the plain bf16 loop's distance from fp32 (a
   dropped bias further); one 512-frame select launches it 208 times in bf16 and never in
   act8.

`--only attention-kernels` prints ptxas' lines for kernels A and B and stops
after checking them (a short first run after editing them),
`--only int8-kernels` stops after building and checking kernels F-I,
`--only train-kernels` after C, D, E, `--only splash-kernels` after K and L
`--only segment-kernels` after J (a short first run for a new kernel);
`--only serve` runs phase 6 alone, `--only train` phase 7, `--only vlm` phase
8, `--only checkpoint` the checkpoint part of phase 5, `--only
serving-checkpoint` its serving-checkpoint part, `--only eval` phase 9,
`--only stage-b` phase 10, `--only mesh` phase 11, `--only pad-heads` phase 12,
`--only overfit` phase 13, `--only layer-norm` phase 14.
None of them prints a result line. `--train-child -- ARGS` is phase 13's child
process, not a phase.

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
import threading
import time
from typing import Optional

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
    "mesh": (("C ring form", r"stream_kernel.*KeyMaskAllRows"), ("D", r"dq_kernel.*KeyMask"),
             ("E", r"dkv_kernel.*KeyMask")),
    "layer-norm": (("add_layer_norm", r"add_layer_norm_kernel"),),
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

    def check_short(shape) -> dict:
        """A at `shape` against its plain version (32 frames at a time, in
        fp32), with a broken use; its times beside sdpa's and its bound."""
        t, heads, s, d = shape
        q, k, v = (randn(*shape) for _ in range(3))
        parts = [slice(i, i + 32) for i in range(0, t, 32)]
        ref = torch.cat([flash_mha_short_reference(q[p].float(), k[p].float(), v[p].float())
                         for p in parts])
        tol = bf16_tol(ref)
        err = max_err(flash_mha_short(q, k, v), ref)
        # What a kernel that dropped the last 64 keys would give (the kernel
        # takes k/v of q's length only, so the plain version stands in for it).
        drop = max(max_err(flash_mha_short_reference(q[p].float(), k[p, :, :s - 64].float(),
                                                     v[p, :, :s - 64].float()), ref[p])
                   for p in parts)
        ms = cuda_ms(lambda: flash_mha_short(q, k, v), 20)
        plain_ms = cuda_ms(lambda: [flash_mha_short_reference(q[p], k[p], v[p]) for p in parts], 3)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
        # 4 S^2 D operations per (frame, head); q, k, v read and o written once.
        bnd = bound(4 * s * s * d * t * heads, PEAK_BF16, 4 * q.numel() * 2)
        print(f"kernel flash_mha_short {list(shape)} bf16: max_abs_err {err:.6g} "
              f"(tol {tol:.6g}, max|ref| {ref.abs().max().item():.6g}); broken: last 64 keys "
              f"dropped {drop:.6g}; {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa) "
              f"{library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}",
              flush=True)
        if not err <= tol:
            fail(f"flash_mha_short {list(shape)}: error {err} > {tol}")
        if not drop > tol:
            fail(f"flash_mha_short {list(shape)}: tolerance {tol} does not catch dropped keys "
                 f"({drop})")
        return dict(shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, **bnd)

    # Kernel A at the towers' shapes: a chunk of 128 frames x 16 heads of
    # SigLIP (729 x 72, the record's own numbers) and of CLIP ViT-L/14-336
    # (576 patches and the CLS token, x 64), and the 8 CLIP frames of the
    # mlp2x_gelu checkpoint cell.
    siglip = check_short((128, 16, 729, 72))
    print(f"kernel flash_mha_short: first version {FIRST_VERSION_MS['flash_mha_short']} ms at "
          f"{siglip['shape']} (PERF.md, not this run)", flush=True)
    clip, clip8 = check_short((128, 16, 577, 64)), check_short((8, 16, 577, 64))
    records["flash_mha_short"] = dict(
        name="flash_mha_short", route="cuda",
        source="videoitg_tpu_torch/csrc/flash_attention_short.cu",
        replaces="videoitg_tpu/ops/flash_attention_short.py:81",
        **{k: v for k, v in siglip.items() if k != "shape"},
        clip=clip, clip_8_frames=clip8)
    records["flash_mha_short"]["max_abs_err"] = max(r["max_abs_err"] for r in (siglip, clip, clip8))

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

    def without_bias(lin):
        return QuantLinear(w_qt=lin.w_qt, scale=lin.scale, b=None, act_q=True)

    def tower(tag, rows, h, inter, eps, acts) -> dict:
        """G, H (each activation of `acts`) and I over one tower chunk of
        `rows` tokens at width `h`, MLP `inter`, LN eps `eps`, each against
        its plain version and its broken uses; returns name -> record."""
        out_records = {}
        sub = 8192  # rows on which the broken uses are compared
        ln = Norm(h, bias=True, device=dev, dtype=torch.bfloat16)
        ln.scale.data = (1.0 + randn(h, std=0.1)).to(torch.bfloat16)
        ln.bias.data = randn(h, std=0.3).to(torch.bfloat16)
        ln_no_bias = Norm(h, bias=True, device=dev, dtype=torch.bfloat16)
        ln_no_bias.scale.data = ln.scale.data
        x = (randn(rows, h) * (1.0 + randn(1, h).abs()) + randn(1, h, std=0.5)).to(torch.bfloat16)

        # G. A zero row: LN of it is the LN bias, so without one it quantises
        # to zeros with scale 1 and each output row is its linear's bias.
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
        plain_ms = cuda_ms(lambda: fe.fused_ln_qkv_int8_reference(x, ln, q_lin, k_lin, v_lin,
                                                                  eps), 2)
        yq, ys = fe.ln_row_quant(x, ln, eps)
        stage_ms = [cuda_ms(lambda: fe.ln_row_quant(x, ln, eps), 5),
                    cuda_ms(lambda: fe.qkv_project(yq, ys, q_lin, k_lin, v_lin), 5)]
        w_qkv = fe._packed_qkv(q_lin, k_lin, v_lin, dev)[0]
        int_mm_ms = cuda_ms(lambda: torch._int_mm(yq, w_qkv.t()), 5)
        del yq, ys, w_qkv
        n_out = 3 * h
        bnd = bound(2 * rows * h * n_out, PEAK_INT8,
                    rows * h * 2 + n_out * h + rows * n_out * 2 + 2 * n_out * 4 + 2 * h * 4)
        print(f"kernel fused_ln_qkv_int8{tag} [{rows}, {h}] -> 3 x [{rows}, {h}]: max_abs_err "
              f"{err:.6g} mean {mean:.3g} (tol {tol:.6g}); ragged 1000 rows {err_r:.6g}; the "
              f"same, no LN bias, row 7 zero {err_z:.6g}, zero row = bias {zero_ok}; broken: LN "
              f"bias ignored {broken_lnb:.6g}, bias dropped {broken_b:.6g}, k held to the plain "
              f"q {broken_split:.6g}; {ms:.4f} ms ({2 * rows * h * n_out / ms / 1e9:.1f} TOP/s); "
              f"launches: LN + quantise {stage_ms[0]:.4f}, QKV product {stage_ms[1]:.4f} ms "
              f"({2 * rows * h * n_out / stage_ms[1] / 1e9:.1f} TOP/s); plain {plain_ms:.4f} ms, "
              f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; for orientation, the bare "
              f"torch._int_mm product alone {int_mm_ms:.4f} ms", flush=True)
        if not (err <= tol and err_r <= tol and err_z <= tol and zero_ok):
            fail(f"fused_ln_qkv_int8{tag} error {err} / {err_r} / {err_z} > {tol}, or zero row "
                 f"{zero_ok}")
        if not (broken_lnb > tol and broken_b > tol and broken_split > tol):
            fail(f"fused_ln_qkv_int8{tag} tolerance {tol} does not catch a broken use "
                 f"({broken_lnb}, {broken_b}, {broken_split})")
        out_records["fused_ln_qkv_int8"] = dict(
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
        print(f"kernel fused_proj_residual_int8{tag} [{rows}, {h}]: max_abs_err {err:.6g} mean "
              f"{mean:.3g} (tol {tol:.6g}), bit-equal {equal}; ragged 1000 rows, row 7 zero "
              f"{err_r:.6g}, bit-equal {equal_r}, zero row = residual + bias {zero_ok}; broken: "
              f"residual dropped {no_res:.6g}, bias dropped {no_b:.6g}; {ms:.4f} ms "
              f"({2 * rows * h * h / ms / 1e9:.1f} TOP/s); launches: row quantisation "
              f"{stage_ms[0]:.4f}, o_proj {stage_ms[1]:.4f} ms; plain {plain_ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; for orientation, the bare "
              f"torch._int_mm product alone {int_mm_ms:.4f} ms", flush=True)
        if not (equal and equal_r and zero_ok):
            fail(f"fused_proj_residual_int8{tag} not bit-equal to its plain version: error {err} "
                 f"/ {err_r} (tol {tol}), zero row {zero_ok}")
        if not (no_res > tol and no_b > tol):
            fail(f"fused_proj_residual_int8{tag} tolerance {tol} does not catch a broken use "
                 f"({no_res}, {no_b})")
        out_records["fused_proj_residual_int8"] = dict(
            name="fused_proj_residual_int8", route="cuda",
            source="videoitg_tpu_torch/csrc/fused_encoder.cu",
            replaces="videoitg_tpu/ops/fused_encoder.py:121", max_abs_err=max(err, err_r),
            mean_abs_err=mean, ms=ms, plain_ms=plain_ms, stage_ms=stage_ms, int_mm_ms=int_mm_ms,
            library_ms=None, **bnd)
        del attn, ref, out, out_r, ref_r

        # H, each activation. The last 16 intermediate channels get a large
        # fc1 bias, so that a kernel which dropped fc2's last 16 k channels
        # (at 4304, the ragged last k tile) would stand out.
        fc1, fc2 = int8_linear(h, inter, bias_std=0.1), int8_linear(inter, h, bias_std=0.5)
        fc1.b.data[-16:] += 4.0
        fc2_cut = QuantLinear(w_qt=fc2.w_qt.clone(), scale=fc2.scale, b=fc2.b, act_q=True)
        fc2_cut.w_qt[:, -16:] = 0
        asked, done = 4 * rows * h * inter, 6 * rows * h * inter  # fc1 runs twice
        worst, worst_mean, times = 0.0, 0.0, {}
        for act in acts:
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
            err_r, _ = err_stats(fe.fused_ln_mlp_int8(x[:1000], ln, fc1, fc2, eps, act),
                                 ref[:1000])
            ms = cuda_ms(lambda: fe.fused_ln_mlp_int8(x, ln, fc1, fc2, eps, act), 5)
            plain_ms = cuda_ms(lambda: fe.fused_ln_mlp_int8_reference(x, ln, fc1, fc2, eps, act),
                               2)
            yq, ys = fe.ln_row_quant(x, ln, eps)
            amax = fe.mlp_fc1_amax(yq, ys, fc1, act)
            gq = fe.mlp_fc1_quant(yq, ys, fc1, amax, act)
            stage_ms = [cuda_ms(lambda: fe.ln_row_quant(x, ln, eps), 5),
                        cuda_ms(lambda: fe.mlp_fc1_amax(yq, ys, fc1, act), 5),
                        cuda_ms(lambda: fe.mlp_fc1_quant(yq, ys, fc1, amax, act), 5),
                        cuda_ms(lambda: fe.mlp_fc2_residual(x, gq, amax, fc2), 5)]
            if not times:
                # for orientation, the bare torch._int_mm of fc1 and of fc2 (the
                # same for every activation): [rows, h] x [h, inter], then
                # [rows, inter] x [inter, h]
                int_mm_ms = [cuda_ms(lambda: torch._int_mm(yq, fc1.w_qt.t()), 5),
                             cuda_ms(lambda: torch._int_mm(gq, fc2.w_qt.t()), 5)]
                print(f"kernel fused_ln_mlp_int8{tag}: for orientation, the bare torch._int_mm "
                      f"products alone: fc1 {int_mm_ms[0]:.4f} ms, fc2 {int_mm_ms[1]:.4f} ms, "
                      f"together {sum(int_mm_ms):.4f} ms", flush=True)
            del yq, ys, amax, gq
            print(f"kernel fused_ln_mlp_int8{tag} {act} [{rows}, {h}] via {inter}: max_abs_err "
                  f"{err:.6g} mean {mean:.3g} (tol {tol:.6g}); ragged 1000 rows {err_r:.6g}; two "
                  f"runs bit-equal {bool(torch.equal(out, again))}; broken: fc2's last 16 k "
                  f"channels dropped {no_tile:.6g}, LN bias ignored {no_lnb:.6g}, residual "
                  f"dropped {no_res:.6g}; {ms:.4f} ms ({asked / ms / 1e9:.1f} TOP/s of the 2 "
                  f"products asked for, {done / ms / 1e9:.1f} of the 3 done); launches: LN + "
                  f"quantise {stage_ms[0]:.4f}, fc1 amax {stage_ms[1]:.4f}, fc1 quantise "
                  f"{stage_ms[2]:.4f}, fc2 {stage_ms[3]:.4f} ms; plain {plain_ms:.4f} ms",
                  flush=True)
            if not (err <= tol and err_r <= tol):
                fail(f"fused_ln_mlp_int8{tag} {act} error {err} / {err_r} > {tol}")
            if not torch.equal(out, again):
                fail(f"fused_ln_mlp_int8{tag} {act}: two runs differ")
            if not (no_tile > tol and no_lnb > tol and no_res > tol):
                fail(f"fused_ln_mlp_int8{tag} {act} tolerance {tol} does not catch a broken use "
                     f"({no_tile}, {no_lnb}, {no_res})")
            worst, worst_mean = max(worst, err, err_r), max(worst_mean, mean)
            times[act] = (ms, plain_ms, stage_ms)
            del ref, out, again

        # H's row amax, broken: from fc1's first n tile only, and, where fc1's
        # last n tile is ragged (4304 = 16 x 256 + 208), with its padded
        # columns counted, as a kernel that read a bias there would. The last
        # 16 channels run hot (+32) so that the tile that holds them sets each
        # row's amax; the padded columns carry a bias of 1024.
        act = acts[0]
        fc1_hot = QuantLinear(w_qt=fc1.w_qt, scale=fc1.scale, b=fc1.b.clone(), act_q=True)
        fc1_hot.b.data[-16:] += 28.0
        xs_ = x[:sub]
        ref = fe.fused_ln_mlp_int8_reference(xs_, ln, fc1_hot, fc2, eps, act)
        tol = int8_tol(ref.float())
        yq, ys = fe.ln_row_quant(xs_, ln, eps)
        good, _ = err_stats(fe.fused_ln_mlp_int8(xs_, ln, fc1_hot, fc2, eps, act), ref)

        def with_amax(amax):
            return fe.mlp_fc2_residual(xs_, fe.mlp_fc1_quant(yq, ys, fc1_hot, amax, act), amax,
                                       fc2)

        tile = fe.FC1_TILE
        first = QuantLinear(w_qt=fc1_hot.w_qt[:tile], scale=fc1_hot.scale[:tile],
                            b=fc1_hot.b[:tile], act_q=True)
        one_tile, _ = err_stats(with_amax(fe.mlp_fc1_amax(yq, ys, first, act)), ref)
        pad = -inter % tile
        counted = None
        if pad:
            padded = QuantLinear(
                w_qt=torch.cat([fc1_hot.w_qt, fc1_hot.w_qt.new_zeros(pad, h)]),
                scale=torch.cat([fc1_hot.scale, fc1_hot.scale.new_ones(pad)]),
                b=torch.cat([fc1_hot.b, fc1_hot.b.new_full((pad,), 1024.0)]), act_q=True)
            counted, _ = err_stats(with_amax(fe.mlp_fc1_amax(yq, ys, padded, act)), ref)
            del padded
        print(f"kernel fused_ln_mlp_int8{tag} {act} [{sub}, {h}], last 16 channels +32: "
              f"max_abs_err {good:.6g} (tol {tol:.6g}); broken: amax from fc1's first n tile "
              f"only {one_tile:.6g}, " + (f"the {pad} padded columns counted {counted:.6g}" if pad
                                         else f"fc1's last n tile is whole at {inter}"),
              flush=True)
        if not good <= tol:
            fail(f"fused_ln_mlp_int8{tag} hot channels error {good} > {tol}")
        if not (one_tile > tol and (counted is None or counted > tol)):
            fail(f"fused_ln_mlp_int8{tag} tolerance {tol} does not catch a broken row amax "
                 f"({one_tile}, {counted})")
        worst = max(worst, good)
        del yq, ys, ref, first
        # fc1 and fc2 once each; x read, out written, both weights read.
        bnd = bound(asked, PEAK_INT8,
                    2 * rows * h * 2 + 2 * h * inter + 2 * (inter + h) * 4 + 2 * h * 4)
        print(f"kernel fused_ln_mlp_int8{tag}: bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']}", flush=True)
        out_records["fused_ln_mlp_int8"] = dict(
            name="fused_ln_mlp_int8", route="cuda",
            source="videoitg_tpu_torch/csrc/fused_encoder.cu",
            replaces="videoitg_tpu/ops/fused_encoder.py:105", max_abs_err=worst,
            mean_abs_err=worst_mean, ms=times[act][0], plain_ms=times[act][1],
            **{f"{a}_ms": times[a][0] for a in acts[1:]}, stage_ms=times[act][2],
            int_mm_ms=int_mm_ms, library_ms=None, **bnd)
        del x, ln, ln_no_bias, fc1, fc2, fc2_cut, fc1_hot, q_lin, k_lin, v_lin, o_lin
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return out_records

    # ---- G, H, I over one tower chunk of 128 frames: SigLIP's 729 patches at
    # H = 1152, MLP 4304, both activations (the records' own numbers); then
    # CLIP ViT-L/14-336's 577 tokens at H = 1024, MLP 4096, LN eps 1e-5,
    # quick_gelu. ----
    siglip = tower("", 128 * 729, 1152, 4304, 1e-6, ("gelu_tanh", "quick_gelu"))
    print("the mma.sync versions (H with gelu_tanh): " + ", ".join(
        f"{name} {FIRST_VERSION_MS[name]} ms" for name in siglip) + " (PERF.md, not this run)",
          flush=True)
    clip = tower(" clip", 128 * 577, 1024, 4096, 1e-5, ("quick_gelu",))
    for name, rec in siglip.items():
        rec["max_abs_err"] = max(rec["max_abs_err"], clip[name]["max_abs_err"])
        rec["clip"] = {k: v for k, v in clip[name].items()
                       if k not in ("name", "route", "source", "replaces", "library_ms")}
        records[name] = rec
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


def host_rss() -> Optional[int]:
    """This process's resident bytes (/proc/self/statm), or None where the
    machine does not give them."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


class HostPeak:
    """The largest resident set the process reaches inside the block, read
    every 2 ms by a thread: the card's machine keeps no high-water mark that
    can be reset (its /proc/self/status has no VmHWM). `before` and `peak`
    are bytes, or None where host_rss gives none."""

    def __enter__(self):
        self.before = self.peak = host_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while self.before is not None and not self._stop.wait(0.002):
            self.peak = max(self.peak, host_rss() or 0)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        if self.before is not None:
            self.peak = max(self.peak, host_rss() or 0)


def checkpoint_cells() -> list:
    """(name, config, frames) of the checkpoint phase: VideoITG-8B's widths
    with 2 LM and 3 tower layers; the same LM under CLIP ViT-L/14-336's tower
    (openai/clip-vit-large-patch14-336's vision config, LLaVA-1.5's tower),
    3 layers, seq_mlp 1024 -> 3584; and that tower with LLaVA-1.5's
    mlp2x_gelu projector, one LM token per patch."""
    import dataclasses

    from videoitg_tpu_torch.config import GroundingConfig, VisionConfig

    shallow = GroundingConfig.videoitg_8b_shallow()
    clip_tower = VisionConfig(hidden_size=1024, intermediate_size=4096, num_layers=3,
                              num_heads=16, image_size=336, patch_size=14, layer_norm_eps=1e-5,
                              select_layer=-2, arch="clip", select_feature="patch")
    clip = dataclasses.replace(shallow, vision=clip_tower, projector=dataclasses.replace(
        shallow.projector, input_dim=1024))
    mlp2x = dataclasses.replace(clip, projector=dataclasses.replace(
        clip.projector, projector_type="mlp2x_gelu"))
    return [("videoitg-8b-shallow", shallow, 512), ("clip", clip, 512),
            ("clip + mlp2x_gelu", mlp2x, 8)]


def run_checkpoints(dev, card: str) -> dict:
    """HF-format checkpoints written and read by the port on the card, in a
    temporary directory, then driven through `SelectionEngine.select`: per
    cell, a bf16 model from SEED is written by `save_hf_checkpoint` (fp32
    safetensors) and read back by `load_grounding_model` in bf16, which must
    be bit-equal to it. videoitg-8b-shallow: one 512-frame select through
    both models gives the same scores and Top-K index. clip: one 512-frame
    select in bf16 (kernel A at S = 577, D = 64), then the act8 tier with the
    int8 kernels on (F, G, H with quick_gelu, I at 1024 / 4096) against the
    same model with them off, within E2E_ATOL. clip + mlp2x_gelu: 8 frames,
    4,608 image tokens, through kernel B. Launch counts are zeroed before
    each select of a loaded model and read after it. Returns the counts
    summed over the phase."""
    import tempfile

    import numpy as np
    import torch

    from videoitg_tpu_torch.checkpoint import load_grounding_model, save_hf_checkpoint
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.models.grounding import init_grounding
    from videoitg_tpu_torch.ops.quant import apply_quantization_tier
    from videoitg_tpu_torch.utils.common import CharTokenizer

    counted = wrappers()
    total = {name: 0 for name in counted}
    rng = np.random.default_rng(SEED + 6)

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    def select(tag, engine, frames, sampled, expect):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.select(frames, sampled, QUESTIONS[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        check_result(res, sampled)
        print(f"checkpoint {tag}: select {len(sampled)} frames {wall:.4f} s, top8 "
              f"{res.topk(8)}; launches {dict((k, v) for k, v in launches.items() if v)} "
              f"[{card}]", flush=True)
        for name, n in expect.items():
            if launches[name] != n:
                fail(f"checkpoint {tag}: {name} launched {launches[name]} times, expected {n}")
        for name, n in launches.items():
            total[name] += n
        return res

    for name, cfg, t in checkpoint_cells():
        tok = CharTokenizer(cfg.lm.vocab_size)
        model = init_grounding(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                               dtype=torch.bfloat16)
        # The host's peak resident set over the write and over the load: a
        # whole-model copy on the host would raise it by about the file's bytes.
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with HostPeak() as host_write:
                path = save_hf_checkpoint(model, cfg, tmp)
            write_s = time.perf_counter() - t0
            nbytes = os.path.getsize(path)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with HostPeak() as host_load:
                loaded, got_cfg = load_grounding_model(tmp, device=dev, dtype=torch.bfloat16)
                torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - before
            if name == "videoitg-8b-shallow":
                compare_cold_starts(dev, card, tmp, cfg)
        want, got = model.state_dict(), loaded.state_dict()
        unequal = sorted(k for k in want if not torch.equal(bits(want[k]), bits(got[k])))
        weights = sum(v.numel() * v.element_size() for v in got.values())
        rises = ", ".join(
            f"{k} +{(h.peak - h.before) / 2**30:.3f} GiB over {h.before / 2**30:.3f}"
            if h.before is not None else f"{k} not measured (no /proc/self/statm)"
            for k, h in (("write", host_write), ("load", host_load)))
        print(f"checkpoint {name}: {nbytes} bytes of fp32 safetensors written in {write_s:.4f} "
              f"s ({nbytes / write_s / 1e9:.3f} GB/s), read into bf16 on the card in "
              f"{load_s:.4f} s ({nbytes / load_s / 1e9:.3f} GB/s of file); device memory peak "
              f"of the load {peak / 2**30:.4f} GiB for {weights / 2**30:.4f} GiB of weights; "
              f"host peak resident set (sampled every 2 ms) {rises}; {len(want)} tensors, "
              f"bit-equal {not unequal} [{card}]", flush=True)
        if got_cfg != cfg or set(got) != set(want) or unequal:
            fail(f"checkpoint {name}: the loaded model differs from the written one "
                 f"({unequal[:5]})")
        frames = frames_u8(rng, t)
        sampled = [2 * i for i in range(t)]
        chunks = max(1, t // 128)
        expect = {"flash_mha_short": cfg.vision.num_effective_layers * chunks,
                  "flash_mha": cfg.lm.num_layers}
        engine = SelectionEngine(loaded, cfg, tok, device=dev, dtype=torch.bfloat16)
        got_res = select(f"{name}, loaded", engine, frames, sampled, expect)
        if name == "videoitg-8b-shallow":
            written = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16)
            want_res = select(f"{name}, as written", written, frames, sampled, expect)
            same = (np.array_equal(got_res.raw_scores, want_res.raw_scores)
                    and got_res.index == want_res.index)
            print(f"checkpoint {name}: loaded vs written model, scores and Top-K index equal "
                  f"{same}", flush=True)
            if not same:
                fail(f"checkpoint {name}: the loaded model selects otherwise")
            del written
        if name == "clip":
            apply_quantization_tier(loaded, "act8")
            on = SelectionEngine(loaded, cfg, tok, device=dev, dtype=torch.bfloat16,
                                 qgemm=True, fused=True)
            layers, lm_layers = cfg.vision.num_effective_layers * chunks, cfg.lm.num_layers
            on_res = select(f"{name}, act8, int8 kernels on", on, frames, sampled, dict(
                expect, act8_gemm=7 * lm_layers, fused_ln_qkv_int8=layers,
                fused_ln_mlp_int8=layers, fused_proj_residual_int8=layers))
            off = SelectionEngine(loaded, cfg, tok, device=dev, dtype=torch.bfloat16,
                                  qgemm=False, fused=False)
            off_res = select(f"{name}, act8, int8 kernels off", off, frames, sampled, dict(
                expect, act8_gemm=0, fused_ln_qkv_int8=0, fused_ln_mlp_int8=0,
                fused_proj_residual_int8=0))
            diff = float(np.abs(on_res.raw_scores - off_res.raw_scores).max())
            print(f"checkpoint {name}: act8, int8 kernels on vs off: max |score diff| "
                  f"{diff:.6g} (atol {E2E_ATOL})", flush=True)
            if not diff <= E2E_ATOL:
                fail(f"checkpoint {name}: act8 kernels on vs off {diff} > {E2E_ATOL}")
            del on, off
        del model, loaded, engine, want, got
        torch.cuda.empty_cache()
    return total


def explain_mismatch(tag: str, params_file: str, want: dict, got: dict, keys) -> None:
    """For each state-dict key in `keys` (a model's, `want`, against one
    loaded from `params_file`, `got`): how many bytes differ on the card and
    on the host, and whether the file holds the one or the other, so that a
    failed bit-equality says whether the writer, the reader or the
    comparison went wrong."""
    import torch

    from videoitg_tpu_torch.checkpoint import _LAYER_KEY, _safetensors_index

    refs, _ = _safetensors_index(params_file)
    for key in keys:
        path = key[:-len("w_qt")] + "w_q" if key.endswith(".w_qt") else key
        m = _LAYER_KEY.match(path)
        ref = refs[f"{m.group(1)}.{m.group(3)}"].layer(int(m.group(2))) if m else refs[path]
        on_file = ref.read()
        a, b = want[key].cpu(), got[key].cpu()
        if key.endswith(".w_qt"):
            on_file = on_file.t()
        card_bytes = [t.reshape(-1).view(torch.uint8) for t in (want[key], got[key])]
        flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in (a, b, on_file)]
        print(f"{tag}: {key} {tuple(a.shape)} {a.dtype}: bytes differing on the card "
              f"{int((card_bytes[0] != card_bytes[1]).sum())}, on the host "
              f"{int((flat[0] != flat[1]).sum())}; the file equals the saved model "
              f"{torch.equal(flat[0], flat[2])}, the loaded one {torch.equal(flat[1], flat[2])}",
              flush=True)


def compare_cold_starts(dev, card: str, hf_dir: str, cfg) -> None:
    """The act8 cold start of one model two ways: its fp32 HF directory read
    into bf16 (`load_grounding_model`) and quantised at load
    (`apply_quantization_tier`), against its serving checkpoint
    (`load_serving_checkpoint`). Both files were just written, so both are
    read from the page cache. Two rounds, alternated; the two models must be
    bit-equal."""
    import tempfile

    import torch

    from videoitg_tpu_torch.checkpoint import (SERVING_PARAMS_NAME, load_grounding_model,
                                               load_serving_checkpoint, save_serving_checkpoint)
    from videoitg_tpu_torch.ops.quant import apply_quantization_tier

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    hf_bytes = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in os.listdir(hf_dir))
    with tempfile.TemporaryDirectory() as srv:
        for round_ in (1, 2):
            (hf, _), read_s = timed(lambda: load_grounding_model(hf_dir, device=dev,
                                                                 dtype=torch.bfloat16))
            _, quant_s = timed(lambda: apply_quantization_tier(hf, "act8"))
            if round_ == 1:
                save_serving_checkpoint(hf, cfg, srv, quantize="act8")
            nbytes = os.path.getsize(os.path.join(srv, SERVING_PARAMS_NAME))
            (served, _, _), serve_s = timed(lambda: load_serving_checkpoint(srv, device=dev))
            a, b = hf.state_dict(), served.state_dict()
            same = a.keys() == b.keys() and all(
                torch.equal(a[k].reshape(-1).view(torch.uint8), b[k].reshape(-1).view(torch.uint8))
                for k in a)
            print(f"cold start videoitg-8b-shallow act8, round {round_}: HF fp32 files "
                  f"({hf_bytes} bytes) read {read_s:.4f} s + quantise {quant_s:.4f} s = "
                  f"{read_s + quant_s:.4f} s; serving checkpoint ({nbytes} bytes) read "
                  f"{serve_s:.4f} s ({(read_s + quant_s) / serve_s:.2f}x faster); models "
                  f"bit-equal {same} [{card}]", flush=True)
            if not same:
                bad = [k for k in a if not torch.equal(a[k].reshape(-1).view(torch.uint8),
                                                       b[k].reshape(-1).view(torch.uint8))]
                explain_mismatch("cold start", os.path.join(srv, SERVING_PARAMS_NAME), a, b,
                                 bad[:3])
                fail(f"cold start: the serving checkpoint's model differs from the HF "
                     f"directory's quantised at load ({len(bad)} tensors: {bad[:5]})")
            del hf, served, a, b
            torch.cuda.empty_cache()


def run_serving_checkpoints(dev, card: str) -> dict:
    """Serving checkpoints at VideoITG-8B, full width and depth, in the int8,
    int4 and act8 tiers: a bf16 model from SEED quantised in place on the
    card (timed), written by `save_serving_checkpoint` into a temporary
    directory (bytes, seconds, GB/s, the host's peak rise) and read back onto
    the card by `load_serving_checkpoint` (seconds, device memory peak, host
    peak rise), bit-equal to the saved model, act_q flags included. One
    512-frame select through the saved and through the loaded model (act8
    with the int8 kernels on) gives the same raw scores and Top-K, bit for
    bit; launches are zeroed before each select and read after it: A 104, B
    28, and under act8 F 196, G, H, I 104 each, else 0. Returns the counts
    summed over the phase."""
    import tempfile

    import numpy as np
    import torch

    from videoitg_tpu_torch.checkpoint import (SERVING_PARAMS_NAME, load_serving_checkpoint,
                                               save_serving_checkpoint)
    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.models.grounding import init_grounding
    from videoitg_tpu_torch.ops.quant import QuantLinear, apply_quantization_tier
    from videoitg_tpu_torch.utils.common import CharTokenizer

    counted = wrappers()
    total = {name: 0 for name in counted}
    cfg = preset("videoitg-8b")
    tok = CharTokenizer(cfg.lm.vocab_size)
    frames, sampled = frames_u8(np.random.default_rng(SEED + 7), 512), [2 * i for i in range(512)]
    tower, lm = cfg.vision.num_effective_layers * 4, cfg.lm.num_layers  # 4 chunks of 128 frames

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    def rise(h):
        if h.before is None:
            return "not measured (no /proc/self/statm)"
        return f"+{(h.peak - h.before) / 2**30:.3f} GiB over {h.before / 2**30:.3f}"

    def select(tag, model, act8):
        engine = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16, qgemm=act8,
                                 fused=act8)
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.select(frames, sampled, QUESTIONS[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        check_result(res, sampled)
        want = {"flash_mha_short": tower, "flash_mha": lm, "act8_gemm": 7 * lm if act8 else 0,
                **{k: tower if act8 else 0 for k in ("fused_ln_qkv_int8", "fused_ln_mlp_int8",
                                                     "fused_proj_residual_int8")}}
        print(f"serving checkpoint {tag}: select 512 frames {wall:.4f} s, top8 {res.topk(8)}; "
              f"launches {dict((k, v) for k, v in launches.items() if v)} [{card}]", flush=True)
        for name, n in want.items():
            if launches[name] != n:
                fail(f"serving checkpoint {tag}: {name} launched {launches[name]} times, "
                     f"expected {n}")
        for name, n in launches.items():
            total[name] += n
        return res

    for tier in ("int8", "int4", "act8"):
        model = init_grounding(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                               dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply_quantization_tier(model, tier)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            with HostPeak() as host_write:
                save_serving_checkpoint(model, cfg, tmp, quantize=tier)
            write_s = time.perf_counter() - t0
            nbytes = os.path.getsize(os.path.join(tmp, SERVING_PARAMS_NAME))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with HostPeak() as host_load:
                loaded, got_cfg, got_tier = load_serving_checkpoint(tmp, device=dev)
                torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - before
            want, got = model.state_dict(), loaded.state_dict()
            unequal = sorted(k for k in want if k not in got or not torch.equal(bits(want[k]),
                                                                                 bits(got[k])))
            if unequal and set(got) == set(want):
                explain_mismatch(f"serving checkpoint {tier}", os.path.join(
                    tmp, SERVING_PARAMS_NAME), want, got, unequal[:3])
        flags = [[(n, m.bits, m.act_q) for n, m in mod.named_modules()
                  if isinstance(m, QuantLinear)] for mod in (model, loaded)]
        weights = sum(v.numel() * v.element_size() for v in got.values())
        print(f"serving checkpoint videoitg-8b {tier}: quantised on the card in {quant_s:.4f} s; "
              f"{nbytes} bytes written in {write_s:.4f} s ({nbytes / write_s / 1e9:.3f} GB/s), "
              f"host peak {rise(host_write)}; cold start onto the card {load_s:.4f} s "
              f"({nbytes / load_s / 1e9:.3f} GB/s of file), device memory peak of the load "
              f"{peak / 2**30:.4f} GiB for {weights / 2**30:.4f} GiB of weights, host peak "
              f"{rise(host_load)}; {len(want)} tensors, {len(flags[0])} quantised linears, "
              f"bit-equal {not unequal and flags[0] == flags[1]} [{card}]", flush=True)
        if (got_cfg != cfg or got_tier != tier or set(got) != set(want) or unequal
                or flags[0] != flags[1]):
            fail(f"serving checkpoint {tier}: the loaded model differs from the saved one "
                 f"({len(unequal)} tensors: {unequal[:5]})")
        a = select(f"{tier}, as saved", model, tier == "act8")
        b = select(f"{tier}, loaded", loaded, tier == "act8")
        same = np.array_equal(a.raw_scores, b.raw_scores) and a.index == b.index
        print(f"serving checkpoint {tier}: loaded vs saved model, raw scores and Top-K index "
              f"bit-equal {same} [{card}]", flush=True)
        if not same:
            fail(f"serving checkpoint {tier}: the loaded model selects otherwise")
        del model, loaded, want, got, a, b
        torch.cuda.empty_cache()
    return total


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


def train_steps(tag, state, step_fn, batch, n_steps, expect, card, mesh=None, record=None):
    """`n_steps` calls of run_step on `batch` (on `mesh` when given), each with
    the launch counts set to 0 just before and read just after; `expect`
    (kernel -> launches per step) must hold at every step and the loss must
    be finite. Appends each step's (loss, grad_norm) to `record` when given.
    Returns the counts summed over the steps."""
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
        state, metrics = run_step(step_fn, state, batch, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        m = {k: float(v) for k, v in metrics.items()}
        if record is not None:
            record.append((m["loss"], m["grad_norm"]))
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


EVAL_FRAMES = 512  # frames a video at target_fps=1, the paper's eval setting
EVAL_VIDEOS = (("a", QUESTIONS), ("b", ["What is on the table?"]),
               ("c", ["Who opens the door?"]), ("d", ["Where does the boat go?"]))


def eval_inputs():
    """(videos, sampled, docs) of the eval phases: 4 videos of EVAL_FRAMES
    seeded 360x640 frames, the frame ids 1 fps takes from a 30 fps clip of
    that length, and 6 Video-MME docs (3 questions on video a, one on each of
    b, c, d)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 90)
    sampled = [30 * i for i in range(EVAL_FRAMES)]  # 1 fps of a 30 fps clip
    videos = {v: frames_u8(rng, EVAL_FRAMES) for v, _ in EVAL_VIDEOS}
    docs = []
    for v, questions in EVAL_VIDEOS:
        for q in questions:
            n = len(docs)
            docs.append({"videoID": v, "question_id": f"{v}{n}", "question": q,
                         "options": ["A. one", "B. two", "C. three", "D. four"],
                         "answer": "ABCD"[n % 4], "duration": ["short", "medium", "long"][n % 3],
                         "domain": "d", "sub_category": "s", "task_type": "t"})
    return videos, sampled, docs


def seeded_reader(videos, sampled, reads):
    """A stand-in for `data/video.read_video_frames` that hands out the seeded
    frames of `videos` at the eval sampling, and records each video it reads
    in `reads`."""
    def synthetic_reader(path, num_frames=512, target_fps=1.0, sampling="eval", multiple=1,
                         pix_fmt="rgb"):
        key = os.path.splitext(os.path.basename(path))[0]
        if key not in videos or pix_fmt != "rgb" or (num_frames, target_fps, sampling) != (
                EVAL_FRAMES, 1.0, "eval"):
            raise FileNotFoundError(f"{path} ({num_frames}, {target_fps}, {sampling}, {pix_fmt})")
        reads.append(key)
        return videos[key], list(sampled)

    return synthetic_reader


def write_eval_root(tmp: str, docs) -> tuple:
    """(data root, docs json) under `tmp`: the empty video files videomme's
    doc_to_visual wants to find, and the docs."""
    root = os.path.join(tmp, "videomme")
    os.makedirs(os.path.join(root, "data"))
    for v, _ in EVAL_VIDEOS:
        open(os.path.join(root, "data", f"{v}.mp4"), "wb").close()
    docs_json = os.path.join(tmp, "docs.json")
    with open(docs_json, "w") as f:
        json.dump(docs, f)
    return root, docs_json


def run_eval(dev, card: str) -> dict:
    """Phase 9: eval stage A. VideoITG-8B bf16 (random weights, seed 0 as the
    adapter draws them) through `cli/evaluate.main` in this process: task
    videomme, a --docs_json of 6 docs over 4 videos (a with 3 questions: the
    `select_many` path; b, c, d with one each: the `score_frames` group
    path), 512 frames at target_fps=1, with the frame reader swapped for one
    that hands out seeded 360x640 frames. Run at batch_size 1, then 2 (b and
    c score as one batch). Each batch_size=1 row equals what the adapter's
    engine returns called directly on the same frames and prompts; the
    batch_size=2 raw scores are within E2E_ATOL of the batch_size=1 ones; A
    and B launch as often as the path implies, and nothing else launches.
    Returns the launches of both runs."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from videoitg_tpu_torch.cli import evaluate as evaluate_cli
    from videoitg_tpu_torch.data import video as video_mod
    from videoitg_tpu_torch.eval import harness
    from videoitg_tpu_torch.eval.adapters.videoitg import VideoITGAdapter

    t_frames = EVAL_FRAMES
    videos, sampled, docs = eval_inputs()
    reads = []
    synthetic_reader = seeded_reader(videos, sampled, reads)

    built, raw, walls, peaks = [], {}, [], []
    recording = [False]
    real_init, real_evaluate = VideoITGAdapter.__init__, harness.evaluate_task

    def spy_init(self, *a, **kw):
        """Keeps the adapter the CLI builds, and records the raw scores its
        engine returns (the rows hold them rounded to 2 decimals)."""
        real_init(self, *a, **kw)
        built.append(self)
        eng = self.engine
        score_frames, select_many = eng.score_frames, eng.select_many

        def spy_score_frames(vids, instructions):
            out = score_frames(vids, instructions)
            if recording[0]:
                raw.update(zip(instructions, out))
            return out

        def spy_select_many(*args, **kwargs):
            out = select_many(*args, **kwargs)
            if recording[0]:
                raw.update((r.contexts, r.raw_scores) for r in out)
            return out

        eng.score_frames, eng.select_many = spy_score_frames, spy_select_many

    def timed_evaluate(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report = real_evaluate(*a, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        return report

    n_layers, tower_layers = 28, 26
    n_videos = len(EVAL_VIDEOS)
    counted = wrappers()
    total = {name: 0 for name in counted}
    by_run = {}
    real_reader = video_mod.read_video_frames
    video_mod.read_video_frames = synthetic_reader
    VideoITGAdapter.__init__, harness.evaluate_task = spy_init, timed_evaluate
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root, docs_json = write_eval_root(tmp, docs)
            for bs in (1, 2):
                out = os.path.join(tmp, f"out_bs{bs}")
                argv = ["--model", "videoitg", "--model_args",
                        f"random_init=True,preset=videoitg-8b,num_frames={t_frames},"
                        f"target_fps=1,batch_size={bs}",
                        "--tasks", "videomme", "--data_root", root, "--docs_json", docs_json,
                        "--output_path", out, "--seed", str(SEED)]
                raw.clear()
                reads.clear()
                recording[0] = True
                for fn in counted.values():
                    fn.launches = 0
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                rc = evaluate_cli.main(argv)
                torch.cuda.synchronize()
                main_wall = time.perf_counter() - t0
                recording[0] = False
                launches = {name: fn.launches for name, fn in counted.items()}
                if rc != 0:
                    fail(f"eval batch_size={bs}: cli/evaluate.main returned {rc}")
                for name, n in launches.items():
                    total[name] += n
                # A: 4 chunks of 128 frames x 26 layers per video, batched or not;
                # B: 28 per LM pass: a's 3 questions, then b, c, d (b and c as one
                # pass at batch_size 2)
                want = {"flash_mha_short": n_videos * 4 * tower_layers,
                        "flash_mha": n_layers * (3 + (3 if bs == 1 else 2))}
                other = {k: v for k, v in launches.items() if k not in want and v}
                if any(launches[k] != n for k, n in want.items()) or other:
                    fail(f"eval batch_size={bs}: launches {launches}, expected {want} and no "
                         f"other kernel")
                if sorted(reads) != sorted(videos):
                    fail(f"eval batch_size={bs}: the reader handed out {reads}")
                task_dir = os.path.join(out, "videomme")
                with open(os.path.join(task_dir, "results.jsonl")) as f:
                    rows = [json.loads(line) for line in f]
                with open(os.path.join(task_dir, "report.videomme.json")) as f:
                    report = json.load(f)
                if [r["doc_id"] for r in rows] != list(range(len(docs))) or \
                        report["num_docs"] != len(docs):
                    fail(f"eval batch_size={bs}: rows {[r['doc_id'] for r in rows]}, "
                         f"report of {report['num_docs']} docs")
                for r in rows:
                    if sorted(r["index"]) != sampled or r["logits"] != sorted(r["logits"])[::-1] \
                            or not all(0.0 <= x <= 1.0 for x in r["logits"]):
                        fail(f"eval batch_size={bs}: doc {r['doc_id']} row is not a ranking "
                             "of the sampled frames in [0, 1]")
                for ctx, sc in raw.items():
                    if sc.shape != (t_frames,) or not np.all(np.isfinite(sc)):
                        fail(f"eval batch_size={bs}: scores {sc.shape}, finite "
                             f"{np.all(np.isfinite(sc))}")
                if len(raw) != len(docs):
                    fail(f"eval batch_size={bs}: {len(raw)} raw score vectors for {len(docs)} docs")
                wall, peak = walls[-1], peaks[-1]
                weights = sum(t.numel() * t.element_size()
                              for t in built[-1].engine.model.state_dict().values())
                meta = report["metadata"]
                print(f"eval [bf16, videomme, batch_size={bs}]: {len(docs)} docs over {n_videos} "
                      f"videos of {t_frames} frames in {wall:.4f} s (evaluate_task, reader "
                      f"swapped; cli main {main_wall:.2f} s with the weights' init): "
                      f"{len(docs) / wall:.4f} docs/s, {wall / n_videos:.4f} s per video; peak "
                      f"device memory over evaluate_task {peak / 2**30:.3f} GiB (weights "
                      f"{weights / 2**30:.3f} GiB; {before / 2**30:.3f} GiB held before the run); "
                      f"videomme_perception_score "
                      f"{report['metrics']['videomme_perception_score']}; backend "
                      f"{meta['backend']}, torch {meta['torch_version']}; launches A "
                      f"{launches['flash_mha_short']}, B {launches['flash_mha']} [{card}]",
                      flush=True)
                by_run[bs] = dict(raw)
                if bs == 1:
                    # the same engine, called directly on the same frames and prompts
                    eng = built[-1].engine
                    per_video = {}
                    for r in rows:
                        per_video.setdefault(os.path.splitext(
                            os.path.basename(r["video_path"]))[0], []).append(r)
                    direct = {}
                    for res in eng.select_many(videos["a"], sampled,
                                               [r["contexts"] for r in per_video["a"]]):
                        direct[res.contexts] = (res.index, res.logits)
                    for v in "bcd":
                        (r,) = per_video[v]
                        sc = eng.score_frames([videos[v]], [r["contexts"]])[0]
                        direct[r["contexts"]] = eng.rank_frames(sc, sampled)
                    unequal = [r["doc_id"] for r in rows
                               if (r["index"], r["logits"]) != tuple(direct[r["contexts"]])]
                    print(f"eval batch_size=1 rows against the engine called directly "
                          f"(select_many for a, score_frames + rank_frames for b, c, d): "
                          f"{len(rows) - len(unequal)} of {len(rows)} equal", flush=True)
                    if unequal:
                        fail(f"eval batch_size=1 rows {unequal} differ from the engine's")
                    del eng
                built.clear()
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        video_mod.read_video_frames = real_reader
        VideoITGAdapter.__init__, harness.evaluate_task = real_init, real_evaluate
    diff = max(float(np.abs(by_run[2][ctx] - by_run[1][ctx]).max()) for ctx in by_run[1])
    print(f"eval batch_size=2 against batch_size=1 raw scores: max |diff| {diff:.6g} "
          f"(atol {E2E_ATOL})", flush=True)
    if not diff <= E2E_ATOL:
        fail(f"eval batch_size=2 scores differ from batch_size=1 by {diff} > {E2E_ATOL}")
    return {name: total[name] for name in ("flash_mha_short", "flash_mha")}


STAGE_B_FRAMES = 32      # num_frame of stage B: the first 32 of stage A's ranking
STAGE_B_NEW_TOKENS = 16
STAGE_B_ARGS = ("num_frame={n},random_init=True,preset=videoitg-8b,"
                "max_new_tokens={t},dtype=bfloat16")


def run_stage_b(dev, card: str) -> dict:
    """Phase 10: eval stage B on the port alone. Stage A (phase 9's run at
    batch_size 1) writes results.jsonl through `cli/evaluate.main`, and its
    model is freed. Then `cli/evaluate.main --model videoitg-vlm` with
    `frame_indices_jsonl=` that file, num_frame=32, VideoITG-8B's causal,
    tied variant in bf16 with random weights, 16 new tokens: (1) videomme on
    the same 6 docs (generate_until); (2) a loglikelihood task of two
    candidates on the first doc of each video; (3) (1) again with
    quantize=act8, VIDEOITG_QGEMM=1 and VIDEOITG_FUSED=1. The libav reader of
    `FrameSelectionConsumer.frames_for_doc` is swapped for one that hands out
    the seeded frames; the ids asked for must be stage A's first 32,
    ascending. Every response and loglikelihood must equal the adapter's
    model called directly (`vlm_generate` / `vlm_loglikelihood`) on the same
    frames and prompt, and the launches must be what the code implies: A 26
    and B 28 a request; under act8 also G, H, I 26 a request and F once for
    each kernel-served LM linear of the prefill and of every decode step.
    Then F against its plain version at M = 1 and at the prefill's M, and
    its time for one LM layer at M = 1. Returns the launches of all four
    runs and F's decode record."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from videoitg_tpu_torch.cli import evaluate as evaluate_cli
    from videoitg_tpu_torch.data import video as video_mod
    from videoitg_tpu_torch.eval import api, harness
    from videoitg_tpu_torch.eval.adapters.native_vlm import NativeVLMAdapter
    from videoitg_tpu_torch.models import vlm
    from videoitg_tpu_torch.ops import quant_gemm as qg
    from videoitg_tpu_torch.ops.fused_encoder import can_fuse_encoder_layer
    from videoitg_tpu_torch.ops.quant import QWEN2_LINEAR_KEYS, Act8Switches

    videos, sampled, docs = eval_inputs()
    n_layers, tower_layers = 28, 26
    counted = wrappers()
    total = {name: 0 for name in counted}
    asked = []  # (video, frame ids) stage B's frame source handed out

    class SeededVideoReader:
        """Stands in for the libav reader of `frames_for_doc`: a 30 fps clip
        of EVAL_FRAMES seconds whose frame 30 i is the seeded frame i (the ids
        stage A sampled)."""

        fps = 30.0

        def __init__(self, path, *a, **kw):
            self.key = os.path.splitext(os.path.basename(path))[0]
            if self.key not in videos:
                raise FileNotFoundError(path)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def __len__(self):
            return 30 * EVAL_FRAMES

        def get_batch(self, ids):
            ids = [int(i) for i in ids]
            if any(i % 30 for i in ids):
                fail(f"stage B asked {self.key} for frames stage A never sampled: {ids}")
            asked.append((self.key, ids))
            return videos[self.key][[i // 30 for i in ids]]

    built, walls = [], []
    timers = {"pack": [], "prefill": [], "decode": []}
    real = {"init": NativeVLMAdapter.__init__, "evaluate_task": harness.evaluate_task,
            "_pack_embeds": vlm._pack_embeds, "vlm_prefill": vlm.vlm_prefill,
            "vlm_decode_step": vlm.vlm_decode_step, "VideoReader": video_mod.VideoReader}

    def spy_init(self, *a, **kw):
        real["init"](self, *a, **kw)
        built.append(self)

    def timed(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            (walls if key == "evaluate_task" else timers[key]).append(time.perf_counter() - t0)
            return out
        return wrapper

    def stage_b(tag, model_args, task, docs_json, out, n_requests, env=()):
        """One `cli/evaluate.main` run of stage B with every count set to 0
        just before it; returns (adapter, launches, samples, peak bytes)."""
        for fn in counted.values():
            fn.launches = 0
        for v in timers.values():
            v.clear()
        asked.clear()
        saved = {k: os.environ.get(k) for k, _ in env}
        os.environ.update(dict(env))
        NativeVLMAdapter.__init__ = spy_init
        harness.evaluate_task = timed("evaluate_task", real["evaluate_task"])
        vlm._pack_embeds = timed("pack", real["_pack_embeds"])
        vlm.vlm_prefill = timed("prefill", real["vlm_prefill"])
        vlm.vlm_decode_step = timed("decode", real["vlm_decode_step"])
        video_mod.VideoReader = SeededVideoReader
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            rc = evaluate_cli.main(["--model", "videoitg-vlm", "--model_args", model_args,
                                    "--tasks", task, "--data_root", root, "--docs_json",
                                    docs_json, "--output_path", out, "--log_samples",
                                    "--seed", str(SEED)])
            torch.cuda.synchronize()
        finally:
            NativeVLMAdapter.__init__ = real["init"]
            harness.evaluate_task = real["evaluate_task"]
            vlm._pack_embeds, vlm.vlm_prefill = real["_pack_embeds"], real["vlm_prefill"]
            vlm.vlm_decode_step = real["vlm_decode_step"]
            video_mod.VideoReader = real["VideoReader"]
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        main_wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            fail(f"stage B [{tag}]: cli/evaluate.main returned {rc}")
        for name, n in launches.items():
            total[name] += n
        with open(os.path.join(out, task, f"samples.rank0.{task}.jsonl")) as f:
            samples = [json.loads(line) for line in f]
        if len(samples) != n_requests or len(built) != 1:
            fail(f"stage B [{tag}]: {len(samples)} samples, {len(built)} adapters built")
        wall = walls[-1]
        decode = timers["decode"]
        print(f"stage B [{tag}]: {n_requests} requests in {wall:.4f} s (evaluate_task; cli main "
              f"{main_wall:.2f} s with the weights' init): {n_requests / wall:.4f} docs/s; tower "
              f"+ packing {', '.join(f'{x:.4f}' for x in timers['pack'])} s, LM prefill "
              f"{', '.join(f'{x:.4f}' for x in timers['prefill']) or 'none (teacher-forced)'} s; "
              f"{len(decode)} decode steps, "
              f"{f'{1e3 * sum(decode) / len(decode):.3f}' if decode else 'no'} ms per decoded "
              f"token; peak device "
              f"memory over stage B {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before "
              f"it); launches { {k: v for k, v in launches.items() if v} } [{card}]", flush=True)
        return built.pop(), launches, samples, peak

    def frames_of(key, ids):
        return videos[key][[i // 30 for i in ids]]

    def expect_asked(tag, requests):
        """The frame ids of each request: stage A's first 32, ascending."""
        want = [(v, sorted(rows[doc_id]["index"][:STAGE_B_FRAMES])) for doc_id, v in requests]
        if asked != want:
            fail(f"stage B [{tag}]: frames asked {[(v, ids[:4]) for v, ids in asked]}..., "
                 f"expected stage A's first {STAGE_B_FRAMES} ascending")
        if any(len(ids) != STAGE_B_FRAMES or len(set(ids)) != STAGE_B_FRAMES for _, ids in asked):
            fail(f"stage B [{tag}]: not {STAGE_B_FRAMES} distinct frames a request")

    def expect_launches_b(tag, launches, want):
        other = {k: v for k, v in launches.items() if k not in want and v}
        if any(launches[k] != n for k, n in want.items()) or other:
            fail(f"stage B [{tag}]: launches { {k: v for k, v in launches.items() if v} }, "
                 f"expected {want} and no other kernel")

    def generation(tag, adapter, samples):
        """Each response against `vlm_generate` called directly on the same
        frames and prompt; returns (decode steps per request, prefill M)."""
        task = api.get_task("videomme")
        steps, m = [], None
        for s, (key, ids) in zip(samples, list(asked)):
            doc = docs[s["doc_id"]]
            question = task.doc_text(doc, root, adapter.model_name)
            batch, hw = adapter._packed_batch(frames_of(key, ids), question)
            out = vlm.vlm_generate(adapter.model, batch, adapter.cfg, hw=hw,
                                   max_new_tokens=STAGE_B_NEW_TOKENS, eos_token_id=adapter.eos_id,
                                   use_flash=adapter.use_flash, act8=adapter.act8)
            toks = out[0].tolist()
            text = adapter.tokenizer.decode(vlm.truncate_at_stop_sequences(
                out, eos_token_id=adapter.eos_id)[0], skip_special_tokens=True)
            if text != s["response"]:
                fail(f"stage B [{tag}] doc {s['doc_id']}: response {s['response']!r}, the model "
                     f"called directly {text!r}")
            # vlm_generate runs a decode step after each token but the last,
            # and stops after the first eos
            steps.append(next((i for i, t in enumerate(toks) if t == adapter.eos_id),
                              STAGE_B_NEW_TOKENS - 1))
            m = batch.pre_ids.shape[1] + STAGE_B_FRAMES * hw * hw + batch.post_ids.shape[1]
        print(f"stage B [{tag}]: {len(samples)} of {len(samples)} responses equal the model "
              f"called directly (vlm_generate); decode steps {steps}; prefill M {m}; responses "
              f"{[s['response'] for s in samples]}", flush=True)
        return steps, m

    with tempfile.TemporaryDirectory() as tmp:
        root, docs_json = write_eval_root(tmp, docs)
        # ---- stage A: phase 9's run at batch_size 1 ----
        reads = []
        real_reader = video_mod.read_video_frames
        video_mod.read_video_frames = seeded_reader(videos, sampled, reads)
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        before_a = torch.cuda.memory_allocated()
        out_a = os.path.join(tmp, "stage_a")
        t0 = time.perf_counter()
        try:
            rc = evaluate_cli.main(["--model", "videoitg", "--model_args",
                                    f"random_init=True,preset=videoitg-8b,num_frames={EVAL_FRAMES},"
                                    "target_fps=1,batch_size=1", "--tasks", "videomme",
                                    "--data_root", root, "--docs_json", docs_json,
                                    "--output_path", out_a, "--seed", str(SEED)])
            torch.cuda.synchronize()
        finally:
            video_mod.read_video_frames = real_reader
        wall_a = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        if rc != 0:
            fail(f"stage B's stage A: cli/evaluate.main returned {rc}")
        expect_launches_b("stage A", launches, {"flash_mha_short": len(videos) * 4 * tower_layers,
                                                "flash_mha": n_layers * len(docs)})
        for name, n in launches.items():
            total[name] += n
        selections = os.path.join(out_a, "videomme", "results.jsonl")
        with open(selections) as f:
            rows = {r["doc_id"]: r for r in map(json.loads, f)}
        if sorted(rows) != list(range(len(docs))) or sorted(reads) != sorted(videos):
            fail(f"stage B's stage A: rows {sorted(rows)}, reads {reads}")
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() - before_a
        print(f"stage B's stage A [bf16, videomme, batch_size=1]: {len(rows)} rows in "
              f"{wall_a:.2f} s (cli main); {held / 2**30:.3f} GiB more allocated after it "
              f"returned than before; launches A {launches['flash_mha_short']}, B "
              f"{launches['flash_mha']} [{card}]", flush=True)
        if held > 2**28:
            fail(f"stage A's model was not freed: {held / 2**30:.3f} GiB still allocated")

        model_args = (f"frame_indices_jsonl={selections}," +
                      STAGE_B_ARGS.format(n=STAGE_B_FRAMES, t=STAGE_B_NEW_TOKENS))
        requests = [(i, doc["videoID"]) for i, doc in enumerate(docs)]

        # ---- (1) generate_until, bf16 ----
        adapter, launches, samples, _ = stage_b(
            "bf16, videomme", model_args, "videomme", docs_json, os.path.join(tmp, "out_bf16"),
            len(docs))
        if adapter.act8 != Act8Switches() or not adapter.use_flash or \
                adapter.dtype != torch.bfloat16 or not adapter.cfg.lm.tie_word_embeddings:
            fail(f"stage B adapter: act8 {adapter.act8}, use_flash {adapter.use_flash}, dtype "
                 f"{adapter.dtype}")
        expect_asked("bf16", requests)
        expect_launches_b("bf16", launches, {"flash_mha_short": tower_layers * len(docs),
                                             "flash_mha": n_layers * len(docs)})
        weights = sum(t.numel() * t.element_size() for t in adapter.model.state_dict().values())
        print(f"stage B [bf16]: weights {weights / 2**30:.3f} GiB (tied embedding)", flush=True)
        generation("bf16", adapter, samples)
        del adapter
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (2) loglikelihood: two candidates on the first doc of each video ----
        firsts = [next(i for i, d in enumerate(docs) if d["videoID"] == v) for v, _ in EVAL_VIDEOS]
        ll_docs, ll_rows = [], []
        for i in firsts:
            for cand in docs[i]["options"][:2]:
                ll_docs.append(dict(docs[i], _id=f"{i}:{cand[0]}", cand=cand))
                ll_rows.append(dict(rows[i], doc_id=f"{i}:{cand[0]}"))
        ll_json, ll_sel = os.path.join(tmp, "ll_docs.json"), os.path.join(tmp, "ll_sel.jsonl")
        with open(ll_json, "w") as f:
            json.dump(ll_docs, f)
        with open(ll_sel, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in ll_rows))
        videomme = api.get_task("videomme")
        api.register_task(api.Task(
            name="stage_b_ll", doc_to_visual=videomme.doc_to_visual,
            doc_to_text=videomme.doc_to_text, doc_to_target=lambda d: " " + d["cand"],
            output_type="loglikelihood", doc_id_key="_id",
            process_results=lambda doc, r: {"ll": float(r[0]), "greedy": bool(r[1])},
            aggregate=lambda recs: {"mean_ll": sum(r["ll"] for r in recs) / len(recs)}))
        adapter, launches, samples, _ = stage_b(
            "bf16, loglikelihood", model_args.replace(selections, ll_sel), "stage_b_ll", ll_json,
            os.path.join(tmp, "out_ll"), len(ll_docs))
        expect_asked("loglikelihood", [(int(d["_id"].split(":")[0]), d["videoID"])
                                       for d in ll_docs])
        expect_launches_b("loglikelihood", launches, {"flash_mha_short": tower_layers * len(ll_docs),
                                                      "flash_mha": n_layers * len(ll_docs)})
        task = api.get_task("stage_b_ll")
        direct = []
        for s, d, (key, ids) in zip(samples, ll_docs, list(asked)):
            question = adapter.strip_inline_image_slots(task.doc_text(d, root, adapter.model_name))
            cont = adapter.tokenizer(" " + d["cand"]).input_ids
            batch, hw = adapter._packed_batch(frames_of(key, ids), question, post_extra=cont,
                                              post_labels=cont)
            ll, greedy = vlm.vlm_loglikelihood(adapter.model, batch, adapter.cfg, hw=hw,
                                               use_flash=adapter.use_flash, act8=adapter.act8)
            direct.append([float(ll[0]), bool(greedy[0])])
        got = [s["response"] for s in samples]
        print(f"stage B [loglikelihood]: (ll, is_greedy) through the harness {got}; the model "
              f"called directly (vlm_loglikelihood) {direct}", flush=True)
        if got != direct or not all(np.isfinite(ll) and ll < 0 for ll, _ in got):
            fail("stage B loglikelihoods differ from the model called directly or are not finite "
                 "and negative")
        del adapter
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (3) generate_until, act8 with kernels F-I on ----
        adapter, launches, samples, _ = stage_b(
            "act8, videomme", model_args + ",quantize=act8", "videomme", docs_json,
            os.path.join(tmp, "out_act8"), len(docs),
            env=(("VIDEOITG_QGEMM", "1"), ("VIDEOITG_FUSED", "1")))
        if adapter.act8 != Act8Switches(qgemm=True, fused=True):
            fail(f"stage B act8 adapter switches {adapter.act8}")
        expect_asked("act8", requests)
        lm, tower = adapter.model.lm, adapter.model.vision
        f_per_layer = {sum(qg.shapes_supported(getattr(layer, k)) for k in QWEN2_LINEAR_KEYS)
                       for layer in lm.layers[:n_layers]}
        fused = sum(can_fuse_encoder_layer(layer) and layer.q.out_features == layer.q.in_features
                    for layer in tower.layers[:tower_layers])
        if f_per_layer != {7} or fused != tower_layers:
            fail(f"act8: kernel-served LM linears per layer {f_per_layer}, fused tower layers "
                 f"{fused}")
        steps, m_prefill = generation("act8", adapter, samples)
        n = len(docs)
        expect_launches_b("act8", launches, {
            "flash_mha_short": tower_layers * n, "flash_mha": n_layers * n,
            "fused_ln_qkv_int8": fused * n, "fused_ln_mlp_int8": fused * n,
            "fused_proj_residual_int8": fused * n,
            # each LM layer's 7 linears in the prefill and in every decode step
            "act8_gemm": 7 * n_layers * sum(1 + d for d in steps)})

        # ---- F at M = 1 (a decoded token) and at the prefill's M, on the
        # model's own layer-0 weights, against its plain version ----
        gen = torch.Generator(device=dev).manual_seed(SEED + 100)
        layer = lm.layers[0]
        rec = dict(prefill_m=m_prefill, m1_ms=0.0, m1_plain_ms=0.0, m1_int_mm_ms=0.0,
                   m1_bound_ms=0.0, worst=0.0)
        for key in QWEN2_LINEAR_KEYS:
            lin = getattr(layer, key)
            n_out, k = lin.w_qt.shape
            for m in (1, m_prefill):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                ref = qg.act8_gemm_reference(x, None, lin.w_qt, lin.scale)
                out = qg.act8_gemm(x, None, lin.w_qt, lin.scale)
                tol = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
                err, _ = err_stats(out, ref)
                equal = bool(torch.equal(out, ref))
                if not (err <= tol and equal):
                    fail(f"act8_gemm [{m}, {k}] x [{k}, {n_out}] ({key}): error {err} (tol {tol}), "
                         f"bit-equal {equal}")
                rec["worst"] = max(rec["worst"], err)
                if m == 1:
                    ms = cuda_ms(lambda: qg.act8_gemm(x, None, lin.w_qt, lin.scale), 50)
                    plain = cuda_ms(lambda: qg.act8_gemm_reference(x, None, lin.w_qt, lin.scale),
                                    20)
                    x_q, _ = qg.row_quant_reference(x)
                    pad = torch.zeros(32, k, dtype=torch.int8, device=dev)
                    pad[:1] = x_q
                    int_mm = cuda_ms(lambda: torch._int_mm(pad, lin.w_qt.t()), 50)
                    bnd = bound(2 * k * n_out, PEAK_INT8, k * 2 + n_out * k + n_out * 4 + n_out * 2)
                    rec["m1_ms"] += ms
                    rec["m1_plain_ms"] += plain
                    rec["m1_int_mm_ms"] += int_mm
                    rec["m1_bound_ms"] += bnd["bound_ms"]
                    print(f"kernel act8_gemm at M = 1 ({key}) [1, {k}] x [{k}, {n_out}]: "
                          f"max_abs_err {err:.6g} (tol {tol:.6g}, bit-equal {equal}); {ms:.4f} ms, "
                          f"plain {plain:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
                          f"{bnd['bound_by']}; bare torch._int_mm on 32 padded rows "
                          f"{int_mm:.4f} ms", flush=True)
                else:
                    print(f"kernel act8_gemm at the prefill's M ({key}) [{m}, {k}] x "
                          f"[{k}, {n_out}]: max_abs_err {err:.6g} (tol {tol:.6g}, bit-equal "
                          f"{equal})", flush=True)
                del x, ref, out
        print(f"kernel act8_gemm, one LM layer at M = 1 (7 launches, a decoded token's share): "
              f"{rec['m1_ms']:.4f} ms, plain {rec['m1_plain_ms']:.4f} ms, bound "
              f"{rec['m1_bound_ms']:.4f} ms, bare torch._int_mm {rec['m1_int_mm_ms']:.4f} ms; "
              f"x {n_layers} layers {n_layers * rec['m1_ms']:.3f} ms a token [{card}]", flush=True)
        del adapter, lm, tower, layer
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": {k: total[k] for k in SERVING_KERNELS}, "act8_gemm_m1": rec}


RING_S = 512 * 25 + 256     # the LM's serving sequence, 13,056 slots
RING_VALID = 9792           # keys at and past it masked: a ring of 4's last block is dead
TRAIN_S = 1024 * 16 + 256   # the training cell's LM sequence, 16,640 slots
TRAIN_RING_VALID = 12480    # keys and rows past it masked: a ring of 4's last block is dead


def mesh_training(model, cfg, mesh, dev, card) -> dict:
    """Phase 11 (d): phase 7's LoRA step (VideoITG-8B, r16, a 1024-frame
    feature batch, 16,640 tokens, remat) three times with no mesh and three
    times through run_step(mesh=...) on the world-size-1 mesh, from the same
    start, once without and once with the optimizer's host offload. The
    mesh's steps must equal the others bit for bit: loss, grad_norm, the
    trainable leaves and the AdamW moments; C, D and E launch 56, 28 and 28
    times a step. Returns the mesh runs' launches."""
    import torch

    from videoitg_tpu_torch.models.grounding import GroundingBatch
    from videoitg_tpu_torch.train.lora import add_lora, make_lora_optimizer
    from videoitg_tpu_torch.train.offload import make_offloaded_train_step
    from videoitg_tpu_torch.train.train_step import create_train_state, make_train_step

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    add_lora(model, gen, rank=16)
    opt = dict(learning_rate=2e-4, out_proj_lr=2e-4, total_steps=10)
    start = [p.detach().clone() for p in make_lora_optimizer(model, **opt).params]
    t_frames, hw = 1024, 4
    feats = torch.randn(1, t_frames, cfg.vision.num_patches, cfg.vision.hidden_size,
                        generator=gen, device=dev, dtype=torch.bfloat16)
    batch = GroundingBatch(
        frames=feats, frame_valid=torch.ones(1, t_frames, dtype=torch.bool, device=dev),
        text_ids=torch.randint(0, cfg.lm.vocab_size, (1, cfg.max_text_len), generator=gen,
                               device=dev),
        text_valid=torch.arange(cfg.max_text_len, device=dev)[None] < 40,
        labels=(torch.rand(1, t_frames, generator=gen, device=dev) < 0.1).float())
    expect = expect_launches("train", cfg.lm.num_layers)
    launches = {name: 0 for name in TRAIN_KERNELS}
    for offload in (False, True):
        runs = {}
        for on_mesh in (False, True):
            with torch.no_grad():
                tx = make_lora_optimizer(model, **opt)
                for p, p0 in zip(tx.params, start):
                    p.copy_(p0)
            state = create_train_state(model, tx)
            step_fn = make_train_step(cfg, tx, hw=hw, use_flash=True, remat=True)
            if offload:
                step_fn = make_offloaded_train_step(step_fn)
            tag = (f"8b lora, features, {'world-size-1 mesh' if on_mesh else 'no mesh'}"
                   f"{', offload' if offload else ''}")
            record = []
            state, total = train_steps(tag, state, step_fn, batch, 3, expect, card,
                                       mesh=mesh if on_mesh else None, record=record)
            moments = [tx.optimizer.state[p][key] for p in tx.params
                       for key in ("exp_avg", "exp_avg_sq")]
            if offload and any(m.is_cuda for m in moments):
                fail(f"[{tag}] a moment stayed on the card after the step")
            runs[on_mesh] = (record, bit_checksums(tx.params), bit_checksums(moments))
            if on_mesh:
                for name in TRAIN_KERNELS:
                    launches[name] += total[name]
            del state, tx, step_fn, moments
        same = [runs[True][i] == runs[False][i] for i in range(3)]
        print(f"[mesh] training{' with offload' if offload else ''}: 3 steps on the "
              f"world-size-1 mesh vs no mesh: losses and grad_norms {runs[True][0]}; equal "
              f"{same[0]}, trainable leaves bit-equal {same[1]}, AdamW moments bit-equal "
              f"{same[2]} [{card}]", flush=True)
        if not all(same):
            fail(f"world-size-1 mesh training{' with offload' if offload else ''}: not "
                 f"bit-equal to no mesh (losses {runs[True][0]} vs {runs[False][0]})")
    del feats, batch
    return launches


def attention_grads_fp32(q, k, v, valid, do, chunk=2048):
    """(dq, dk, dv) of sum(attention(q, k, v) * do) in fp32 by autograd, the
    query rows in chunks (each row's output depends on its own query only),
    so a chunk's scores are [1, Hq, chunk, S] and no more."""
    import torch

    group = q.shape[1] // k.shape[1]
    kf = k.float().requires_grad_()
    vf = v.float().requires_grad_()
    bias = torch.zeros(valid.shape, device=q.device).masked_fill(~valid, float("-inf"))
    dqs = []
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c0 in range(0, q.shape[2], chunk):
        qc = q[:, :, c0:c0 + chunk].float().requires_grad_()
        k_rep, v_rep = kf.repeat_interleave(group, dim=1), vf.repeat_interleave(group, dim=1)
        scores = qc @ k_rep.transpose(-1, -2) * q.shape[-1] ** -0.5 + bias[:, None, None, :]
        out = torch.softmax(scores, dim=-1) @ v_rep
        gq, gk, gv = torch.autograd.grad(out, (qc, kf, vf), do[:, :, c0:c0 + chunk].float())
        dqs.append(gq)
        dk += gk
        dv += gv
        del scores, out
    return torch.cat(dqs, dim=2), dk, dv


def ring_backward_cells(dev, card) -> dict:
    """Phase 11 (e): every rank's forward and backward ring steps, for rings
    of 2 and 4, driven in one process at [1, 28/4, 16,640, 128] bf16 with the
    keys and rows past 12,480 masked (the ring of 4's last block has no valid
    key and no valid row): kernel D and E on each visiting block with the
    global lse (`parallel/ring_attention.ring_shard_backward`). dq, dk and dv
    are held to D and E on the unsplit sequence, to the fp32 autograd
    reference and to the ring driven with the kernels' plain versions; D and
    E are timed on a block beside the plain version, the bound and the
    library's share. Returns {"flash_train_dq" / "flash_train_dkv": {"ring2",
    "ring4"}}."""
    import torch

    from videoitg_tpu_torch.ops import flash_attention_train as fat
    from videoitg_tpu_torch.parallel import ring_attention as ring

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    s = TRAIN_S
    q, k, v = randn(1, 28, s, 128), randn(1, 4, s, 128), randn(1, 4, s, 128)
    do = randn(1, 28, s, 128)
    valid = torch.arange(s, device=dev)[None] < TRAIN_RING_VALID
    rows = valid[0]
    # references: D and E unsplit, fp32 autograd (the loss reads valid rows only)
    o_u, lse_u = fat.flash_train_fwd(q, k, v, valid)
    do0_u, delta_u = fat.prepare_backward(valid, o_u, do)
    unsplit = (fat.flash_train_dq(q, k, v, valid, do0_u, lse_u, delta_u),
               *fat.flash_train_dkv(q, k, v, valid, do0_u, lse_u, delta_u))
    exact = attention_grads_fp32(q, k, v, valid, do0_u)
    del o_u, lse_u, do0_u, delta_u
    records = {"flash_train_dq": {}, "flash_train_dkv": {}}
    for n in (2, 4):
        s_loc = s // n
        parts = [slice(r * s_loc, (r + 1) * s_loc) for r in range(n)]
        shards = [(k[:, :, p].contiguous(), v[:, :, p].contiguous(), valid[:, p].contiguous())
                  for p in parts]
        dq = [None] * n
        # contributions[j][i]: block j's dK/dV from rank (j - i) % n, the i-th
        # to join its accumulator on the ring
        contrib = [[None] * n for _ in range(n)]
        plain_dq = [torch.zeros(1, 28, s_loc, 128, device=dev) for _ in range(n)]
        plain_dkv = [[torch.zeros(1, 4, s_loc, 128, device=dev) for _ in range(2)]
                     for _ in range(n)]
        kernel_inputs = []
        for r in range(n):
            def fetch(i, _blocks, r=r):
                return lambda: shards[(r + i + 1) % n]
            q_r, do_r = q[:, :, parts[r]].contiguous(), do[:, :, parts[r]].contiguous()
            lse, acc = ring.ring_flash_state(q_r, *shards[r], n=n, start_fetch=fetch)
            o_r = ring.finish(acc, shards[r][2], q.dtype)
            sent = []

            def pass_grads(dk_acc, dv_acc, sent=sent):
                sent.append((dk_acc, dv_acc))
                return torch.zeros_like(dk_acc), torch.zeros_like(dv_acc)
            dq[r], _, _ = ring.ring_shard_backward(q_r, *shards[r], o_r, lse, do_r, n=n,
                                                   start_fetch=fetch, pass_grads=pass_grads)
            for i, pair in enumerate(sent):
                contrib[(r + i) % n][i] = pair
            # the same steps through the kernels' plain versions
            do0, delta = fat.prepare_backward(shards[r][2], o_r, do_r)
            lse_inf = torch.where(lse <= ring.NEG_BIG / 2, torch.full_like(lse, float("inf")),
                                  lse)
            for i in range(n):
                j = (r + i) % n
                g = fat.backward_on_kernel_inputs(q_r, shards[j][0], shards[j][1], shards[j][2],
                                                  do0, lse_inf, delta, False)
                plain_dq[r] += g[0].float()
                plain_dkv[j][0] += g[1].float()
                plain_dkv[j][1] += g[2].float()
            kernel_inputs.append((q_r, do0, lse_inf, delta))
        ring_g = (torch.cat(dq, dim=2),
                  torch.cat([sum((c[0] for c in contrib[j][1:]), contrib[j][0][0]).to(k.dtype)
                             for j in range(n)], dim=2),
                  torch.cat([sum((c[1] for c in contrib[j][1:]), contrib[j][0][1]).to(v.dtype)
                             for j in range(n)], dim=2))
        plain_g = (torch.cat(plain_dq, dim=2),
                   torch.cat([plain_dkv[j][0] for j in range(n)], dim=2),
                   torch.cat([plain_dkv[j][1] for j in range(n)], dim=2))
        dead = [r for r in range(n) if not bool(shards[r][2].any())]
        errs, msg = {}, []
        ok = True
        for name, got, u, e, pl in zip(("dq", "dk", "dv"), ring_g, unsplit, exact, plain_g):
            tol = bf16_tol(e)
            errs[name] = dict(vs_fp32=max_err(got, e), vs_unsplit=max_err(got, u.float()),
                              vs_plain=max_err(got, pl), tol=tol)
            finite = bool(torch.isfinite(got).all())
            zero = got[0][:, ~rows].abs().max().item()  # invalid rows (dq) or keys (dk, dv)
            msg.append(f"{name} vs fp32 {errs[name]['vs_fp32']:.6g}, vs unsplit D/E "
                       f"{errs[name]['vs_unsplit']:.6g}, vs plain blocks "
                       f"{errs[name]['vs_plain']:.6g} (tol {2 * tol:.6g}), masked max {zero}, "
                       f"finite {finite}")
            ok &= (max(errs[name]["vs_fp32"], errs[name]["vs_unsplit"],
                       errs[name]["vs_plain"]) <= 2 * tol and zero == 0.0 and finite)
        # D and E on rank 0's own block (all its rows and keys valid), timed
        q_0, do0_0, lse_0, delta_0 = kernel_inputs[0]
        k_0, v_0, kv_0 = shards[0]
        ms = dict(dq=cuda_ms(lambda: fat.flash_train_dq(q_0, k_0, v_0, kv_0, do0_0, lse_0,
                                                        delta_0), 5),
                  dkv=cuda_ms(lambda: fat.flash_train_dkv(q_0, k_0, v_0, kv_0, do0_0, lse_0,
                                                          delta_0), 5))
        plain_ms = cuda_ms(lambda: fat.backward_on_kernel_inputs(
            q_0, k_0, v_0, kv_0, do0_0, lse_0, delta_0, False), 1)
        # The library's autograd backward of memory-efficient sdpa on the same
        # block (kv heads expanded, the key mask as an additive bias): dq, dk
        # and dv in one call, split 3/7 (D) and 4/7 (E) by the kernels' work.
        qg = q_0.detach().clone().requires_grad_()
        k28 = k_0.repeat_interleave(7, dim=1).requires_grad_()
        v28 = v_0.repeat_interleave(7, dim=1).requires_grad_()
        key_bias = torch.zeros(1, 1, 1, s_loc, dtype=torch.bfloat16, device=dev).masked_fill(
            ~kv_0[:, None, None, :], float("-inf")).expand(1, 28, s_loc, s_loc)
        lib_out = torch.ops.aten._scaled_dot_product_efficient_attention(
            qg, k28, v28, key_bias, True)[0]
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, k28, v28), do0_0,
                                                         retain_graph=True), 3)
        del qg, k28, v28, key_bias, lib_out
        unit = s_loc * s_loc * 128 * 28  # the block's pairs, every row and key valid
        big, small, stat = q_0.numel() * 2, k_0.numel() * 2, lse_0.numel() * 4
        bounds = dict(dq=bound(6 * unit, PEAK_BF16, 3 * big + 2 * small + 2 * stat),
                      dkv=bound(8 * unit, PEAK_BF16, 2 * big + 4 * small + 2 * stat))
        share = dict(dq=3 / 7, dkv=4 / 7)
        print(f"[mesh] ring backward of {n} at [1, 28/4, {s}, 128], keys and rows from "
              f"{TRAIN_RING_VALID} masked (dead blocks {dead}): " + "; ".join(msg)
              + f"; per block [1, 28/4, {s_loc}, 128]: D {ms['dq']:.4f} ms, E "
              f"{ms['dkv']:.4f} ms, plain (dq, dk, dv together) {plain_ms:.4f} ms, library "
              f"(efficient sdpa's autograd backward, dq, dk, dv together) {library_ms:.4f} ms: "
              f"D's share {library_ms * share['dq']:.4f}, E's {library_ms * share['dkv']:.4f}; "
              f"bounds D {bounds['dq']['bound_ms']:.4f}, E {bounds['dkv']['bound_ms']:.4f} ms "
              f"by {bounds['dkv']['bound_by']} [{card}]", flush=True)
        if not ok:
            fail(f"ring backward of {n}: " + "; ".join(msg))
        if n == 4 and dead != [3]:
            fail(f"ring of 4: the last block should hold no valid key, dead {dead}")
        for rec, part, names in (("flash_train_dq", "dq", ("dq",)),
                                 ("flash_train_dkv", "dkv", ("dk", "dv"))):
            records[rec][f"ring{n}"] = dict(
                block_shape=[1, 28, 4, s_loc, 128],
                max_abs_err=max(max(errs[x]["vs_fp32"], errs[x]["vs_unsplit"],
                                    errs[x]["vs_plain"]) for x in names),
                ms=ms[part], plain_ms=plain_ms, library_ms=library_ms,
                library_share_ms=library_ms * share[part],
                note="plain_ms and library_ms are the block's whole backward (dq, dk, dv)",
                **bounds[part])
        del dq, contrib, plain_dq, plain_dkv, kernel_inputs, ring_g, plain_g
        torch.cuda.empty_cache()
    del q, k, v, do, unsplit, exact
    torch.cuda.empty_cache()
    return records




def run_mesh(dev, card: str) -> dict:
    """Phase 11, the mesh path on one card: (a) the engine on a world-size-1
    NCCL mesh against the engine with none, (b) A, B and K at one
    tensor-parallel rank's shapes, (c) every rank's steps of a ring of 2 and
    of 4, (d) LoRA training steps on the world-size-1 mesh against none, (e)
    every rank's backward ring steps. Returns {"launches": the mesh engine's
    A and B counts and the mesh training's C, D and E counts, "records":
    kernel name -> what (b), (c) and (e) measured}."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.ops import splash_attention as sa
    from videoitg_tpu_torch.ops.flash_attention import flash_mha
    from videoitg_tpu_torch.ops.flash_attention_short import (flash_mha_short,
                                                              flash_mha_short_reference)
    from videoitg_tpu_torch.ops.flash_attention_train import (flash_mha_train_reference,
                                                              flash_train_fwd)
    from videoitg_tpu_torch.parallel import ring_attention as ring
    from videoitg_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    records: dict = {"flash_mha_short": {}, "flash_mha": {}, "splash_mqa": {},
                     "flash_train_fwd": {}}
    counted = wrappers()

    # (a) the mesh at world size 1
    rng = np.random.default_rng(SEED + 11)
    video512 = frames_u8(rng, 512)
    sampled512 = [2 * i for i in range(512)]
    torch.cuda.set_device(dev)  # the rank's device before its NCCL communicator
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh()
            print(f"[mesh] backend {dist.get_backend()}, world size {dist.get_world_size()}, "
                  f"mesh {mesh_shape(mesh)}", flush=True)
            if set(mesh_shape(mesh).values()) != {1}:
                fail(f"make_mesh() on one rank gave {mesh_shape(mesh)}")
            model, cfg, tok = load_grounding_components(None, "videoitg-8b", True,
                                                        torch.bfloat16, dev, seed=SEED)
            plain = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16)
            meshed = SelectionEngine(model, cfg, tok, device=dev, dtype=torch.bfloat16,
                                     mesh=mesh)
            mesh_launches = {"flash_mha_short": 0, "flash_mha": 0}

            def drive(engine, fn, n_lm, tag):
                for w in counted.values():
                    w.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(engine)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {name: counted[name].launches for name in ("flash_mha_short", "flash_mha")}
                want = {"flash_mha_short": 104, "flash_mha": 28 * n_lm}
                print(f"[mesh] {tag}: {wall:.4f} s, launches {got} [{card}]", flush=True)
                if got != want or any(w.launches for n, w in counted.items() if n not in got):
                    fail(f"{tag}: launches {got}, want {want} and nothing else")
                return out, got

            calls = [("select 512 frames", 1,
                      lambda e: [e.select(video512, sampled512, QUESTIONS[0])]),
                     ("select_many 512 frames x 3 questions", 3,
                      lambda e: e.select_many(video512, sampled512, QUESTIONS))]
            for name, n_lm, fn in calls:
                want, _ = drive(plain, fn, n_lm, f"no mesh, {name}")
                got, n = drive(meshed, fn, n_lm, f"world-size-1 mesh, {name}")
                for k, v in n.items():
                    mesh_launches[k] += v
                for g, w in zip(got, want):
                    check_result(g, sampled512)
                    if g.index != w.index or not np.array_equal(g.raw_scores, w.raw_scores):
                        fail(f"mesh {name}: not bit-equal to the engine with no mesh "
                             f"(max diff {float(np.abs(g.raw_scores - w.raw_scores).max())})")
                print(f"[mesh] {name}: Top-K and scores bit-equal to the engine with no mesh, "
                      f"top8 {got[0].topk(8)}", flush=True)
            del plain, meshed
            torch.cuda.empty_cache()
            # (d) training steps on the same mesh
            mesh_launches.update(mesh_training(model, cfg, mesh, dev, card))
            del model
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # (b) kernels at one tensor-parallel rank's shapes
    for tp in (2, 4):
        shape = (128, 16 // tp, 729, 72)
        q, k, v = (randn(*shape) for _ in range(3))
        ref = torch.cat([flash_mha_short_reference(q[i:i + 32].float(), k[i:i + 32].float(),
                                                   v[i:i + 32].float())
                         for i in range(0, 128, 32)])
        err, tol = max_err(flash_mha_short(q, k, v), ref), bf16_tol(ref)
        ms = cuda_ms(lambda: flash_mha_short(q, k, v), 20)
        t, h, sq, d = shape
        bnd = bound(4 * sq * sq * d * t * h, PEAK_BF16, 4 * q.numel() * 2)
        print(f"[mesh] kernel flash_mha_short tp={tp} {list(shape)}: max_abs_err {err:.6g} "
              f"(tol {tol:.6g}); {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']} [{card}]", flush=True)
        if not err <= tol:
            fail(f"flash_mha_short tp={tp}: error {err} > {tol}")
        records["flash_mha_short"][f"tp{tp}"] = dict(shape=list(shape), max_abs_err=err, ms=ms,
                                                     **bnd)
        del q, k, v, ref

        hq, hkv = 28 // tp, 4 // tp
        q = randn(1, hq, RING_S, 128)
        k, v = randn(1, hkv, RING_S, 128), randn(1, hkv, RING_S, 128)
        valid = torch.rand(1, RING_S, generator=gen, device=dev) > 0.01
        valid[:, 512 * 25 + 40:] = False
        ref = lm_reference(q, k, v, valid)
        tol = bf16_tol(ref)
        for name, fn in (("flash_mha", lambda: flash_mha(q, k, v, valid=valid)),
                         ("splash_mqa", lambda: sa.splash_lm(q, k, v, valid))):
            out = fn()
            rows = valid[0]
            err = max_err(out[:, :, rows], ref[:, :, rows])
            masked = out[0][:, ~rows].abs().max().item()
            ms = cuda_ms(fn, 10)
            n_valid = int(rows.sum())
            pairs = RING_S * RING_S if name == "flash_mha" else \
                n_valid * n_valid + (RING_S - n_valid) ** 2
            bnd = bound(4 * pairs * 128 * hq, PEAK_BF16, (2 * q.numel() + 2 * k.numel()) * 2)
            print(f"[mesh] kernel {name} tp={tp} [1, {hq}/{hkv}, {RING_S}, 128]: max_abs_err "
                  f"{err:.6g} on valid rows (tol {tol:.6g}), invalid rows max {masked}; "
                  f"{ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} [{card}]",
                  flush=True)
            if not err <= tol or masked != 0.0:
                fail(f"{name} tp={tp}: error {err} > {tol} or invalid rows not 0")
            records[name][f"tp{tp}"] = dict(shape=[1, hq, hkv, RING_S, 128], max_abs_err=err,
                                            ms=ms, **bnd)
        del q, k, v, ref, out
        torch.cuda.empty_cache()

    # (c) every rank's steps of a ring, in one process
    q, k, v = randn(1, 28, RING_S, 128), randn(1, 4, RING_S, 128), randn(1, 4, RING_S, 128)
    valid = torch.rand(1, RING_S, generator=gen, device=dev) > 0.01
    valid[:, RING_VALID:] = False
    ref = lm_reference(q, k, v, valid)
    tol = bf16_tol(ref)
    whole = flash_mha(q, k, v, valid=valid)
    for n in (2, 4):
        s_loc = RING_S // n
        parts = [slice(r * s_loc, (r + 1) * s_loc) for r in range(n)]
        shards = [(k[:, :, p].contiguous(), v[:, :, p].contiguous(), valid[:, p].contiguous())
                  for p in parts]

        def run(impl):
            outs = []
            for r in range(n):
                def start(i, _blocks, r=r):
                    return lambda: shards[(r + i + 1) % n]
                outs.append(ring.ring_shard(q[:, :, parts[r]].contiguous(), *shards[r], n=n,
                                            rank=r, start_fetch=start, block_impl=impl))
            return torch.cat(outs, dim=2)

        merged = run("flash")
        plain_blocks = run("einsum")
        dead = [r for r in range(n) if not bool(shards[r][2].any())]
        rows = valid[0]
        err = max_err(merged[:, :, rows], ref[:, :, rows])
        vs_b = (merged.float() - whole.float()).abs().max().item()
        vs_plain = (merged.float() - plain_blocks.float()).abs().max().item()
        masked = merged[0][:, ~rows].abs().max().item()
        finite = bool(torch.isfinite(merged).all())
        qs, (ks, vs, kvs) = q[:, :, parts[0]].contiguous(), shards[0]
        ms = cuda_ms(lambda: flash_train_fwd(qs, ks, vs, valid=kvs, key_mask_only=True), 10)
        plain_ms = cuda_ms(lambda: flash_mha_train_reference(qs, ks, vs, valid=kvs,
                                                             key_mask_only=True), 1)
        # The library's one call that also returns lse: memory-efficient
        # sdpa, kv heads expanded, the key mask as an additive bias.
        k28, v28 = ks.repeat_interleave(7, dim=1), vs.repeat_interleave(7, dim=1)
        key_bias = torch.zeros(1, 1, 1, s_loc, dtype=torch.bfloat16, device=dev).masked_fill(
            ~kvs[:, None, None, :], float("-inf")).expand(1, 28, s_loc, s_loc)

        def library():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qs, k28, v28, key_bias, True)[:2]

        library_ms = cuda_ms(library, 10)
        lib_diff = (library()[0].float() - flash_train_fwd(
            qs, ks, vs, valid=kvs, key_mask_only=True)[0].float()).abs().max().item()
        del k28, v28, key_bias
        bnd = bound(4 * s_loc * s_loc * 128 * 28, PEAK_BF16,
                    (2 * qs.numel() + 2 * ks.numel()) * 2 + qs.numel() // 128 * 4 + s_loc)
        print(f"[mesh] ring of {n} at [1, 28/4, {RING_S}, 128], keys from {RING_VALID} masked "
              f"(dead blocks {dead}): max_abs_err {err:.6g} (tol {tol:.6g}); vs B unsplit "
              f"{vs_b:.6g}, vs plain blocks {vs_plain:.6g} (tol {2 * tol:.6g}); invalid rows "
              f"max {masked}, finite {finite}; C per block [1, 28/4, {s_loc}, 128] {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library (efficient sdpa with lse, kv heads expanded, "
              f"key mask as bias) {library_ms:.4f} ms (its output vs C's {lib_diff:.6g}), "
              f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} [{card}]", flush=True)
        if not (err <= tol and vs_b <= 2 * tol and vs_plain <= 2 * tol and masked == 0.0
                and finite):
            fail(f"ring of {n}: error {err} / {vs_b} / {vs_plain}, invalid rows {masked}, "
                 f"finite {finite}")
        if n == 4 and dead != [3]:
            fail(f"ring of 4: the last block should hold no valid key, dead {dead}")
        records["flash_train_fwd"][f"ring{n}"] = dict(
            block_shape=[1, 28, 4, s_loc, 128], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_vs_kernel=lib_diff, **bnd)
        del merged, plain_blocks
        torch.cuda.empty_cache()
    del q, k, v, ref, whole
    torch.cuda.empty_cache()

    # (e) every rank's backward steps of a ring, in one process
    records.update(ring_backward_cells(dev, card))
    return {"launches": mesh_launches, "records": records}


# ---- phase 13: the overfit trajectory (scripts/train/torch_overfit_smoke.py) ----

OVERFIT_ARGS = ["--preset", "videoitg-2b", "--lora", "16", "--steps", "400", "--batch", "2",
                "--lr", "2e-4", "--save-steps", "25", "--videos", "32", "--targets", "8"]
OVERFIT_THRESHOLD = 0.9


def fixture_reader(path, num_frames=512, target_fps=1.0, sampling="eval", multiple=1,
                   pix_fmt="rgb"):
    """A stand-in for `data/video.read_video_frames` on the overfit script's
    fixtures (`write_test_video(path, 64, 48, 32, 10, 8)`: frame i is the
    solid colour `expected_fixture_color(i)`): the frames the port's own
    sampling arithmetic picks, made without a decoder."""
    import numpy as np

    from videoitg_tpu_torch.data.sampling import (sample_frame_indices_eval,
                                                  sample_frame_indices_infer)
    from videoitg_tpu_torch.data.video import expected_fixture_color

    if pix_fmt != "rgb" or not os.path.exists(path):
        raise FileNotFoundError(f"{path} ({pix_fmt})")
    total, fps = 32, 10.0
    if sampling == "eval":
        sampled = sample_frame_indices_eval(total, fps, target_fps, num_frames, multiple)
    else:
        sampled = sample_frame_indices_infer(total, fps, target_fps, num_frames)
    frames = np.empty((len(sampled), 48, 64, 3), dtype=np.uint8)
    for n, i in enumerate(sampled):
        frames[n] = expected_fixture_color(i)
    return frames, list(sampled)


def empty_fixture(path, *args, **kwargs) -> str:
    """A stand-in for `data/video.write_test_video`: the file the records
    name, empty (`fixture_reader` makes its frames)."""
    open(path, "wb").close()
    return path


def train_child(argv) -> int:
    """`chip_smoke.py --train-child -- ARGS` (phase 13's child process): the
    port's train CLI with ARGS, the frame reader swapped for `fixture_reader`;
    then one line `[train-child] {"peak_gib": ..., "launches": {...}}`."""
    sys.path.insert(0, HERE)
    import torch

    from videoitg_tpu_torch.cli import train
    from videoitg_tpu_torch.data import video as video_mod

    video_mod.read_video_frames = fixture_reader
    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    rc = train.main(argv)
    peak = torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_available() else 0.0
    print("[train-child] " + json.dumps({"peak_gib": peak, "launches": {
        name: fn.launches for name, fn in counted.items()}}), flush=True)
    return rc


def run_overfit(dev, card: str) -> dict:
    """Phase 13: scripts/train/torch_overfit_smoke.py's recipe at videoitg-2b
    (LoRA 16, 400 steps, batch 2, lr 2e-4, a checkpoint every 25 steps, 32
    videos, 8 targets). Its train CLI runs in child processes through
    `--train-child` (the frame reader swapped), phase 1 is killed after its
    first checkpoint, phase 2 must auto-resume and reach step 400, and the
    evaluation in this process (the same swap) must reach Top-1 >= 0.9.
    Phase 2's child counts C, D, E (the frozen tower's C and the LM's C, D,
    E each step); the evaluation A and B. Returns {"launches": both,
    "record": the run's numbers}."""
    import importlib.util
    import tempfile

    import torch

    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.data import video as video_mod

    spec = importlib.util.spec_from_file_location(
        "torch_overfit_smoke", os.path.join(HERE, "scripts", "train", "torch_overfit_smoke.py"))
    overfit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(overfit)
    launcher = [sys.executable, os.path.abspath(__file__), "--train-child", "--"]
    counted = wrappers()
    real = video_mod.read_video_frames, video_mod.write_test_video
    video_mod.read_video_frames, video_mod.write_test_video = fixture_reader, empty_fixture
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as work:
            args = overfit.build_parser().parse_args(
                OVERFIT_ARGS + ["--threshold", str(OVERFIT_THRESHOLD), "--workdir", work])
            for fn in counted.values():
                fn.launches = 0
            try:
                res = overfit.run(args, launcher=launcher)
            except (SystemExit, AssertionError) as e:
                for log in ("phase1.log", "phase2.log"):
                    path = os.path.join(work, log)
                    if os.path.exists(path):
                        with open(path) as f:
                            print(f"overfit {log} (last lines):\n" + "".join(f.readlines()[-15:]),
                                  flush=True)
                fail(f"overfit: {e}")
            eval_launches = {name: fn.launches for name, fn in counted.items()}
            with open(res["logs"][1]) as f:
                child = [json.loads(line.split("[train-child] ", 1)[1]) for line in f
                         if line.startswith("[train-child] ")]
    finally:
        video_mod.read_video_frames, video_mod.write_test_video = real
    wall = time.perf_counter() - t0
    cfg = preset(args.preset)
    if len(child) != 1:
        fail("overfit: phase 2's child printed no launch counts")
    child = child[0]
    steps = res["steps"] - res["resumed_from_step"]
    per_step = expect_launches("train", cfg.lm.num_layers, cfg.vision.num_effective_layers)
    want_train = {name: n * steps for name, n in per_step.items()}
    got_train = {name: child["launches"][name] for name in want_train}
    videos = res["videos"]
    want_eval = {"flash_mha_short": cfg.vision.num_effective_layers * videos,
                 "flash_mha": cfg.lm.num_layers * videos}
    got_eval = {name: eval_launches[name] for name in want_eval}
    print(f"overfit {args.preset} LoRA {args.lora}, {res['steps']} steps, batch {args.batch}, lr "
          f"{args.lr}, a checkpoint every {args.save_steps}: killed after "
          f"the checkpoint of step {res['killed_at_step']}, resumed from step "
          f"{res['resumed_from_step']}; loss {res['first_loss']:.6f} at step "
          f"{res['first_loss_step']} -> {res['last_loss']:.6f} at step {res['last_loss_step']}; "
          f"phase 2 {res['s_per_step']:.4f} s a step with the checkpoints "
          f"({res['s_per_step_alone']:.4f} s a step and {res['s_per_checkpoint']:.4f} s a "
          f"checkpoint of the whole model's leaves, {args.save_steps} steps apart), phase 1 "
          f"{res['phase1_s']:.1f} s, phase 2 {res['phase2_s']:.1f} s, evaluation "
          f"{res['eval_s']:.1f} s; child peak device "
          f"memory {child['peak_gib']:.3f} GiB; Top-1 {res['top1_train_accuracy']:.4f} on "
          f"{videos} training videos (threshold {OVERFIT_THRESHOLD}); launches: phase 2 "
          f"{got_train} over {steps} steps (expected {want_train}), evaluation {got_eval} "
          f"(expected {want_eval}); phase {wall:.1f} s [{card}]", flush=True)
    if got_train != want_train or got_eval != want_eval:
        fail("overfit: launch counts differ from the path's")
    if any(eval_launches[name] for name in eval_launches if name not in want_eval):
        fail("overfit: another kernel launched in the evaluation")
    if not res["top1_train_accuracy"] >= OVERFIT_THRESHOLD:
        fail(f"overfit: Top-1 {res['top1_train_accuracy']} < {OVERFIT_THRESHOLD}")
    record = {k: v for k, v in res.items() if k != "logs"}
    record.update(peak_gib=child["peak_gib"], seconds=wall)
    return {"launches": {**got_train, **got_eval}, "record": record}


# ---- phase 12: lane-padded vision heads (models/siglip.pad_attention_heads) ----


def run_pad_heads(dev, card: str) -> dict:
    """Phase 12: kernel A at the padded tower's shape [128, 16, 729, 128]
    (head_dim 72 zero-padded to 128, sm_scale 72**-0.5) against its plain
    version, timed beside A at [128, 16, 729, 72] on the same numbers, each
    with its bound; then VideoITG-8B's tower (26 layers, random bf16 weights)
    on one 128-frame chunk, padded against unpadded, dense and act8: each
    layer on the same input within bf16_tol of its output, and the 26
    layers' features as close as the unpadded tower's kernel path is to its
    plain path (at least E2E_ATOL, relative), A launching 26 times a pass.
    Returns {"launches": A's, "record": the padded kernel's numbers}."""
    import torch
    from torch.nn import functional as F

    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.models import siglip as siglip_mod
    from videoitg_tpu_torch.models.common import linear
    from videoitg_tpu_torch.models.siglip import init_siglip, pad_attention_heads, siglip_features
    from videoitg_tpu_torch.ops.flash_attention_short import (flash_mha_short,
                                                              flash_mha_short_reference)
    from videoitg_tpu_torch.ops.quant import (SIGLIP_LINEAR_KEYS, Act8Switches,
                                              enable_act_quant, quantize_siglip_int8)

    cfg = preset("videoitg-8b").vision
    t, heads, s, d, lane = 128, cfg.num_heads, cfg.num_patches, cfg.head_dim, 128
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(SEED + 130)
    q, k, v = (torch.randn(t, heads, s, d, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    qp, kp, vp = (F.pad(a, (0, lane - d)) for a in (q, k, v))
    parts = [slice(i, i + 32) for i in range(0, t, 32)]
    ref = torch.cat([flash_mha_short_reference(qp[p].float(), kp[p].float(), vp[p].float(),
                                               sm_scale=scale) for p in parts])
    tol = bf16_tol(ref)
    out = flash_mha_short(qp, kp, vp, sm_scale=scale)
    err = max_err(out, ref)
    lanes = out[..., d:].abs().max().item()
    same = torch.equal(out[..., :d], flash_mha_short(q, k, v))
    drop = max(max_err(flash_mha_short_reference(qp[p].float(), kp[p, :, :s - 64].float(),
                                                 vp[p, :, :s - 64].float(), sm_scale=scale),
                       ref[p]) for p in parts)
    ms = cuda_ms(lambda: flash_mha_short(qp, kp, vp, sm_scale=scale), 20)
    ms72 = cuda_ms(lambda: flash_mha_short(q, k, v), 20)
    ms_again = cuda_ms(lambda: flash_mha_short(qp, kp, vp, sm_scale=scale), 20)
    plain_ms = cuda_ms(lambda: [flash_mha_short_reference(qp[p], kp[p], vp[p], sm_scale=scale)
                                for p in parts], 3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qp, kp, vp, scale=scale), 10)
    bnd = bound(4 * s * s * lane * t * heads, PEAK_BF16, 4 * qp.numel() * 2)
    bnd72 = bound(4 * s * s * d * t * heads, PEAK_BF16, 4 * q.numel() * 2)
    print(f"kernel flash_mha_short padded [{t}, {heads}, {s}, {lane}] (head_dim {d}) bf16: "
          f"max_abs_err {err:.6g} (tol {tol:.6g}), padded lanes max {lanes}, first {d} lanes "
          f"bit-equal to A at D = {d}: {same}; broken: last 64 keys dropped {drop:.6g}; "
          f"{ms:.4f} / {ms_again:.4f} ms (before / after D = {d}), plain {plain_ms:.4f} ms, "
          f"library (sdpa) {library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
          f"{bnd['bound_by']}; at D = {d} {ms72:.4f} ms, bound {bnd72['bound_ms']:.4f} ms "
          f"[{card}]", flush=True)
    if not err <= tol or lanes != 0.0:
        fail(f"flash_mha_short padded: error {err} > {tol} or padded lanes {lanes}")
    if not drop > tol:
        fail(f"flash_mha_short padded: tolerance {tol} does not catch dropped keys ({drop})")
    del q, k, v, qp, kp, vp, ref, out

    tower = init_siglip(cfg, torch.Generator(device=dev).manual_seed(SEED + 131), device=dev,
                        dtype=torch.bfloat16)
    x = torch.randn(t, cfg.image_size, cfg.image_size, 3, generator=gen,
                    device=dev).to(torch.bfloat16)
    counted = wrappers()
    launches = 0

    def features(tw, use_flash=True):
        nonlocal launches
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            y = siglip_features(tw, x, cfg, use_flash=use_flash)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in counted.items() if fn.launches}
        if got != ({"flash_mha_short": cfg.num_effective_layers} if use_flash else {}):
            fail(f"pad-heads tower: launches {got}")
        launches += got.get("flash_mha_short", 0)
        if not torch.isfinite(y).all():
            fail("pad-heads tower: features not finite")
        return y, wall

    def layer_by_layer(padded):
        """Each layer of both towers on the unpadded tower's input to it: the
        worst error over bf16_tol of the layer's output (one rounding of the
        same sums apart)."""
        worst = 0.0
        with torch.no_grad():
            h = linear(tower.patch_embed, siglip_mod._patchify(x, cfg.patch_size))
            h = h + tower.pos_embed.to(h.dtype)[None]
            for lu, lp in zip(tower.layers[:cfg.num_effective_layers], padded.layers):
                want = siglip_mod._encoder_layer(lu, h, cfg, True, Act8Switches())
                got = siglip_mod._encoder_layer(lp, h, cfg, True, Act8Switches())
                worst = max(worst, max_err(got, want.float()) / bf16_tol(want.float()))
                h = want
        return worst

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()

    for tier in ("dense", "act8"):
        if tier == "act8":
            enable_act_quant(quantize_siglip_int8(tower), keys=SIGLIP_LINEAR_KEYS)
        padded = pad_attention_heads(tower, cfg)
        per_layer = layer_by_layer(padded)
        features(tower)  # warm
        base, wall = features(tower)
        got, wall_p = features(padded)
        plain, _ = features(tower, use_flash=False)
        diff, noise = rel(got, base), rel(plain, base)
        tol = max(E2E_ATOL, 2 * noise)
        print(f"pad-heads VideoITG-8B tower {tier}, {t} frames: each layer padded vs unpadded on "
              f"the same input, worst error / bf16_tol {per_layer:.4g} (at most 1); the "
              f"{cfg.num_effective_layers} layers' features padded vs unpadded, max |diff| / "
              f"max|features| {diff:.6g} (tol {tol:.6g}: the larger of {E2E_ATOL} and twice the "
              f"unpadded tower's kernel vs plain path, {noise:.6g}); tower {wall:.4f} s "
              f"unpadded, {wall_p:.4f} s padded; A {cfg.num_effective_layers} launches a pass "
              f"[{card}]", flush=True)
        if not per_layer <= 1.0:
            fail(f"pad-heads tower {tier}: a padded layer is {per_layer} bf16_tol off")
        if not diff <= tol:
            fail(f"pad-heads tower {tier}: features {diff} > {tol}")
        del padded, got, base, plain
    del tower
    torch.cuda.empty_cache()
    record = dict(shape=[t, heads, s, lane], head_dim=d, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  library_ms=library_ms, unpadded_ms=ms72, unpadded_bound_ms=bnd72["bound_ms"],
                  **bnd)
    return {"launches": {"flash_mha_short": launches}, "record": record}


def bf16_ulps(out, ref, floor: float = 2.0 ** -8):
    """|out - ref| in units of ref's bf16 spacing (8 significant bits), with
    the spacing of `floor` for |ref| below it: the fp32 terms of a
    normalised value are of order 1, so their rounding order may move a
    result near 0 by more than its own spacing. (max ulps, share of values
    that differ)."""
    import torch

    ref = ref.float()
    diff = (out.float() - ref).abs()
    spacing = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(floor))) - 7)
    return (diff / spacing).max().item(), (diff > 0).float().mean().item()


def check_layer_norm(dev, card: str) -> dict:
    """Phase 14 (`--only layer-norm`): the add + LayerNorm kernel
    (`ops/layer_norm.add_layer_norm`) against its plain version at the
    towers' chunks, SigLIP [93,312, 1152] and CLIP [73,856, 1024], with a
    delta and a bias, a delta alone and neither: r bit-equal, y within 1 bf16
    ulp (`bf16_ulps`), a dropped bias caught; each timed beside its bound
    (bytes) and beside `F.layer_norm` after the two adds (`library_ms`, a
    yardstick the port never calls). Then VideoITG-8B's tower (26 layers,
    random bf16 weights) on one 128-frame chunk, the carried loop (inference
    mode, 52 launches) against the plain loop (gradients on, none), timed in
    turns and held to a limit read from a control in the same run: twice
    the distance of the plain bf16 loop from the same tower in fp32 (plain,
    `use_flash=False`), the most two bf16 loops each as close to fp32 as the
    plain one can differ; a dropped o and fc2 bias must read above it. Then the launches
    of one 512-frame select, bf16 (208) and act8 with the int8 kernels on
    (0). Returns the kernel's record: the SigLIP chunk with a delta and a
    bias at the top, the other forms and shapes under `forms`."""
    import copy

    import numpy as np
    import torch
    from torch.nn import functional as F

    from videoitg_tpu_torch.models import siglip as siglip_mod

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.models.common import Norm
    from videoitg_tpu_torch.models.siglip import init_siglip, siglip_features
    from videoitg_tpu_torch.ops.layer_norm import add_layer_norm, add_layer_norm_reference

    gen = torch.Generator(device=dev).manual_seed(SEED + 140)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen, device=dev)).to(bf16)

    forms = []
    for tag, rows, h, eps in (("siglip", 93312, 1152, 1e-6), ("clip", 73856, 1024, 1e-5)):
        x, delta, bias = randn(rows, h, std=4.0), randn(rows, h), randn(h, std=0.5)
        ln = Norm(h, bias=True, device=dev, dtype=bf16)
        ln.scale.data, ln.bias.data = randn(h, mean=1.0, std=0.1), randn(h, std=0.1)
        for form, d, b in (("delta and bias", delta, bias), ("delta", delta, None),
                           ("no delta", None, None)):
            r, y = add_layer_norm(x, d, b, ln, eps)
            r_ref, y_ref = add_layer_norm_reference(x, d, b, ln, eps)
            ulps, share = bf16_ulps(y, y_ref)
            if not torch.equal(r, r_ref) or not ulps <= 1.0:
                fail(f"add_layer_norm {tag} {form}: r bit-equal {torch.equal(r, r_ref)}, "
                     f"y {ulps} bf16 ulps")
            broken = None
            if b is not None:  # a dropped bias must read as wrong
                broken = bf16_ulps(add_layer_norm(x, d, None, ln, eps)[1], y_ref)[0]
                if not broken > 1.0:
                    fail(f"add_layer_norm {tag}: a dropped bias reads {broken} ulps")
            ms = cuda_ms(lambda: add_layer_norm(x, d, b, ln, eps), 50)
            plain_ms = cuda_ms(lambda: add_layer_norm_reference(x, d, b, ln, eps), 10)
            ms_again = cuda_ms(lambda: add_layer_norm(x, d, b, ln, eps), 50)

            def library():
                a = x if d is None else x + (d if b is None else d + b)
                return F.layer_norm(a, (h,), ln.scale, ln.bias, eps)

            library_ms = cuda_ms(library, 50)
            n_io = 2 if d is None else 4  # rows read and written, each once
            bnd = bound(0.0, PEAK_BF16, n_io * rows * h * 2 + 3 * h * 2)
            print(f"kernel add_layer_norm {tag} [{rows}, {h}] {form}: r bit-equal, y max "
                  f"{ulps:.3g} bf16 ulps ({100 * share:.4f}% of values differ)"
                  + (f", dropped bias {broken:.3g} ulps" if broken is not None else "")
                  + f"; {ms:.4f} / {ms_again:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"(F.layer_norm after the adds) {library_ms:.4f} ms, bound "
                  f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
                  f"({100 * bnd['bound_ms'] / ms:.1f}% of it) [{card}]", flush=True)
            forms.append(dict(tower=tag, shape=[rows, h], form=form, ms=ms, ms_again=ms_again,
                              plain_ms=plain_ms, library_ms=library_ms, max_ulps=ulps,
                              differ_share=share, **bnd))
        del x, delta, bias, r, y, r_ref, y_ref
    torch.cuda.empty_cache()
    main_form = forms[0]  # SigLIP's chunk with a delta and a bias: the tower's main path
    record = dict(name="add_layer_norm", route="cuda",
                  source="videoitg_tpu_torch/csrc/layer_norm.cu", replaces=None,
                  **{k: main_form[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "max_ulps")},
                  forms=forms[1:])

    cfg = preset("videoitg-8b").vision
    tower = init_siglip(cfg, torch.Generator(device=dev).manual_seed(SEED + 141), device=dev,
                        dtype=bf16)
    with torch.no_grad():  # biases and norms away from their init of zeros and ones
        for layer in tower.layers:
            for lin in (layer.o, layer.fc2):
                lin.b.copy_(randn(cfg.hidden_size, std=0.02))
            for ln in (layer.ln1, layer.ln2):
                ln.scale.copy_(randn(cfg.hidden_size, mean=1.0, std=0.1))
                ln.bias.copy_(randn(cfg.hidden_size, std=0.02))
    frames = randn(128, cfg.image_size, cfg.image_size, 3)

    def carried():
        with torch.inference_mode():
            return siglip_features(tower, frames, cfg, use_flash=True)

    def plain():
        with torch.enable_grad():  # no leaf requires a gradient: the plain loop, no graph
            return siglip_features(tower, frames, cfg, use_flash=True)

    add_layer_norm.launches = 0
    got = carried()
    tower_launches = add_layer_norm.launches
    want = plain()
    if add_layer_norm.launches != tower_launches or tower_launches != 2 * cfg.num_effective_layers:
        fail(f"tower chunk: add_layer_norm launched {tower_launches} times carried, "
             f"{add_layer_norm.launches - tower_launches} plain")
    if not torch.isfinite(got).all():
        fail("tower chunk: carried features not finite")

    def rel(a, ref):  # max |a - ref| / max |ref|
        return max_err(a, ref.float()) / ref.float().abs().max().item()

    with torch.no_grad():  # the control: the same tower and frames in fp32, all plain
        want32 = siglip_features(copy.deepcopy(tower).float(), frames.float(), cfg,
                                 use_flash=False)
    real_held = siglip_mod.linear_held_bias
    siglip_mod.linear_held_bias = lambda p, x, act8=None: (real_held(p, x, act8)[0], None)
    try:
        dropped = carried()  # a planted fault: o's and fc2's biases never added
    finally:
        siglip_mod.linear_held_bias = real_held
    control = rel(want, want32)
    diff, limit = rel(got, want), 2 * control
    got_vs32, dropped_diff = rel(got, want32), rel(dropped, want)
    times = [cuda_ms(plain, 3), cuda_ms(carried, 3), cuda_ms(carried, 3), cuda_ms(plain, 3)]
    print(f"VideoITG-8B tower, one 128-frame chunk: plain loop {times[0]:.2f} / {times[3]:.2f} "
          f"ms, carried loop {times[1]:.2f} / {times[2]:.2f} ms, add_layer_norm "
          f"{tower_launches} launches a pass; features max |carried - plain| / max |plain| "
          f"{diff:.4g} (limit {limit:.4g}: twice plain bf16 against fp32, {control:.4g}; "
          f"carried against fp32 {got_vs32:.4g}); dropped o and fc2 biases read "
          f"{dropped_diff:.4g} [{card}]",
          flush=True)
    if not diff <= limit:
        fail(f"tower chunk: carried loop {diff} from the plain loop, above the limit {limit}")
    if not dropped_diff > limit:
        fail(f"tower chunk: the limit {limit} does not catch dropped biases ({dropped_diff})")
    record.update(tower_chunk_plain_ms=[times[0], times[3]],
                  tower_chunk_carried_ms=[times[1], times[2]], tower_chunk_rel_diff=diff,
                  tower_chunk_limit=limit, tower_chunk_plain_vs_fp32=control,
                  tower_chunk_carried_vs_fp32=got_vs32,
                  tower_chunk_dropped_bias=dropped_diff)
    del tower, frames, got, want, want32, dropped
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 142)
    video512, sampled512 = frames_u8(rng, 512), [2 * i for i in range(512)]
    for tier, want_launches in ((None, 8 * cfg.num_effective_layers), ("act8", 0)):
        model, mcfg, tok = load_grounding_components(None, "videoitg-8b", True, bf16, dev,
                                                     seed=SEED, quantize=tier)
        engine = SelectionEngine(model, mcfg, tok, device=dev, dtype=bf16,
                                 qgemm=tier == "act8", fused=tier == "act8")
        engine.select(video512, sampled512, QUESTIONS[0])  # the first request builds and warms
        add_layer_norm.launches = 0
        check_result(engine.select(video512, sampled512, QUESTIONS[1]), sampled512)
        n = add_layer_norm.launches
        print(f"[{tier or 'bf16'}] one 512-frame select: add_layer_norm {n} launches "
              f"(expected {want_launches}) [{card}]", flush=True)
        if n != want_launches:
            fail(f"add_layer_norm launched {n} times in a {tier or 'bf16'} select")
        record[f"launches_{tier or 'bf16'}_select512"] = n
        del model, engine
        torch.cuda.empty_cache()
    record["launches"] = record["launches_bf16_select512"]
    return record


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--train-child"]:
        return train_child(argv[2:] if argv[1:2] == ["--"] else argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["attention-kernels", "int8-kernels", "train-kernels",
                                          "splash-kernels",
                                          "segment-kernels", "vlm",
                                          "serve", "train", "checkpoint", "serving-checkpoint",
                                          "eval", "stage-b", "mesh", "overfit", "pad-heads",
                                          "layer-norm"],
                        default=None,
                        help="build, then only: check kernels A, B (attention-kernels), F-I "
                             "(int8-kernels), C, D, E (train-kernels), K, L (splash-kernels) "
                             "or J (segment-kernels) against their plain versions, with "
                             "ptxas' lines for the TMA + wgmma instances among them; or run "
                             "the daemon phase (serve), "
                             "the training phases (train), the causal-VLM phases (vlm), "
                             "the HF-checkpoint phase (checkpoint), the serving-checkpoint "
                             "phase (serving-checkpoint), eval stage A (eval), "
                             "eval stage B after its stage A (stage-b), the mesh path "
                             "(mesh), the overfit trajectory with a kill and a resume "
                             "(overfit), kernel A on lane-padded tower heads (pad-heads) or "
                             "the add + LayerNorm kernel and the tower's carried loop "
                             "(layer-norm)")
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
    if args.only == "checkpoint":
        run_checkpoints(dev, card)
        print("checkpoint phase passed", flush=True)
        return 0
    if args.only == "serving-checkpoint":
        run_serving_checkpoints(dev, card)
        print("serving-checkpoint phase passed", flush=True)
        return 0
    if args.only == "eval":
        run_eval(dev, card)
        print("eval phase passed", flush=True)
        return 0
    if args.only == "stage-b":
        run_stage_b(dev, card)
        print("stage-B phase passed", flush=True)
        return 0
    if args.only == "mesh":
        run_mesh(dev, card)
        print("mesh phase passed", flush=True)
        return 0
    if args.only == "overfit":
        run_overfit(dev, card)
        print("overfit phase passed", flush=True)
        return 0
    if args.only == "pad-heads":
        run_pad_heads(dev, card)
        print("pad-heads phase passed", flush=True)
        return 0
    if args.only == "layer-norm":
        print(json.dumps(check_layer_norm(dev, card)), flush=True)
        print("layer-norm phase passed", flush=True)
        return 0
    records = check_kernels(dev)
    records.update(check_train_kernels(dev))
    records.update(check_int8_kernels(dev))
    records.update(check_splash_kernels(dev))
    records.update(check_segment_kernels(dev))
    check_agreement(dev)
    launches = run_slices(dev, card)
    torch.cuda.empty_cache()
    for name, n in run_checkpoints(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    for name, n in run_serving_checkpoints(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    for name, n in run_serving(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    launches.update(run_repro_script())
    train_launches = run_training(dev, card)
    launches.update({name: train_launches[name] for name in TRAIN_KERNELS})
    for name, n in run_vlm(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    for name, n in run_eval(dev, card).items():
        launches[name] += n
    torch.cuda.empty_cache()
    stage_b = run_stage_b(dev, card)
    for name, n in stage_b["launches"].items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    mesh = run_mesh(dev, card)
    for name, n in mesh["launches"].items():
        launches[name] = launches.get(name, 0) + n
    for name, extra in mesh["records"].items():
        records[name]["mesh"] = extra
    torch.cuda.empty_cache()
    pad = run_pad_heads(dev, card)
    launches["flash_mha_short"] += pad["launches"]["flash_mha_short"]
    records["flash_mha_short"]["padded"] = pad["record"]
    overfit = run_overfit(dev, card)
    for name, n in overfit["launches"].items():
        launches[name] = launches.get(name, 0) + n
        records[name]["overfit_launches"] = n
    records["flash_train_fwd"]["overfit"] = overfit["record"]
    records["add_layer_norm"] = check_layer_norm(dev, card)
    launches["add_layer_norm"] = records["add_layer_norm"]["launches"]
    m1 = stage_b["act8_gemm_m1"]
    records["act8_gemm"].update(
        decode_m1=dict(per="the 7 launches of one LM layer at M = 1 (one decoded token)",
                       ms=m1["m1_ms"], plain_ms=m1["m1_plain_ms"], bound_ms=m1["m1_bound_ms"],
                       int_mm_ms=m1["m1_int_mm_ms"], max_abs_err=m1["worst"],
                       prefill_m=m1["prefill_m"]))
    records["act8_gemm"]["max_abs_err"] = max(records["act8_gemm"]["max_abs_err"], m1["worst"])
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
