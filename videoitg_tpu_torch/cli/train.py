"""Grounding finetune / VLM SFT on VideoITG-format data, on the PyTorch port.

Counterpart of videoitg_tpu/cli/train.py: AdamW with per-group learning rates
(out_proj 10x), cosine + warmup, a frozen vision tower, rematerialised decoder
layers, checkpoints with auto-resume. Full finetune, `--lora RANK` and QLoRA
(`--lora RANK --quantize-base int8|int4`).

--objective grounding (default): BCE frame-relevance loss on
  {"video", "question", "clip_num"} records.
--objective vlm: next-token CE over assistant spans on
  {"video" | "image", "conversations"} records, plain or ChatML template
  (`--conv-template`; `--fps -1` draws the rate per video). The LM is the
  preset's causal variant: with `--model` the checkpoint's weights (its
  `lm_head` when the preset is untied), with `--random-init` tied
  embeddings.

`--model DIR` finetunes an HF-format VideoITG checkpoint (safetensors or
.bin); the tokenizer comes from `--tokenizer`, else from DIR, through
transformers' AutoTokenizer. The grounding objective reads the checkpoint's
videoitg_tpu_config.json; `--objective vlm` the preset's causal variant.

It runs on the card; `--cpu` asks for the CPU. With neither a CUDA device
nor `--cpu` it stops with an error.

Smoke run (random weights, synthetic-capable):
  python -m videoitg_tpu_torch.cli.train --preset tiny --random-init \\
      --data-path data.json --image-folder vids/ --total-steps 20 --cpu

Flags of the JAX CLI that are refused here, with the ROADMAP item that
covers them: `--dp/--tp/--sp/--pp` above 1 (multi-device).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("videoitg-torch-train", description=__doc__)
    # model
    p.add_argument("--model", help="HF-format checkpoint dir to finetune")
    p.add_argument("--preset", default="videoitg-8b")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--tokenizer", help="tokenizer path (defaults to --model)")
    p.add_argument("--objective", default="grounding", choices=["grounding", "vlm"])
    p.add_argument("--conv-template", default="plain", choices=["plain", "chatml"],
                   help="vlm objective: conversation template")
    # data (reference flag names)
    p.add_argument("--data-path", required=True)
    p.add_argument("--image-folder", required=True)
    p.add_argument("--video-frames", type=int, default=1024)
    p.add_argument("--fps", type=float, default=1.0)
    p.add_argument("--pix-fmt", default="rgb", choices=["rgb", "yuv420"],
                   help="yuv420: decode to native YUV planes (half the host "
                        "bytes) and convert on the device")
    p.add_argument("--feature-cache", default=None, metavar="DIR",
                   help="cache frozen-tower features here; cache hits skip "
                        "decode + preprocess + tower (the tower is frozen in "
                        "every released recipe)")
    p.add_argument("--feature-cache-dtype", default="bf16", choices=["bf16", "int8"],
                   help="feature storage: bf16 (exact vs bf16 training) "
                        "or int8 (4x smaller, ~0.4%% feature error)")
    p.add_argument("--precompute-features", action="store_true",
                   help="fill --feature-cache over the whole dataset, then exit (no training)")
    p.add_argument("--vision-token-num", type=int, default=None,
                   help="seq_mlp total vision-token budget override (the "
                        "grounding recipe uses 16384)")
    p.add_argument("--vision-min-num", type=int, default=None,
                   help="lower bound of the training-time random hw draw")
    # optimization (reference defaults)
    p.add_argument("--learning-rate", type=float, default=2e-5)
    p.add_argument("--out-proj-lr", type=float, default=2e-4)
    p.add_argument("--mm-projector-lr", type=float, default=None)
    p.add_argument("--tune-projector-only", action="store_true",
                   help="stage-1 adapter pretrain: train only the projector")
    p.add_argument("--lora", type=int, default=0, metavar="RANK",
                   help="train LoRA adapters of this rank (+ the scoring "
                        "head) instead of full weights")
    p.add_argument("--lora-alpha", type=float, default=32.0)
    p.add_argument("--quantize-base", choices=["int8", "int4"], default=None,
                   help="with --lora: freeze the LM base in this quantized form (QLoRA)")
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--warmup-ratio", type=float, default=0.05)
    p.add_argument("--lr-scheduler-type", default="cosine")
    p.add_argument("--num-train-epochs", type=int, default=1)
    p.add_argument("--total-steps", type=int, default=None,
                   help="override steps (else epochs * len(data) / batch)")
    p.add_argument("--per-device-train-batch-size", type=int, default=1)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    # infra
    p.add_argument("--output-dir", default="./checkpoints-itg")
    p.add_argument("--report-to", default="jsonl", help="jsonl | jsonl,wandb | none")
    p.add_argument("--run-name", default=None)
    p.add_argument("--save-steps", type=int, default=500)
    p.add_argument("--save-total-limit", type=int, default=2)
    p.add_argument("--async-save", action="store_true",
                   help="accepted; checkpoints are written synchronously")
    p.add_argument("--logging-steps", type=int, default=1)
    p.add_argument("--dp", type=int, default=None, help="above 1: not ported yet")
    p.add_argument("--tp", type=int, default=None, help="above 1: not ported yet")
    p.add_argument("--sp", type=int, default=1, help="above 1: not ported yet")
    p.add_argument("--pp", type=int, default=1, help="above 1: not ported yet")
    p.add_argument("--pp-microbatches", type=int, default=None)
    p.add_argument("--offload-optimizer", action="store_true",
                   help="park optimizer state in pinned host memory between "
                        "steps (on a CUDA device; ignored on the CPU)")
    p.add_argument("--dtype", default=None, choices=[None, "bfloat16", "float32"],
                   help="default: bfloat16 on the card, float32 on the CPU")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--seed", type=int, default=42)
    return p


def _refusal(args) -> str | None:
    """The message for a flag of the JAX CLI that the port does not run."""
    if any(n is not None and n > 1 for n in (args.dp, args.tp, args.sp, args.pp)):
        return "--dp / --tp / --sp / --pp above 1 (multi-device; ROADMAP queue 1, item 8)"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refused = _refusal(args)
    if refused:
        print(f"error: videoitg-torch-train: {refused} is not ported to PyTorch yet",
              file=sys.stderr)
        return 2
    import torch

    from videoitg_tpu_torch.cli._model_loading import resolve_device

    try:
        device = resolve_device(args.cpu, "videoitg-torch-train", "--cpu")
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    on_cpu = device.type == "cpu"
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        args.dtype or ("float32" if on_cpu else "bfloat16")]

    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.models.grounding import init_grounding
    from videoitg_tpu_torch.train.checkpointing import TrainCheckpointer
    from videoitg_tpu_torch.train.collate import collate_grounding
    from videoitg_tpu_torch.train.dataset import GroundingDataset, make_batches, prefetch_batches
    from videoitg_tpu_torch.train.optimizer import make_grounding_optimizer
    from videoitg_tpu_torch.train.train_step import create_train_state, make_train_step, run_step
    from videoitg_tpu_torch.utils.common import CharTokenizer
    from videoitg_tpu_torch.utils.metrics_logger import MetricsLogger

    # ---- model + tokenizer ----
    def causal_variant(c, tie=None):
        # tie=True only for random init, which has no lm_head to load; a
        # checkpoint keeps the preset's setting (Qwen2-7B is untied, and
        # forcing a tie would drop its lm_head).
        lm = dataclasses.replace(c.lm, causal=True)
        if tie is not None:
            lm = dataclasses.replace(lm, tie_word_embeddings=tie)
        return dataclasses.replace(c, lm=lm)

    if args.model:
        from transformers import AutoTokenizer

        if args.objective == "vlm":
            from videoitg_tpu_torch.checkpoint import convert_vlm_checkpoint, load_hf_state_dict

            cfg = causal_variant(preset(args.preset))
            model = convert_vlm_checkpoint(load_hf_state_dict(args.model), cfg, device=device,
                                           dtype=dtype)
        else:
            from videoitg_tpu_torch.checkpoint import load_grounding_model

            model, cfg = load_grounding_model(args.model, device=device, dtype=dtype)
        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer or args.model)
    elif args.random_init:
        cfg = preset(args.preset)
        if args.objective == "vlm":
            cfg = causal_variant(cfg, tie=True)
        model = init_grounding(cfg, torch.Generator(device=device).manual_seed(args.seed),
                               device=device, dtype=dtype)
        tokenizer = CharTokenizer(cfg.lm.vocab_size)
    else:
        print("error: pass --model or --random-init", file=sys.stderr)
        return 2

    if args.vision_token_num is not None or args.vision_min_num is not None:
        # Training projector-budget overrides, copied into the config so that
        # it keeps describing the run.
        proj = cfg.projector
        if args.vision_token_num is not None:
            proj = dataclasses.replace(proj, vision_token_num=args.vision_token_num)
        if args.vision_min_num is not None:
            proj = dataclasses.replace(proj, vision_min_num=args.vision_min_num)
        cfg = dataclasses.replace(cfg, projector=proj)

    # ---- data ----
    if args.objective == "vlm":
        from videoitg_tpu_torch.train.vlm_sft import (VLMDataset, collate_vlm,
                                                      make_vlm_train_step)

        dataset = VLMDataset(
            args.data_path, args.image_folder, tokenizer, cfg, template=args.conv_template,
            video_frames=args.video_frames, fps=args.fps, seed=args.seed)
    else:
        dataset = GroundingDataset(
            args.data_path, args.image_folder, tokenizer, cfg,
            video_frames=args.video_frames, fps=args.fps, seed=args.seed, pix_fmt=args.pix_fmt)
    if args.quantize_base and not args.lora:
        print("error: --quantize-base requires --lora (a quantized base "
              "cannot be trained directly; QLoRA trains adapters over it)", file=sys.stderr)
        return 2
    if args.lora:
        # LoRA / QLoRA: the base stays frozen (and, quantised, bit-identical);
        # the adapters and the scoring head train.
        from videoitg_tpu_torch.train.lora import add_lora

        if args.quantize_base == "int8":
            from videoitg_tpu_torch.ops.quant import quantize_grounding_int8

            quantize_grounding_int8(model)
        elif args.quantize_base == "int4":
            from videoitg_tpu_torch.ops.quant import quantize_qwen2_int4

            quantize_qwen2_int4(model.lm)
        add_lora(model, torch.Generator(device=device).manual_seed(args.seed + 1),
                 rank=args.lora, alpha=args.lora_alpha)

    if args.feature_cache:
        if args.objective != "grounding":
            print("error: --feature-cache supports the grounding objective "
                  "only (the VLM SFT tower also trains on image samples)", file=sys.stderr)
            return 2
        from videoitg_tpu_torch.train.feature_cache import CachedFeatureDataset, FeatureCache

        cache = FeatureCache(args.feature_cache, store_dtype=args.feature_cache_dtype)
        dataset = CachedFeatureDataset(dataset, cache, model, cfg, use_flash=not on_cpu)
        if args.precompute_features:
            t0 = time.time()
            for i in range(len(dataset)):
                dataset[i]
                if (i + 1) % 10 == 0 or i + 1 == len(dataset):
                    print(f"[feature-cache] {i + 1}/{len(dataset)} "
                          f"({cache.stats()}, {time.time() - t0:.0f}s)")
            print(f"[feature-cache] done: {cache.stats()} in {args.feature_cache}")
            return 0

    batch_size = args.per_device_train_batch_size
    total_steps = args.total_steps or max(
        1, args.num_train_epochs * len(dataset) // batch_size)

    # ---- optimizer / state ----
    if args.lora:
        from videoitg_tpu_torch.train.lora import make_lora_optimizer

        tx = make_lora_optimizer(
            model,
            learning_rate=args.learning_rate,
            out_proj_lr=args.out_proj_lr,
            total_steps=total_steps,
            warmup_ratio=args.warmup_ratio,
            schedule=args.lr_scheduler_type,
            weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
            accum_steps=args.gradient_accumulation_steps,
        )
    else:
        tx = make_grounding_optimizer(
            model,
            learning_rate=args.learning_rate,
            out_proj_lr=args.out_proj_lr,
            projector_lr=args.mm_projector_lr,
            weight_decay=args.weight_decay,
            total_steps=total_steps,
            warmup_ratio=args.warmup_ratio,
            schedule=args.lr_scheduler_type,
            max_grad_norm=args.max_grad_norm,
            accum_steps=args.gradient_accumulation_steps,
            tune_projector_only=args.tune_projector_only,
        )
    state = create_train_state(model, tx)

    offload = False
    if args.offload_optimizer:
        from videoitg_tpu_torch.train.offload import (make_offloaded_train_step,
                                                      supports_host_offload)

        offload = supports_host_offload(device)
        if not offload:
            print("[train] host offload unsupported on this backend; ignoring")

    mlog = MetricsLogger(args.output_dir, report_to=args.report_to,
                         run_name=args.run_name, config=vars(args))
    ckpt = TrainCheckpointer(args.output_dir, max_to_keep=args.save_total_limit,
                             save_interval=args.save_steps, async_save=args.async_save)
    resume_step, restored = ckpt.restore_latest(state)
    if restored is not None:
        state = restored
        print(f"[train] auto-resumed from step {resume_step}")

    step_fns = {}
    start = int(state.step)
    step = last_logged = start
    t_window = time.time()
    # Decode-ahead: a producer thread keeps 2 batches of decoded frames ready
    # (the libav reader releases the GIL, so decode overlaps the device step).
    for t_bucket, hw, samples in prefetch_batches(
            make_batches(dataset, batch_size, cfg, epochs=args.num_train_epochs,
                         seed=args.seed)):
        if step >= total_steps:
            break
        collate, make_step = ((collate_vlm, make_vlm_train_step) if args.objective == "vlm"
                              else (collate_grounding, make_train_step))
        batch = collate(samples, t_bucket, cfg, dtype=dtype, device=device)
        if hw not in step_fns:  # eager PyTorch: only hw is baked into a step function
            fn = make_step(cfg, tx, hw=hw, use_flash=not on_cpu, remat=True, donate=True)
            step_fns[hw] = make_offloaded_train_step(fn) if offload else fn
        state, metrics = run_step(step_fns[hw], state, batch)
        step = int(state.step)
        if step % args.logging_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}
            mlog.log(step, m)
            extras = " ".join(f"{k}={v:.3f}" for k, v in m.items()
                              if k not in ("loss", "grad_norm"))
            # Windowed step time, since the last log line.
            now = time.time()
            s_per_step = (now - t_window) / max(1, step - last_logged)
            t_window, last_logged = now, step
            # grad_norm is the norm over the leaves that train (gradients exist
            # only for those); the JAX package's is over the whole tree.
            print(f"[train] step {step}/{total_steps} "
                  f"loss={m['loss']:.4f} trained_grad_norm={m['grad_norm']:.3f} "
                  f"{extras} "
                  f"({s_per_step:.1f}s/step)")
        ckpt.maybe_save(step, state)

    ckpt.maybe_save(step, state, force=True)
    ckpt.close()
    mlog.close()
    print(f"[train] done at step {step}; checkpoints in {ckpt.directory}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
