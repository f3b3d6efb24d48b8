"""Single-video Top-K frame selection on the PyTorch port.

Counterpart of videoitg_tpu/cli/select.py: sample frames with the infer-path
rounding, score them against the prompt, print the Top-K original frame
indices in ascending order (or the full results.jsonl-style record with
--json).

Examples:
  python -m videoitg_tpu_torch.cli.select --model ckpt/ \\
      --video clip.mp4 --prompt "Which scene shows the rocket launch?"
  python -m videoitg_tpu_torch.cli.select --preset tiny --random-init \\
      --video clip.mp4 --prompt "Which scene shows the rocket launch?" --device cpu

--model DIR reads an HF-format VideoITG checkpoint (safetensors or .bin,
videoitg_tpu_config.json, a tokenizer for transformers' AutoTokenizer), or a
serving checkpoint that --export-serving wrote.

--export-serving DIR, after loading and --quantize, writes a serving
checkpoint (checkpoint.save_serving_checkpoint: the quantised weights, the
config and the tokenizer); later runs pass it as --model and skip the HF
convert and the quantisation pass.

--quantize int8 | int4 | act8 applies a serving tier (ops/quant.py). Under
act8, VIDEOITG_QGEMM=1 and VIDEOITG_FUSED=1 send the int8 products of the LM
and of the vision tower through the hand-written kernels (GPU only; both off
by default, as in the JAX package).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("videoitg-torch-select", description=__doc__)
    p.add_argument("--model", help="HF-format VideoITG checkpoint directory, or a serving "
                                    "checkpoint (--export-serving)")
    p.add_argument("--preset", default="videoitg-8b", help="model preset name")
    p.add_argument("--random-init", action="store_true",
                   help="random weights from --seed (no checkpoint needed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--video", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--topk", type=int, default=32)
    p.add_argument("--num-frames", type=int, default=512)
    p.add_argument("--target-fps", type=float, default=2.0)
    p.add_argument("--sampling", choices=["infer", "eval"], default="infer")
    p.add_argument("--save-frames", metavar="DIR",
                   help="save selected frames as JPEGs to DIR")
    p.add_argument("--json", action="store_true",
                   help="print the full results.jsonl-style record")
    p.add_argument("--device", default=None, choices=[None, "cuda", "cpu"],
                   help="default: cuda; without a CUDA device this is an error "
                        "unless --device cpu (or --cpu) is given")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (= --device cpu)")
    p.add_argument("--dtype", default=None, choices=[None, "bfloat16", "float32"],
                   help="default: bfloat16 on cuda, float32 on cpu")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int4", "act8"],
                   help="serving quantization of the LM: int8 / int4 weights, "
                        "act8 = int8 weights + dynamic int8 activations (LM + vision)")
    p.add_argument("--export-serving", metavar="DIR",
                   help="after loading (+ --quantize), persist a ready-to-serve checkpoint "
                        "(pre-quantised weights + config + tokenizer); later runs pass it "
                        "as --model and skip the HF convert and the quantisation pass")
    p.add_argument("--transfer", default="rgb", choices=["rgb", "yuv420"],
                   help="yuv420: ship the decoder's native YUV planes (half the "
                        "host-to-device bytes) and convert on the device")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from videoitg_tpu_torch.cli._model_loading import load_grounding_components, resolve_device
    from videoitg_tpu_torch.engine import SelectionEngine

    try:
        device = resolve_device(args.cpu or args.device == "cpu", "videoitg-torch-select",
                                "--cpu or --device cpu")
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        args.dtype or ("bfloat16" if device.type == "cuda" else "float32")]
    try:
        params, cfg, tokenizer = load_grounding_components(
            args.model, args.preset, args.random_init, dtype, device, seed=args.seed,
            quantize=args.quantize, tool="videoitg-torch-select")
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    if args.export_serving:
        from videoitg_tpu_torch.checkpoint import save_serving_checkpoint

        out = save_serving_checkpoint(params, cfg, args.export_serving, quantize=args.quantize,
                                      tokenizer_dir=args.model if args.model else None)
        print(f"[videoitg-torch-select] serving checkpoint written to {out}", file=sys.stderr)
    engine = SelectionEngine(params, cfg, tokenizer, device=device, dtype=dtype,
                             num_frames=args.num_frames, target_fps=args.target_fps,
                             transfer=args.transfer)
    result = engine.select_from_file(args.video, args.prompt, sampling=args.sampling)
    selected = result.topk(args.topk)
    if args.json:
        print(json.dumps(result.to_reference_json(), ensure_ascii=False))
    else:
        print(selected)
    if args.save_frames:
        save_frames(args.video, selected, args.save_frames)
        print(f"saved {len(selected)} frames to {args.save_frames}", file=sys.stderr)
    return 0


def save_frames(video: str, selected, out_dir: str) -> None:
    """Write each selected frame as `frame_{i:03d}_idx{frame_idx}.jpg`, the
    JAX CLI's names, in the order of `selected`."""
    from PIL import Image

    from videoitg_tpu_torch.data.video import VideoReader

    os.makedirs(out_dir, exist_ok=True)
    with VideoReader(video) as vr:
        for i, frame_idx in enumerate(selected):
            Image.fromarray(vr[frame_idx]).save(
                os.path.join(out_dir, f"frame_{i:03d}_idx{frame_idx}.jpg"), "JPEG")


if __name__ == "__main__":
    sys.exit(main())
