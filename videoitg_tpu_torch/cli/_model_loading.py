"""Model/tokenizer resolution for the port's CLIs (counterpart of
videoitg_tpu/cli/_model_loading.py)."""

from __future__ import annotations

import sys

import torch


def resolve_device(cpu_requested: bool, tool: str, cpu_flag: str) -> torch.device:
    """The card, unless the caller asked for the CPU. With no CUDA device and
    no such request this raises SystemExit with a message: an entry point
    never carries on on the CPU by itself."""
    if cpu_requested:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(
            f"error: {tool}: no CUDA device found (torch.cuda.is_available() is False); "
            f"pass {cpu_flag} to run on the CPU")
    return torch.device("cuda")


def adapter_device(device, tool: str) -> torch.device:
    """An eval adapter's `device=` argument: None or a CUDA device is the
    card, and no card is an error (SystemExit); any other device (the CPU)
    is taken as asked."""
    if device is None or torch.device(device).type == "cuda":
        resolve_device(False, tool, "device=cpu")
        return torch.device(device or "cuda")
    return torch.device(device)


def load_grounding_components(model: str | None, preset_name: str, random_init: bool,
                              dtype: torch.dtype, device: torch.device, seed: int = 0,
                              quantize: str | None = None, tool: str = "videoitg-torch"):
    """(model, cfg, tokenizer) from a checkpoint directory (its tokenizer
    through transformers' AutoTokenizer) or a random-init preset, with the
    optional serving quantisation tier ('int8', 'int4', 'act8') applied in
    place. The directory is HF-format, or a serving checkpoint
    (`checkpoint.save_serving_checkpoint`), which loads already quantised in
    the tier it was saved with: asking for another tier is an error."""
    if model:
        from transformers import AutoTokenizer

        from videoitg_tpu_torch.checkpoint import (is_serving_checkpoint, load_grounding_model,
                                                   load_serving_checkpoint)

        if is_serving_checkpoint(model):
            # Pre-quantised: skip the HF convert and the quantisation pass.
            try:
                params, cfg, saved_tier = load_serving_checkpoint(model, device=device)
            except (FileNotFoundError, ValueError) as e:
                raise SystemExit(f"error: {tool}: {e}") from e
            if quantize and quantize != saved_tier:
                raise SystemExit(
                    f"error: serving checkpoint was saved with "
                    f"quantize={saved_tier!r}; requested {quantize!r}")
            quantize = None  # already applied at save time
        else:
            params, cfg = load_grounding_model(model, device=device, dtype=dtype)
        tokenizer = AutoTokenizer.from_pretrained(model)
    elif random_init:
        from videoitg_tpu_torch.config import preset as get_preset
        from videoitg_tpu_torch.models.grounding import init_grounding
        from videoitg_tpu_torch.utils.common import CharTokenizer

        cfg = get_preset(preset_name)
        generator = torch.Generator(device=device).manual_seed(seed)
        params = init_grounding(cfg, generator, device=device, dtype=dtype)
        tokenizer = CharTokenizer(cfg.lm.vocab_size)
        print(f"[{tool}] WARNING: random weights — scores are noise", file=sys.stderr)
    else:
        raise SystemExit(f"error: {tool}: pass --model DIR or --random-init")
    if quantize:
        from videoitg_tpu_torch.ops.quant import apply_quantization_tier

        params = apply_quantization_tier(params, quantize)
    return params, cfg, tokenizer
