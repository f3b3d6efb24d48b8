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


def load_grounding_components(model: str | None, preset_name: str, random_init: bool,
                              dtype: torch.dtype, device: torch.device, seed: int = 0,
                              quantize: str | None = None, tool: str = "videoitg-torch"):
    """(model, cfg, tokenizer) from an HF-format checkpoint directory (its
    tokenizer through transformers' AutoTokenizer) or a random-init preset,
    with the optional serving quantisation tier ('int8', 'int4', 'act8')
    applied in place. Pre-quantised serving checkpoints are refused (ROADMAP
    queue 1, item 4)."""
    if model:
        from videoitg_tpu_torch.checkpoint import is_serving_checkpoint, load_grounding_model

        if is_serving_checkpoint(model):
            raise SystemExit(
                f"error: {tool}: --model {model} is a serving checkpoint (serving_config.json); "
                "serving checkpoints are not ported to PyTorch yet (ROADMAP queue 1, item 4)")
        from transformers import AutoTokenizer

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
