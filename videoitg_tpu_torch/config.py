"""Unified configuration for videoitg_tpu_torch (the port's own copy of
videoitg_tpu/config.py; the tests hold every preset equal field by field).

Unified configuration.

The reference carries three config systems (HF dataclass args copied into
model.config for training, --model_args k=v strings for eval, YAML for
tasks; see its train_itg.py:133-201 and lmms_eval/utils.py:117). Here a
single set of frozen dataclasses describes the model; they serialize to/from
JSON so checkpoints are self-describing, and every entry point shares them.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class VisionConfig:
    """SigLIP-style ViT vision tower.

    Defaults describe google/siglip-so400m-patch14-384, the tower used by
    VideoITG-8B (reference eagle/model/multimodal_encoder/clip_encoder.py:115).
    """

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    # Index into [embeddings, layer1, ..., layerN] hidden states; -2 selects
    # the output of the second-to-last layer (reference
    # clip_encoder.py:123-129, mm_vision_select_layer=-2), so with -2 only
    # num_layers-1 transformer layers are evaluated and the final
    # post-layernorm is skipped.
    select_layer: int = -2
    # "siglip" (no CLS, gelu_tanh, conv bias) or "clip" (CLS token,
    # quick_gelu, pre-layernorm, biasless conv) — the two towers the
    # reference's clip_encoder.py supports.
    arch: str = "siglip"
    # CLIP-only: "patch" drops the CLS position from the output (reference
    # clip_encoder.py:41-44); "cls_patch" keeps it.
    select_feature: str = "patch"

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_effective_layers(self) -> int:
        """How many transformer layers actually run given select_layer."""
        if self.select_layer < 0:
            return self.num_layers + 1 + self.select_layer
        return self.select_layer


@dataclass(frozen=True)
class LMConfig:
    """Qwen2-style decoder LM.

    Defaults describe Qwen2-7B, the LM inside VideoITG-8B
    (reference eagle/model/language_model/grounding_qwen2.py).
    """

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = False
    # Qwen2 uses q/k/v biases; Llama-family decoders do not (the reference's
    # eagle_llama.py variant). Everything else is shared.
    qkv_bias: bool = True
    # Bidirectional (non-causal) attention is the defining trait of the
    # grounding LM (reference grounding_qwen2.py:45-48 sets is_causal=False
    # in every layer). The causal VLM variant flips this on.
    causal: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class ProjectorConfig:
    """seq_mlp projector: adaptive spatial pool + 2-layer MLP.

    Parity: eagle/model/multimodal_projector/mlp_proj.py. Given [T, P, C]
    vision features, frames are bilinearly pooled from sqrt(P)^2 to HW^2
    tokens where HW = floor(sqrt(vision_token_num / T)), then projected
    1152 -> 3584 with a Linear/GELU/Linear stack.
    """

    input_dim: int = 1152
    output_dim: int = 3584
    # Projector family (the reference's multimodal_projector factory, its lines 48-69):
    # "seq_mlp" (the VideoITG projector: budget pooling + 2-layer MLP),
    # "linear", "mlp{N}x_gelu" (e.g. mlp2x_gelu, LLaVA's default), "identity".
    projector_type: str = "seq_mlp"
    # Total vision-token budget across all frames of one video. The released
    # grounding checkpoint trains with 16384
    # (reference scripts/videoitg/finetune-qwen2-7b-grounding.sh:29).
    vision_token_num: int = 16384
    # Lower bound of the training-time random HW draw
    # (reference mlp_proj.py:52, vision_min_num=1 in the grounding recipe).
    vision_min_num: int = 1

    def tokens_hw(self, num_frames: int, ori_hw: int) -> int:
        """Inference-time HW for a video of `num_frames` frames.

        Parity: mlp_proj.py:48-54 — floor(sqrt(budget / T)) clamped to the
        native grid size.
        """
        hw = math.floor(math.sqrt(self.vision_token_num / num_frames))
        return min(hw, ori_hw)


@dataclass(frozen=True)
class GroundingConfig:
    """Full VideoITG grounding-model config (vision + projector + LM + head)."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    lm: LMConfig = field(default_factory=LMConfig)
    # Max text tokens (the instruction prompt) in the packed sequence.
    max_text_len: int = 256
    # BCE positive-class weight cap (reference grounding_qwen2.py:167).
    max_pos_weight: float = 5.0

    # ---- serialization ----

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "GroundingConfig":
        raw: Dict[str, Any] = json.loads(text)
        return cls(
            vision=VisionConfig(**raw["vision"]),
            projector=ProjectorConfig(**raw["projector"]),
            lm=LMConfig(**raw["lm"]),
            **{k: v for k, v in raw.items() if k not in ("vision", "projector", "lm")},
        )

    # ---- presets ----

    @classmethod
    def videoitg_8b(cls) -> "GroundingConfig":
        """The released nvidia/VideoITG-8B architecture."""
        return cls()

    @classmethod
    def videoitg_2b(cls) -> "GroundingConfig":
        """Same architecture with a Qwen2-1.5B-shaped LM (+ full SigLIP).

        ~2B params: fits a single v5e chip in bf16 — the single-chip entry
        point and a practical low-latency serving tier; the 8B flagship runs
        sharded (tp) or int8 (ops/quant.py) on one chip.
        """
        return cls(
            lm=LMConfig(
                vocab_size=151_936,
                hidden_size=1536,
                intermediate_size=8960,
                num_layers=28,
                num_heads=12,
                num_kv_heads=2,
                head_dim=128,
                tie_word_embeddings=True,
                causal=False,
            ),
            projector=ProjectorConfig(input_dim=1152, output_dim=1536),
        )

    @classmethod
    def videoitg_8b_shallow(
        cls,
        lm_layers: int = 2,
        vision_layers: int = 3,
        vocab_size: int = 8192,
        vision_token_num: int = 16384,
        max_text_len: int = 32,
    ) -> "GroundingConfig":
        """Flagship widths and head geometry with few layers.

        Every width the converter and engine must survive is the released
        checkpoint's (hidden 3584, GQA 28q/4kv, head_dim 128, vision
        1152/16h, 27x27 patch grid, seq_mlp budget 16384) but layer counts
        are cut so the whole model meets a torch oracle on CPU — the parity
        selftest geometry (scripts/parity_vs_torch.py --selftest-geometry 8b).
        Vocab is shrunk: the embedding is a gather, not a geometry risk.
        """
        base = cls.videoitg_8b()
        return cls(
            vision=dataclasses.replace(base.vision, num_layers=vision_layers),
            projector=dataclasses.replace(
                base.projector, vision_token_num=vision_token_num),
            lm=dataclasses.replace(
                base.lm, num_layers=lm_layers, vocab_size=vocab_size),
            max_text_len=max_text_len,
        )

    @classmethod
    def dryrun(cls) -> "GroundingConfig":
        """Structure-preserving miniature for multi-chip dryruns: every
        sharded axis divisible by tp=4, trivial FLOPs, full real pipeline."""
        return cls(
            vision=VisionConfig(
                hidden_size=256, intermediate_size=512, num_layers=3,
                num_heads=8, image_size=56, patch_size=14, select_layer=-2,
            ),
            projector=ProjectorConfig(
                input_dim=256, output_dim=512, vision_token_num=64, vision_min_num=1
            ),
            lm=LMConfig(
                vocab_size=2048, hidden_size=512, intermediate_size=1024,
                num_layers=4, num_heads=8, num_kv_heads=4, head_dim=64,
                causal=False,
            ),
            max_text_len=16,
        )

    @classmethod
    def dryrun_serve(cls) -> "GroundingConfig":
        """Head-count-honest serving miniature: the REAL VideoITG-8B head
        counts (LM 28 q / 4 kv, vision 16) with tiny head_dim, so tp
        divisibility, GQA grouping, and attention layouts are exactly the
        flagship's while FLOPs stay dryrun-sized."""
        return cls(
            vision=VisionConfig(
                hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=16, image_size=56, patch_size=14, select_layer=-2,
            ),
            projector=ProjectorConfig(
                input_dim=128, output_dim=224, vision_token_num=64, vision_min_num=1
            ),
            lm=LMConfig(
                vocab_size=2048, hidden_size=224, intermediate_size=448,
                num_layers=2, num_heads=28, num_kv_heads=4, head_dim=8,
                causal=False,
            ),
            max_text_len=16,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "GroundingConfig":
        """A CPU-testable miniature with the same structure.

        Keeps the real patch grid small (image 28, patch 14 -> 2x2=4 patches)
        so token splicing, pooling, and masking logic run identical code paths.
        """
        return cls(
            vision=VisionConfig(
                hidden_size=32,
                intermediate_size=64,
                num_layers=3,
                num_heads=4,
                image_size=56,
                patch_size=14,
                select_layer=-2,
            ),
            projector=ProjectorConfig(
                input_dim=32, output_dim=48, vision_token_num=64, vision_min_num=1
            ),
            lm=LMConfig(
                vocab_size=vocab_size,
                hidden_size=48,
                intermediate_size=96,
                num_layers=2,
                num_heads=4,
                num_kv_heads=2,
                head_dim=12,
                causal=False,
            ),
            max_text_len=32,
        )


def preset(name: str) -> GroundingConfig:
    """Look up a named model preset."""
    presets = {
        "videoitg-8b": GroundingConfig.videoitg_8b,
        "videoitg-2b": GroundingConfig.videoitg_2b,
        "videoitg-8b-shallow": GroundingConfig.videoitg_8b_shallow,
        "dryrun": GroundingConfig.dryrun,
        "dryrun-serve": GroundingConfig.dryrun_serve,
        "tiny": GroundingConfig.tiny,
    }
    if name not in presets:
        raise ValueError(f"unknown preset {name!r}; have {sorted(presets)}")
    return presets[name]()
