"""Native downstream answering: the port's own causal VLM on selected frames.

Counterpart of videoitg_tpu/eval/adapters/native_vlm.py on the port's
models/vlm.py. The reference's downstream wrappers drive external
checkpoints; this adapter runs an Eagle-format causal VLM (e.g. the
Eagle-family Qwen2 checkpoints of the reference's eagle_qwen2.py) on the
frames stage A selected, through the same frame_indices_jsonl contract
(`FrameSelectionConsumer`). ChatML prompt per the reference conv_qwen
template.

Every constructor argument of the JAX adapter keeps its meaning. `device`
(None = the card; a missing card is an error unless device="cpu") stands in
for jax's default backend, and the inference kernels (A in the tower, B
causal in the prefill) serve exactly when it is a CUDA device. Under
`quantize=act8`, VIDEOITG_QGEMM=1 / VIDEOITG_FUSED=1 (read once, here) send
the int8 products through kernels F (the LM, prefill and every decoded
token) and G, H, I (the tower), as in the engine.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from videoitg_tpu_torch.constants import (DEFAULT_IMAGE_TOKEN, IGNORE_INDEX,
                                          IMAGE_TOKEN_INDEX)
from videoitg_tpu_torch.data.conversation import CHATML_SYSTEM
from videoitg_tpu_torch.data.tokenizer import tokenizer_image_token
from videoitg_tpu_torch.eval.adapters.downstream import FrameSelectionConsumer
from videoitg_tpu_torch.eval.api import register_adapter
from videoitg_tpu_torch.utils.common import call_with_data_root as _call_with_root

_TOOL = "videoitg-vlm adapter"
# Text segments are padded to multiples of this (masked pad slots), so the
# packed layout's positions, pad holes and cache slots are the JAX adapter's,
# where the bucketing bounds the number of compiled shapes.
TEXT_BUCKET = 32


def build_chatml_generation_ids(question: str, tokenizer,
                                system_message: str = CHATML_SYSTEM):
    """(pre_ids, post_ids) around <image> for a generation prompt:
    system turn + user turn (image-first content) + assistant start."""
    im_start, im_end = tokenizer.additional_special_tokens_ids[:2]
    nl = tokenizer("\n").input_ids

    prompt_ids = [im_start] + tokenizer("system\n").input_ids \
        + tokenizer(system_message).input_ids + [im_end] + nl \
        + [im_start] + tokenizer("user\n").input_ids \
        + tokenizer_image_token(DEFAULT_IMAGE_TOKEN + "\n" + question, tokenizer) \
        + [im_end] + nl \
        + [im_start] + tokenizer("assistant\n").input_ids
    k = prompt_ids.index(IMAGE_TOKEN_INDEX)
    return prompt_ids[:k], prompt_ids[k + 1:]


def _causal(base, **lm_fields):
    """The preset's causal LM config, built field by field as the JAX adapter
    builds it (the other GroundingConfig fields take their defaults)."""
    from videoitg_tpu_torch.config import GroundingConfig

    return GroundingConfig(vision=base.vision, projector=base.projector,
                           lm=dataclasses.replace(base.lm, causal=True, **lm_fields),
                           max_text_len=base.max_text_len)


def _bucket(n: int) -> int:
    return max(TEXT_BUCKET, -(-n // TEXT_BUCKET) * TEXT_BUCKET)


@register_adapter("videoitg-vlm")
class NativeVLMAdapter(FrameSelectionConsumer):
    def __init__(
        self,
        pretrained: Optional[str] = None,
        preset: str = "videoitg-8b",
        random_init: bool = False,
        max_new_tokens: int = 16,
        dtype: Optional[str] = None,
        hw: Optional[int] = None,
        quantize: Optional[str] = None,
        device: Optional[str] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        from videoitg_tpu_torch.cli._model_loading import adapter_device
        from videoitg_tpu_torch.config import preset as get_preset
        from videoitg_tpu_torch.ops.quant import Act8Switches
        from videoitg_tpu_torch.utils.common import CharTokenizer, resolve_dtype

        self.device = adapter_device(device, _TOOL)
        self.dtype = resolve_dtype(dtype, self.device)
        self.use_flash = self.device.type == "cuda"
        self.act8 = Act8Switches.from_env()
        self.max_new_tokens = max_new_tokens

        base = get_preset(preset)
        if pretrained:
            from transformers import AutoTokenizer

            from videoitg_tpu_torch.checkpoint import convert_vlm_checkpoint, load_hf_state_dict

            cfg = _causal(base)
            self.model = convert_vlm_checkpoint(load_hf_state_dict(pretrained), cfg,
                                                device=self.device, dtype=self.dtype)
            self.tokenizer = AutoTokenizer.from_pretrained(pretrained)
            self.eos_id = self.tokenizer.eos_token_id
        elif random_init:
            from videoitg_tpu_torch.models.grounding import init_grounding

            cfg = _causal(base, tie_word_embeddings=True)
            generator = torch.Generator(device=self.device).manual_seed(0)
            self.model = init_grounding(cfg, generator, device=self.device, dtype=self.dtype)
            self.tokenizer = CharTokenizer(cfg.lm.vocab_size)
            self.eos_id = 0
            print(f"[{_TOOL}] WARNING: random weights", file=sys.stderr)
        else:
            raise ValueError("pass pretrained=DIR or random_init=True")
        if quantize:
            # The same tiers as stage A (int8 / int4 / act8), in place.
            from videoitg_tpu_torch.ops.quant import apply_quantization_tier

            apply_quantization_tier(self.model, quantize)
        self.model.eval()
        self.cfg = cfg
        self.hw = hw

    def _packed_batch(self, frames, question: str, post_extra=(), post_labels=None):
        """(VLMBatch, hw) for the ChatML [pre | img | post] layout — the
        shared assembly for generation and loglikelihood requests.
        post_extra tokens append after the assistant header; post_labels
        (when given) aligns with the full post section. Both text segments
        are padded to TEXT_BUCKET multiples with masked slots."""
        from videoitg_tpu_torch.models.projector import inference_hw
        from videoitg_tpu_torch.models.vlm import VLMBatch
        from videoitg_tpu_torch.ops.preprocess import preprocess_frames

        dev = self.device
        t = frames.shape[0]
        hw = self.hw or inference_hw(self.cfg.projector, t,
                                     self.cfg.vision.num_patches_per_side)
        pix = preprocess_frames(torch.from_numpy(np.ascontiguousarray(frames)).to(dev),
                                out_size=self.cfg.vision.image_size, dtype=self.dtype)[None]
        pre, post_prompt = build_chatml_generation_ids(question, self.tokenizer)
        post_ids = post_prompt + list(post_extra)
        n_pre, n_post = len(pre), len(post_ids)
        pre_pad, post_pad = _bucket(n_pre) - n_pre, _bucket(n_post) - n_post

        def ids(row):
            return torch.tensor([row], dtype=torch.int32, device=dev)

        def mask(n, pad):
            return torch.tensor([[True] * n + [False] * pad], device=dev)

        batch = VLMBatch(
            frames=pix,
            frame_valid=torch.ones((1, t), dtype=torch.bool, device=dev),
            pre_ids=ids(pre + [0] * pre_pad),
            pre_valid=mask(n_pre, pre_pad),
            post_ids=ids(post_ids + [0] * post_pad),
            post_valid=mask(n_post, post_pad),
            post_labels=(None if post_labels is None else
                         ids([*([IGNORE_INDEX] * len(post_prompt)), *post_labels,
                              *([IGNORE_INDEX] * post_pad)])),
        )
        return batch, hw

    def loglikelihood(self, items, task, writer=None):
        """(loglikelihood, is_greedy) per doc for task.doc_to_target's
        continuation — the harness's third request type (reference
        lmms_eval/api/model.py:29-60). Teacher-forced through the same
        packed [pre | img | post] layout as generation; only the
        continuation tokens carry labels."""
        from videoitg_tpu_torch.models.vlm import vlm_loglikelihood

        assert task.doc_to_target is not None, (
            f"task {task.name} has output_type=loglikelihood but no doc_to_target")
        out = []
        for doc_id, doc in items:
            video_path = _call_with_root(task.doc_to_visual, doc, self.data_root)
            question = self.strip_inline_image_slots(
                task.doc_text(doc, self.data_root, self.model_name))
            cont = self.tokenizer(task.doc_to_target(doc)).input_ids
            window = task.visual_window(doc) if task.visual_window else None
            frames, _ids = self.frames_for_doc(doc_id, video_path, window=window)
            batch, hw = self._packed_batch(frames, question, post_extra=cont,
                                           post_labels=cont)
            ll, greedy = vlm_loglikelihood(self.model, batch, self.cfg, hw=hw,
                                           use_flash=self.use_flash, act8=self.act8)
            out.append((float(ll[0]), bool(greedy[0])))
        return out

    def answer(self, doc_id, doc, frames, frame_ids, question, task) -> str:
        from videoitg_tpu_torch.models.vlm import truncate_at_stop_sequences, vlm_generate

        # Task "until" strings stop generation LIVE inside the decode loop
        # (reference KeywordsStoppingCriteria) and are cut from the text.
        until = (task.generation_kwargs or {}).get("until") or []
        stops = tuple(
            tuple(self.tokenizer(u).input_ids) for u in until
            if self.tokenizer(u).input_ids)

        batch, hw = self._packed_batch(frames, question)
        out = vlm_generate(self.model, batch, self.cfg, hw=hw,
                           max_new_tokens=self.max_new_tokens,
                           eos_token_id=self.eos_id, use_flash=self.use_flash,
                           stop_sequences=stops, act8=self.act8)
        toks = truncate_at_stop_sequences(
            out, stop_sequences=[list(s) for s in stops], eos_token_id=self.eos_id)[0]
        return self.tokenizer.decode(toks, skip_special_tokens=True)
