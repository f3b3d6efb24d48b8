"""Downstream (stage B) adapters: answer questions on ITG-selected frames.

The plug-and-play contract (reference internvl2.py:105-132, qwen3_vl.py:
187-241, eagle2_5.py:100-128): given frame_indices_jsonl from stage A,
build doc_id -> index[] map, take the FIRST num_frame entries (they are
score-descending), sort ascending, decode exactly those frames; fall back
to uniform sampling when a doc is missing.

`FrameSelectionConsumer` implements that protocol once; concrete adapters
plug in an answer function:
  * internvl-chat — InternVL-style trust_remote_code checkpoints
    (InternVL2.5/3.5, Eagle2.5): AutoModel + model.chat(tokenizer,
    pixel_values, "FrameN: <image>" prompt, num_patches_list), tile
    preprocessing, bf16 (reference internvl2.py:330-395).
  * qwen-vl-chat  — processor-based chat-template checkpoints (Qwen2/3-VL,
    LLaVA-Video): video message content + per-video metadata (fps, frame
    timestamps) fed to the processor (reference qwen3_vl.py:187-241,400-470).
  * hf-video-llm  — auto-dispatch between the two by checkpoint config.
  * echo-answer   — deterministic stub for harness tests / dry runs.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from videoitg_tpu_torch.eval.api import ModelAdapter, Task, register_adapter
from videoitg_tpu_torch.utils.common import call_with_data_root as _call_with_root


def load_frame_indices(jsonl_path: str) -> Dict[object, List[int]]:
    """doc_id -> score-descending frame index list (reference
    internvl2.py:204-234)."""
    mapping: Dict[object, List[int]] = {}
    with open(jsonl_path) as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                mapping[row["doc_id"]] = row["index"]
    return mapping


def select_frame_ids(
    indices_map: Dict[object, List[int]],
    doc_id,
    num_frames: int,
    total_frames: int,
    dedupe: bool = False,
) -> List[int]:
    """First num_frames entries -> validate -> ascending sort; uniform
    fallback for missing docs (internvl2.py:114-123). dedupe=True drops
    duplicate ids before sorting — the llava_onevision variant of the
    protocol (llava_onevision.py:420-433); internvl/qwen keep duplicates."""
    if doc_id in indices_map:
        picked = [i for i in indices_map[doc_id][:num_frames] if 0 <= i < total_frames]
        if dedupe:
            picked = sorted(set(picked))
        if picked:
            return sorted(picked)
    if total_frames <= 0:
        return []
    return np.linspace(0, total_frames - 1, min(num_frames, total_frames),
                       dtype=int).tolist()


def _window_frame_span(window, fps, total_frames: int):
    """Clamp a Task.visual_window hint to valid frame ids.

    window is (center, width) in seconds or (center, width, "frame");
    returns inclusive (lo, hi) frame ids, or None when the window is
    empty/degenerate (callers then fall back to whole-video sampling)."""
    center, width = float(window[0]), float(window[1])
    unit = window[2] if len(window) > 2 else "s"
    if unit != "frame":
        scale = fps or 1.0
        center, width = center * scale, width * scale
    lo = max(0, int(round(center - width / 2)))
    hi = min(total_frames - 1, int(round(center + width / 2)))
    return (lo, hi) if hi >= lo else None


class FrameSelectionConsumer(ModelAdapter):
    """Base class implementing the selection-consumption protocol."""

    def __init__(
        self,
        frame_indices_jsonl: Optional[str] = None,
        num_frame: int = 32,
        data_root: str = "",
        dedupe: bool = False,
        sampling: str = "uniform",
        fps: Optional[float] = None,
        min_frames: Optional[int] = None,
        max_frames: Optional[int] = None,
        **_ignored,
    ):
        self.indices_map = (
            load_frame_indices(frame_indices_jsonl) if frame_indices_jsonl else {}
        )
        self.num_frame = num_frame
        self.data_root = data_root
        self.dedupe = dedupe
        if sampling not in ("uniform", "qwen_fps"):
            raise ValueError(f"unknown sampling mode {sampling!r}")
        # "qwen_fps": frame count follows the Qwen-VL protocol — clip
        # duration x target fps, FRAME_FACTOR-rounded and clamped
        # (eagle/vision_utils.py smart_nframes, used by its fetch_video);
        # model_args: sampling=qwen_fps,fps=2,min_frames=4,max_frames=768.
        self.sampling = sampling
        self.fps = fps
        self.min_frames = min_frames
        self.max_frames = max_frames

    IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp", ".gif")

    def frames_for_doc(self, doc_id, video_path: str, window=None):
        """window: optional temporal focus from Task.visual_window —
        (center, width) in seconds or (center, width, "frame") — uniform
        sampling is clamped to that span (breakpoint-mode tasks). Stage-A
        ITG selections take precedence: they were scored over the whole
        video, so a doc present in indices_map ignores the window.

        A still image (by extension) loads as one RGB frame via PIL —
        image tasks (mme) share the video path end to end; frame-count
        and selection settings don't apply (the reference's image tasks
        hand the model a PIL list the same way, mme/utils.py:37-38).
        A LIST of image paths (multi-image docs, e.g. seedbench's video
        data_type, seedbench/utils.py:4-5) loads each still; mixed sizes
        are resized to the first image's size so the stack is a uniform
        [N,H,W,3] (the model-side preprocess resizes again anyway —
        divergence from the reference's raw PIL list is bounded to that
        intermediate resample and only occurs for heterogeneous docs)."""
        if video_path is None or video_path == "" or video_path == []:
            # Text-only docs (mathverse text_only split: doc_to_visual
            # returns [] when the image field is blank, mathverse/
            # utils.py:26-29). Zero frames; chat adapters then build an
            # image-free prompt.
            self.last_metadata = {
                "fps": 0.0, "frames_indices": [], "total_num_frames": 0,
                "video_backend": "none",
            }
            return np.zeros((0, 2, 2, 3), dtype=np.uint8), []
        if hasattr(video_path, "convert"):  # in-memory PIL image
            # Tasks that BUILD their visual (mmvetv2_group_img's labeled
            # composite, mmvetv2/utils.py:141-147) return a PIL.Image
            # directly instead of round-tripping through a temp file.
            frame = np.asarray(video_path.convert("RGB"), dtype=np.uint8)
            self.last_metadata = {
                "fps": 0.0, "frames_indices": [0], "total_num_frames": 1,
                "video_backend": "pil",
            }
            return frame[None], [0]
        if isinstance(video_path, (list, tuple)):
            from PIL import Image

            stills = []
            for p in video_path:
                if hasattr(p, "convert"):  # caller-owned PIL image
                    im = p.convert("RGB")  # convert() returns a copy
                else:
                    with Image.open(p) as f:
                        im = f.convert("RGB")
                if stills and im.size != (stills[0].shape[1],
                                          stills[0].shape[0]):
                    im = im.resize((stills[0].shape[1],
                                    stills[0].shape[0]),
                                   Image.Resampling.BILINEAR)
                stills.append(np.asarray(im, dtype=np.uint8))
            n = len(stills)
            self.last_metadata = {
                "fps": 0.0, "frames_indices": list(range(n)),
                "total_num_frames": n, "video_backend": "pil",
            }
            return np.stack(stills), list(range(n))
        if str(video_path).lower().endswith(self.IMAGE_EXTS):
            from PIL import Image

            with Image.open(video_path) as im:
                frame = np.asarray(im.convert("RGB"), dtype=np.uint8)
            self.last_metadata = {
                "fps": 0.0, "frames_indices": [0], "total_num_frames": 1,
                "video_backend": "pil",
            }
            return frame[None], [0]
        from videoitg_tpu_torch.data.video import VideoReader

        with VideoReader(video_path) as vr:
            total = len(vr)
            span = (_window_frame_span(window, vr.fps, total)
                    if window is not None and doc_id not in self.indices_map
                    else None)
            if span is not None:
                lo, hi = span
                ids = np.linspace(lo, hi, min(self.num_frame, hi - lo + 1),
                                  dtype=int).tolist()
            else:
                n = self.num_frame
                if self.sampling == "qwen_fps" and doc_id not in self.indices_map:
                    from videoitg_tpu_torch.data.qwen_sizing import (
                        FRAME_FACTOR, smart_nframes,
                    )

                    n = (total if total < FRAME_FACTOR else
                         smart_nframes(total, vr.fps, fps=self.fps,
                                       min_frames=self.min_frames,
                                       max_frames=self.max_frames))
                ids = select_frame_ids(self.indices_map, doc_id,
                                       n, total, dedupe=self.dedupe)
            frames = vr.get_batch(ids)
            # Video metadata for processor-based downstreams (the reference
            # builds the same dict, qwen3_vl.py:234-241).
            self.last_metadata = {
                "fps": vr.fps,
                "frames_indices": list(ids),
                "total_num_frames": total,
                "video_backend": "libav",
            }
        return frames, ids

    def answer(self, doc_id, doc, frames: np.ndarray, frame_ids: Sequence[int],
               question: str, task: Task) -> str:
        raise NotImplementedError

    @staticmethod
    def strip_inline_image_slots(question: str) -> str:
        """Interleaved-prompt tasks (longvideobench_val_i) embed one
        '<image>' slot per UNIFORM frame inside doc_to_text. These adapters
        place their own image tokens for the ITG-SELECTED frames, so the
        inline slots must be dropped (subtitle lines keep their order) or
        the image-token count would exceed the frame count and real
        chat/processor APIs would reject or mis-render the prompt."""
        return question.replace("<image>\n", "").replace("<image>", "")

    def generate_until(self, items: List[tuple], task: Task, writer=None) -> List[str]:
        responses = []
        for doc_id, doc in items:
            video_path = _call_with_root(task.doc_to_visual, doc, self.data_root)
            question = task.doc_text(doc, self.data_root, self.model_name)
            window = task.visual_window(doc) if task.visual_window else None
            frames, ids = self.frames_for_doc(doc_id, video_path, window=window)
            responses.append(self.answer(doc_id, doc, frames, ids, question, task))
        return responses


@register_adapter("echo-answer")
class EchoAnswerAdapter(FrameSelectionConsumer):
    """Deterministic stub: reports which frames it received. Used by tests
    and to validate stage plumbing without a downstream checkpoint."""

    def __init__(self, answer_letter: str = "A", **kwargs):
        super().__init__(**kwargs)
        self.answer_letter = answer_letter

    def answer(self, doc_id, doc, frames, frame_ids, question, task) -> str:
        return f"{self.answer_letter} (frames={list(frame_ids)})"


def _torch_dtype(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[name]


@register_adapter("internvl-chat")
class InternVLChatAdapter(FrameSelectionConsumer):
    """InternVL-style downstream (InternVL2.5/3.5, Eagle2.5 checkpoints).

    Protocol (reference internvl2.py:330-395): dynamic-tile preprocess per
    frame, prompt "Frame{i}: <image>\\n" * T + question, and
    model.chat(tokenizer, pixel_values, question, gen_kwargs,
    num_patches_list=...). bf16 by default — an 8B checkpoint in fp32 would
    not serve (reference loads torch.bfloat16, internvl2.py:252).

    `device` (None = the card; a missing card is an error unless
    device="cpu") is where the model and its inputs go.
    """

    def __init__(self, pretrained: str = "", max_new_tokens: int = 16,
                 dtype: str = "bfloat16",
                 input_size: int = 448, use_fast: bool = False,
                 device: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        if not pretrained:
            raise ValueError("internvl-chat requires pretrained=<hf id or dir>")
        from videoitg_tpu_torch.cli._model_loading import adapter_device

        self.device = adapter_device(device, f"{self.model_name} adapter")
        import torch
        from transformers import AutoModel, AutoTokenizer

        self.torch = torch
        self.max_new_tokens = max_new_tokens
        self.torch_dtype = _torch_dtype(dtype)
        self.input_size = input_size
        # The InternVL family ships slow tokenizers (reference internvl2.py
        # loads use_fast=False); fixtures may be fast-only.
        self.tokenizer = AutoTokenizer.from_pretrained(
            pretrained, trust_remote_code=True, use_fast=use_fast)
        self.model = AutoModel.from_pretrained(
            pretrained, trust_remote_code=True,
            torch_dtype=self.torch_dtype, low_cpu_mem_usage=True).eval().to(self.device)

    def answer(self, doc_id, doc, frames, frame_ids, question, task) -> str:
        torch = self.torch
        from videoitg_tpu_torch.eval.adapters.internvl_preprocess import (
            video_frames_to_pixel_values,
        )

        question = self.strip_inline_image_slots(question)
        pixel_values, num_patches_list = video_frames_to_pixel_values(
            frames, input_size=self.input_size)
        pixel_values = pixel_values.to(self.device, self.torch_dtype)
        prefix = "".join(f"Frame{i + 1}: <image>\n"
                         for i in range(len(num_patches_list)))
        with torch.no_grad():
            out = self.model.chat(
                self.tokenizer, pixel_values, prefix + question,
                dict(max_new_tokens=self.max_new_tokens, do_sample=False),
                num_patches_list=num_patches_list,
            )
        return out if isinstance(out, str) else out[0]


@register_adapter("qwen-vl-chat")
class QwenVLChatAdapter(FrameSelectionConsumer):
    """Processor-based downstream (Qwen2/3-VL, LLaVA-Video checkpoints).

    Protocol (reference qwen3_vl.py:400-470): a chat-template message whose
    content is one video (the selected frames) + the question; the processor
    receives the frames and per-video metadata (fps, frame indices) so
    models with temporal position encodings see real timestamps.

    `device` (None = the card; a missing card is an error unless
    device="cpu") is where the model and its inputs go.
    """

    def __init__(self, pretrained: str = "", max_new_tokens: int = 16,
                 dtype: str = "bfloat16", device: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        if not pretrained:
            raise ValueError("qwen-vl-chat requires pretrained=<hf id or dir>")
        from videoitg_tpu_torch.cli._model_loading import adapter_device

        self.device = adapter_device(device, f"{self.model_name} adapter")
        import torch
        from transformers import AutoProcessor

        self.torch = torch
        self.max_new_tokens = max_new_tokens
        self.torch_dtype = _torch_dtype(dtype)
        self.processor = AutoProcessor.from_pretrained(
            pretrained, trust_remote_code=True)
        self.model = self._load_model(pretrained).to(self.device)
        # Real Qwen2/3-VL processors take video_metadata through **kwargs
        # (no named parameter to introspect) — attempt the call with
        # metadata and fall back once on rejection (cached).
        self._accepts_metadata: Optional[bool] = None

    def _load_model(self, pretrained: str):
        from transformers import AutoModelForCausalLM, AutoModelForVision2Seq

        try:
            m = AutoModelForVision2Seq.from_pretrained(
                pretrained, trust_remote_code=True,
                torch_dtype=self.torch_dtype, low_cpu_mem_usage=True)
        except Exception:
            m = AutoModelForCausalLM.from_pretrained(
                pretrained, trust_remote_code=True,
                torch_dtype=self.torch_dtype, low_cpu_mem_usage=True)
        return m.eval()

    def answer(self, doc_id, doc, frames, frame_ids, question, task) -> str:
        torch = self.torch
        question = self.strip_inline_image_slots(question)
        has_video_proc = getattr(self.processor, "video_processor", None) is not None
        if has_video_proc:
            content = [{"type": "video"}, {"type": "text", "text": question}]
        else:
            # Image-sequence fallback (LLaVA-style processors; also the only
            # video path in environments without HF's torchvision-backed
            # video processors) — one image slot per selected frame.
            content = ([{"type": "image"} for _ in range(len(frames))]
                       + [{"type": "text", "text": question}])
        messages = [{"role": "user", "content": content}]
        prompt = self.processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        if has_video_proc:
            kwargs = dict(text=[prompt], videos=[frames], return_tensors="pt")
            meta = getattr(self, "last_metadata", None)
            if meta and self._accepts_metadata is not False:
                try:
                    inputs = self.processor(**kwargs, video_metadata=[meta])
                    self._accepts_metadata = True
                except TypeError:
                    self._accepts_metadata = False
                    inputs = self.processor(**kwargs)
            else:
                inputs = self.processor(**kwargs)
        else:
            from PIL import Image

            kwargs = dict(text=[prompt],
                          images=[Image.fromarray(f) for f in frames],
                          return_tensors="pt")
            inputs = self.processor(**kwargs)
        inputs = {k: (v.to(self.device, self.torch_dtype)
                      if v.dtype.is_floating_point else v.to(self.device))
                  if hasattr(v, "dtype") else v
                  for k, v in inputs.items()}
        with torch.no_grad():
            out = self.model.generate(**inputs, max_new_tokens=self.max_new_tokens,
                                      do_sample=False)
        return self.processor.batch_decode(
            out[:, inputs["input_ids"].shape[1]:], skip_special_tokens=True)[0]


@register_adapter("llava-ov-chat")
class LlavaOneVisionChatAdapter(QwenVLChatAdapter):
    """LLaVA-OneVision / LLaVA-Video downstream (the reference's
    llava_onevision wrapper, llava_onevision.py:66-124 — default checkpoint
    lmms-lab/LLaVA-Video-7B-Qwen2, the paper's LLaVA-Video-7B row).

    The HF-format LLaVA-OneVision checkpoints expose a processor, so the
    chat-template path of QwenVLChatAdapter applies; the family-specific
    protocol nuance is index DEDUPLICATION before the ascending sort
    (llava_onevision.py:420-433, `sorted(list(set(...)))`), which the
    internvl/qwen consumers do not do.
    """

    def __init__(self, pretrained: str = "lmms-lab/LLaVA-Video-7B-Qwen2",
                 **kwargs):
        kwargs.setdefault("dedupe", True)
        super().__init__(pretrained=pretrained, **kwargs)


@register_adapter("hf-video-llm")
def hf_video_llm(pretrained: str = "", **kwargs):
    """Auto-dispatch by checkpoint config: InternVL-style configs carry
    vision_config + llm_config and a chat() API; everything else goes
    through the processor branch (reference has one wrapper per family —
    internvl2/internvl3_5/qwen3_vl/eagle2_5 — with these two shapes)."""
    if not pretrained:
        raise ValueError("hf-video-llm requires pretrained=<hf id or dir>")
    from transformers import AutoConfig

    cfg = AutoConfig.from_pretrained(pretrained, trust_remote_code=True)
    if hasattr(cfg, "vision_config") and hasattr(cfg, "llm_config"):
        return InternVLChatAdapter(pretrained=pretrained, **kwargs)
    return QwenVLChatAdapter(pretrained=pretrained, **kwargs)

