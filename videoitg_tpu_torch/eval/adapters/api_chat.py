"""API-backed downstream adapter: OpenAI-compatible multimodal chat.

Covers the reference's API model family (lmms_eval/models/gpt4v.py,
gpt4o.py, claude.py, gemini_api.py — 4 wrappers, one protocol) with a
single provider-agnostic adapter that consumes stage-A frame selections:

* payload shape — gpt4v.py:166-200: one user message whose content
  interleaves text with ``data:image/...;base64,`` image_url parts; when
  the prompt has no ``<image>`` token the text comes first and all frames
  follow; ``model``/``max_tokens``/``temperature`` at top level,
  max_new_tokens defaulted to 1024 and clamped at 4096, temperature 0.
* frame encoding — gpt4v.py:100-131: frames resized to a square
  (512x512 default) and PNG-encoded before base64.
* retry contract — gpt4v.py:202-222: N attempts with a fixed sleep,
  empty string after the last failure (eval proceeds; the metric treats
  it as wrong).
* continual mode — gpt4v.py:66-82,226-230: optional persistent JSON
  response cache keyed per doc so an interrupted API sweep resumes
  without re-billing; cache writes are atomic here (tmp+rename) where
  the reference rewrites in place.

Unlike the reference (uniform frames re-decoded per wrapper), this
adapter inherits FrameSelectionConsumer: it answers over the ITG-selected
frames from stage A, or its uniform/qwen_fps fallback sampling.

Offline-tested against a local HTTP stub (tests/test_api_chat.py); a
connected deployment points it at any OpenAI-compatible endpoint
(api_url=... or $OPENAI_API_URL, key via $OPENAI_API_KEY).
"""

from __future__ import annotations

import base64
import io
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from videoitg_tpu_torch.eval.adapters.downstream import FrameSelectionConsumer
from videoitg_tpu_torch.eval.api import Task, register_adapter


def encode_frame(frame: np.ndarray, size: int = 512, fmt: str = "png") -> str:
    """uint8 HWC frame -> base64 of the (size x size)-resized PNG/JPEG
    (reference gpt4v.py:122-128)."""
    from PIL import Image

    img = Image.fromarray(np.asarray(frame, np.uint8))
    if size:
        img = img.resize((size, size))
    buf = io.BytesIO()
    img.save(buf, format=fmt.upper())
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def build_messages(question: str, frames_b64: Sequence[str],
                   fmt: str = "png") -> list:
    """The reference's single-request message layout (gpt4v.py:166-187).

    It emits ONE message per <image>-split chunk; functionally all parts
    belong to the same user turn, and OpenAI-compatible servers accept the
    interleaved single-message form every modern wrapper (qwen3_vl-style)
    uses — so we interleave within one user message, keeping chunk order:
    text[0], img[0], text[1], img[1], ..., text[-1]; with no <image> token
    the text leads and all frames follow.
    """
    def img_part(b64):
        return {"type": "image_url",
                "image_url": {"url": f"data:image/{fmt};base64,{b64}"}}

    content = []
    if "<image>" not in question:
        if question:
            content.append({"type": "text", "text": question})
        content.extend(img_part(b) for b in frames_b64)
    else:
        chunks = question.split("<image>")
        for i, b64 in enumerate(frames_b64):
            text = chunks[i] if i < len(chunks) else ""
            if text:
                content.append({"type": "text", "text": text})
            content.append(img_part(b64))
        if len(chunks) > len(frames_b64) and chunks[-1]:
            content.append({"type": "text", "text": chunks[-1]})
    return [{"role": "user", "content": content}]


@register_adapter("api-chat")
class ApiChatAdapter(FrameSelectionConsumer):
    """``--model api-chat --model_args model=gpt-4o,api_url=...``.

    model_args: ``model`` (served model id), ``api_url``/``api_key``
    (default $OPENAI_API_URL / $OPENAI_API_KEY), ``max_new_tokens`` (1024,
    clamped 4096 per gpt4v.py:188-191), ``temperature`` (0), ``timeout``
    (300 s), ``retries`` (5), ``retry_sleep`` (30 s, gpt4v.py:26),
    ``image_size`` (512, 0 keeps native), ``image_format`` (png),
    ``response_cache`` (path -> continual mode), plus the inherited
    selection args (frame_indices_jsonl, num_frame, ...).
    """

    def __init__(self, model: str = "gpt-4o",
                 api_url: Optional[str] = None,
                 api_key: Optional[str] = None,
                 max_new_tokens: int = 1024,
                 temperature: float = 0.0,
                 timeout: float = 300.0,
                 retries: int = 5,
                 retry_sleep: float = 30.0,
                 image_size: int = 512,
                 image_format: str = "png",
                 response_cache: Optional[str] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.model = model
        self.api_url = api_url or os.environ.get(
            "OPENAI_API_URL", "https://api.openai.com/v1/chat/completions")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.max_new_tokens = min(int(max_new_tokens), 4096)
        self.temperature = float(temperature)
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.retry_sleep = float(retry_sleep)
        self.image_size = int(image_size)
        self.image_format = image_format
        self.cache_path = response_cache
        self.cache = {}
        if response_cache and os.path.exists(response_cache):
            with open(response_cache) as f:
                self.cache = json.load(f)

    def _post(self, payload: dict) -> str:
        import urllib.request

        req = urllib.request.Request(
            self.api_url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        last_err = None
        for attempt in range(self.retries):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    data = json.load(r)
                return data["choices"][0]["message"]["content"].strip()
            except Exception as e:  # noqa: BLE001 — reference retries all
                last_err = e
                if attempt < self.retries - 1:
                    time.sleep(self.retry_sleep)
        # All attempts failed: empty response, eval continues
        # (gpt4v.py:219-222).
        import logging

        logging.getLogger(__name__).warning(
            "api-chat: all %d attempts failed (%s)", self.retries, last_err)
        return ""

    def answer(self, doc_id, doc, frames: np.ndarray,
               frame_ids: Sequence[int], question: str, task: Task) -> str:
        key = f"{task.name}___{doc_id}"
        if key in self.cache:
            return self.cache[key]
        b64s = [encode_frame(f, self.image_size, self.image_format)
                for f in frames]
        if question.count("<image>") != len(b64s):
            # Inline slots (longvideobench_val_i) are one per UNIFORM
            # frame; when they don't match the ITG-selected frame count,
            # interleaving would mis-place images — family policy
            # (downstream.strip_inline_image_slots): drop the slots and
            # send all frames after the text.
            question = self.strip_inline_image_slots(question)
        payload = {
            "model": self.model,
            "messages": build_messages(question, b64s, self.image_format),
            "max_tokens": self.max_new_tokens,
            "temperature": self.temperature,
        }
        text = self._post(payload)
        if self.cache_path is not None:
            self.cache[key] = text
            tmp = self.cache_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.cache, f)
            os.replace(tmp, self.cache_path)
        return text
