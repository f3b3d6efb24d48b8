"""VLM SFT / pretrain pipeline.

Counterpart of videoitg_tpu/train/vlm_sft.py. Where it differs from the
grounding pipeline: samples may be images or videos with multi-turn
conversations, the loss is next-token CE over assistant spans (ChatML) or
the caption (plain template, projector pretrain), and `fps == -1` draws the
rate per video from `FPS_CHOICES` (the reference's random-fps augmentation).

`make_vlm_train_step` is `train/train_step.step_from_loss` around the VLM
loss: the same `TrainState`, `GroupedAdamW` and `run_step` as the grounding
step, the update in place, and `grad_norm` over the leaves that train.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.constants import IGNORE_INDEX
from videoitg_tpu_torch.data.conversation import (
    preprocess_chatml,
    preprocess_plain,
    split_around_image,
)
from videoitg_tpu_torch.models.vlm import VLMBatch, vlm_loss
from videoitg_tpu_torch.ops.preprocess import preprocess_frames
from videoitg_tpu_torch.train.optimizer import GroupedAdamW
from videoitg_tpu_torch.train.train_step import step_from_loss

FPS_CHOICES = (0.5, 1, 2, 4, 8)


@dataclass
class VLMSample:
    frames: np.ndarray        # [T, H, W, 3] uint8 (T = 1 for images)
    pre_ids: List[int]
    post_ids: List[int]
    post_labels: List[int]


class VLMDataset:
    """JSON list of {"video" | "image": path, "conversations": [...]}."""

    def __init__(
        self,
        data_path: str,
        image_folder: str,
        tokenizer,
        cfg: GroundingConfig,
        template: str = "chatml",
        video_frames: int = 256,
        fps: float = 1.0,
        max_attempts: int = 10,
        seed: int = 0,
    ):
        with open(data_path) as f:
            self.records = json.load(f)
        self.image_folder = image_folder
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.template = template
        self.video_frames = video_frames
        self.fps = fps
        self.max_attempts = max_attempts
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.records)

    def _frames_for(self, rec) -> np.ndarray:
        if "video" in rec:
            from videoitg_tpu_torch.data.video import read_video_frames

            fps = self.fps
            if fps == -1:  # the random-fps augmentation
                fps = self.rng.choice(FPS_CHOICES)
            frames, _ = read_video_frames(
                os.path.join(self.image_folder, rec["video"]),
                num_frames=self.video_frames, target_fps=fps, sampling="infer",
            )
            return frames
        from PIL import Image

        img = Image.open(os.path.join(self.image_folder, rec["image"])).convert("RGB")
        return np.asarray(img, dtype=np.uint8)[None]

    def _load_one(self, i: int) -> VLMSample:
        rec = self.records[i]
        frames = self._frames_for(rec)
        convs = rec["conversations"]
        if self.template == "plain":
            ids, labels = preprocess_plain(convs, self.tokenizer)
        else:
            ids, labels = preprocess_chatml(convs, self.tokenizer)
        packed = split_around_image(ids, labels)
        return VLMSample(frames, packed.pre_ids, packed.post_ids, packed.post_labels)

    def __getitem__(self, i: int) -> VLMSample:
        for attempt in range(self.max_attempts):
            try:
                return self._load_one(i)
            except Exception as e:  # decode failure -> random resample
                print(f"[vlm dataset] error on sample {i} (attempt {attempt + 1}): {e}")
                i = self.rng.randint(0, len(self.records) - 1)
        raise RuntimeError("exceeded max retries")


def collate_vlm(
    samples: Sequence[VLMSample],
    t_bucket: int,
    cfg: GroundingConfig,
    max_pre: int = 64,
    max_post: int = 512,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> VLMBatch:
    """Pad or truncate every sample to `t_bucket` frames, `max_pre` and
    `max_post` tokens, and stack. Frames are preprocessed on `device`."""
    b = len(samples)
    pix = []
    frame_valid = np.zeros((b, t_bucket), dtype=bool)
    pre = np.zeros((b, max_pre), dtype=np.int32)
    pre_valid = np.zeros((b, max_pre), dtype=bool)
    post = np.zeros((b, max_post), dtype=np.int32)
    post_valid = np.zeros((b, max_post), dtype=bool)
    post_labels = np.full((b, max_post), IGNORE_INDEX, dtype=np.int32)

    for i, s in enumerate(samples):
        fr = s.frames
        t = min(fr.shape[0], t_bucket)
        if fr.shape[0] < t_bucket:
            fr = np.concatenate(
                [fr, np.zeros((t_bucket - fr.shape[0],) + fr.shape[1:], dtype=fr.dtype)],
                axis=0,
            )
        fr = torch.from_numpy(np.ascontiguousarray(fr[:t_bucket])).to(device)
        pix.append(preprocess_frames(fr, out_size=cfg.vision.image_size, dtype=dtype))
        frame_valid[i, :t] = True
        n_pre, n_post = min(len(s.pre_ids), max_pre), min(len(s.post_ids), max_post)
        pre[i, :n_pre] = s.pre_ids[:n_pre]
        pre_valid[i, :n_pre] = True
        post[i, :n_post] = s.post_ids[:n_post]
        post_valid[i, :n_post] = True
        post_labels[i, :n_post] = s.post_labels[:n_post]

    def up(arr):
        return torch.from_numpy(arr).to(device)

    return VLMBatch(
        frames=torch.stack(pix),
        frame_valid=up(frame_valid),
        pre_ids=up(pre), pre_valid=up(pre_valid),
        post_ids=up(post), post_valid=up(post_valid),
        post_labels=up(post_labels),
    )


def make_vlm_train_step(cfg: GroundingConfig, tx: GroupedAdamW, hw: int, use_flash=False,
                        remat: bool = True, freeze_vision: bool = True, donate: bool = False):
    """Returns (state, batch) -> (state, metrics) for the SFT objective, with
    metrics `loss`, `num_label_tokens`, `grad_norm` (0-d tensors; `grad_norm`
    over the leaves that train). `use_flash=True` runs the differentiable
    native-GQA kernels, `"train-jax"` the segment-id arm. The step uses the
    optimizer its state carries; `donate` is accepted for the JAX signature's
    sake and does nothing, since the update is in place either way."""
    del tx, donate
    return step_from_loss(lambda model, batch: vlm_loss(
        model, batch, cfg, hw=hw, use_flash=use_flash, remat=remat,
        freeze_vision=freeze_vision))
