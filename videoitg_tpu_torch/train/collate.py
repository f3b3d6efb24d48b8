"""Host-side batch assembly into a static-shape GroundingBatch.

Counterpart of videoitg_tpu/train/collate.py. A sample's `frames` are uint8
pixels [T, H, W, 3], which are preprocessed here (on `device`, where the
fp32 resize runs), or precomputed tower features [T, P, C]
(train/feature_cache.py), which are only padded and cast. Planar YUV420
frames are not ported (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models.grounding import GroundingBatch
from videoitg_tpu_torch.ops.preprocess import preprocess_frames
from videoitg_tpu_torch.train.dataset import GroundingSample


def collate_grounding(samples: Sequence[GroundingSample], t_bucket: int, cfg: GroundingConfig,
                      dtype: torch.dtype = torch.bfloat16, device=None) -> GroundingBatch:
    """Pad or truncate every sample to `t_bucket` frames and stack. Frames
    beyond a sample's own are zeros (black before normalisation) and marked
    invalid; text is right-padded to cfg.max_text_len."""
    from videoitg_tpu_torch.data.video import YUVFrames

    b = len(samples)
    pix_list = []
    frame_valid = np.zeros((b, t_bucket), dtype=bool)
    labels = np.zeros((b, t_bucket), dtype=np.float32)
    ids = np.zeros((b, cfg.max_text_len), dtype=np.int32)
    text_valid = np.zeros((b, cfg.max_text_len), dtype=bool)

    for i, s in enumerate(samples):
        fr = s.frames
        if isinstance(fr, YUVFrames):
            raise NotImplementedError(
                "collate_grounding: yuv420 frames are not ported yet (ROADMAP queue 1)")
        t = fr.shape[0]
        if t < t_bucket:
            fr = np.concatenate(
                [fr, np.zeros((t_bucket - t,) + fr.shape[1:], dtype=fr.dtype)], axis=0)
        elif t > t_bucket:
            fr, t = fr[:t_bucket], t_bucket
        x = torch.from_numpy(np.ascontiguousarray(fr)).to(device)
        if x.dim() == 3:  # tower features [T, P, C]: no preprocessing
            pix_list.append(x.to(dtype))
        else:
            pix_list.append(preprocess_frames(x, out_size=cfg.vision.image_size, dtype=dtype))
        frame_valid[i, :t] = True
        labels[i, :t] = s.labels[:t]
        n = len(s.text_ids)
        ids[i, :n] = s.text_ids
        text_valid[i, :n] = True

    return GroundingBatch(
        frames=torch.stack(pix_list),
        frame_valid=torch.from_numpy(frame_valid).to(device),
        text_ids=torch.from_numpy(ids).to(device),
        text_valid=torch.from_numpy(text_valid).to(device),
        labels=torch.from_numpy(labels).to(device),
    )
