"""Host-side batch assembly into a static-shape GroundingBatch.

Counterpart of videoitg_tpu/train/collate.py. A sample's `frames` are uint8
pixels [T, H, W, 3], which are preprocessed here (on `device`, where the
fp32 resize runs), or precomputed tower features [T, P, C]
(train/feature_cache.py), which are only padded and cast, or planar YUV420
frames (data.video.YUVFrames, half the host bytes), which are converted and
resized on `device`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models.grounding import GroundingBatch
from videoitg_tpu_torch.data.video import YUVFrames
from videoitg_tpu_torch.ops.preprocess import preprocess_frames, preprocess_frames_yuv
from videoitg_tpu_torch.train.dataset import GroundingSample


def collate_grounding(samples: Sequence[GroundingSample], t_bucket: int, cfg: GroundingConfig,
                      dtype: torch.dtype = torch.bfloat16, device=None) -> GroundingBatch:
    """Pad or truncate every sample to `t_bucket` frames and stack. Frames
    beyond a sample's own are zeros (black before normalisation) and marked
    invalid; text is right-padded to cfg.max_text_len."""
    b = len(samples)
    pix_list = []
    frame_valid = np.zeros((b, t_bucket), dtype=bool)
    labels = np.zeros((b, t_bucket), dtype=np.float32)
    ids = np.zeros((b, cfg.max_text_len), dtype=np.int32)
    text_valid = np.zeros((b, cfg.max_text_len), dtype=bool)

    def on_device(arr: np.ndarray, fill: int = 0) -> torch.Tensor:
        """Pad with `fill` frames, or truncate, to t_bucket and upload."""
        if arr.shape[0] < t_bucket:
            pad = np.full((t_bucket - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
            arr = np.concatenate([arr, pad], axis=0)
        return torch.from_numpy(np.ascontiguousarray(arr[:t_bucket])).to(device)

    for i, s in enumerate(samples):
        fr = s.frames
        t = min(fr.shape[0], t_bucket)
        if isinstance(fr, YUVFrames):
            # Black padding is y = 0 with NEUTRAL chroma 128 (zero chroma
            # would come out green).
            y, u, v = (on_device(p, fill) for p, fill in zip(fr, (0, 128, 128)))
            pix_list.append(preprocess_frames_yuv(y, u, v, out_size=cfg.vision.image_size,
                                                  dtype=dtype))
        elif fr.ndim == 3:  # tower features [T, P, C]: no preprocessing
            pix_list.append(on_device(fr).to(dtype))
        else:
            pix_list.append(preprocess_frames(on_device(fr), out_size=cfg.vision.image_size,
                                              dtype=dtype))
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
