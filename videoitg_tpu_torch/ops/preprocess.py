"""SigLIP image preprocessing: PIL-bicubic resize + rescale + normalize.

Counterpart of `preprocess_frames` in videoitg_tpu/ops/preprocess.py (the HF
SiglipImageProcessor semantics: PIL bicubic-antialias resize to 384x384,
rescale by 1/255, mean = std = 0.5), NHWC in and out. The YUV420 transfer
(`yuv420_to_rgb`, `preprocess_frames_yuv`) waits (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from videoitg_tpu_torch.ops.resize import pil_resize_uint8

# SigLIP normalization (HF SiglipImageProcessor defaults).
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def preprocess_frames(frames: torch.Tensor, out_size: int = 384,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> normalized [T, out_size, out_size, 3] in `dtype`;
    the resize runs in fp32 on the tensor's device."""
    x = frames.float().permute(0, 3, 1, 2)  # [T, C, H, W]
    x = pil_resize_uint8(x, out_size, out_size, filter="bicubic")
    x = x.permute(0, 2, 3, 1)  # [T, S, S, C]
    mean = torch.tensor(SIGLIP_MEAN, device=x.device) * 255.0
    std = torch.tensor(SIGLIP_STD, device=x.device) * 255.0
    return ((x - mean) / std).to(dtype)
