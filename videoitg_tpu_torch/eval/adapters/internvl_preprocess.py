"""InternVL-style dynamic tile preprocessing for downstream frames.

Parity: lmms_eval/models/internvl2.py:54-103 — each frame is resized into
aspect-ratio-matched 448x448 tiles (max_num=1 for video frames, i.e. one
tile per frame), normalized with ImageNet statistics.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def video_frames_to_pixel_values(frames: np.ndarray, input_size: int = 448):
    """[T, H, W, 3] uint8 -> (torch float tensor [T, 3, S, S], patch list)."""
    import torch
    from PIL import Image

    tiles = []
    for frame in frames:
        img = Image.fromarray(frame).convert("RGB").resize(
            (input_size, input_size), Image.BICUBIC)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        arr = (arr - np.asarray(IMAGENET_MEAN, dtype=np.float32)) / np.asarray(
            IMAGENET_STD, dtype=np.float32)
        tiles.append(torch.from_numpy(arr.transpose(2, 0, 1)))
    pixel_values = torch.stack(tiles)
    num_patches_list = [1] * len(tiles)
    return pixel_values, num_patches_list
