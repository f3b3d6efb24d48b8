"""SigLIP image preprocessing: PIL-bicubic resize + rescale + normalize.

Counterpart of videoitg_tpu/ops/preprocess.py (the HF SiglipImageProcessor
semantics: PIL bicubic-antialias resize to 384x384, rescale by 1/255,
mean = std = 0.5), NHWC in and out. `preprocess_frames` takes decoded RGB
frames; `preprocess_frames_yuv` takes the decoder's native YUV420 planes
(half the host-to-device bytes) and converts them on the device first
(`yuv420_to_rgb`). All of it is plain tensor code, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from videoitg_tpu_torch.ops.resize import pil_resize_uint8

# SigLIP normalization (HF SiglipImageProcessor defaults).
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def _resize_normalize(x: torch.Tensor, out_size: int, dtype: torch.dtype) -> torch.Tensor:
    """fp32 RGB [T, H, W, 3] in [0, 255] -> normalized [T, S, S, 3] in `dtype`."""
    x = x.permute(0, 3, 1, 2)  # [T, C, H, W]
    x = pil_resize_uint8(x, out_size, out_size, filter="bicubic")
    x = x.permute(0, 2, 3, 1)  # [T, S, S, C]
    mean = torch.tensor(SIGLIP_MEAN, device=x.device) * 255.0
    std = torch.tensor(SIGLIP_STD, device=x.device) * 255.0
    return ((x - mean) / std).to(dtype)


def preprocess_frames(frames: torch.Tensor, out_size: int = 384,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> normalized [T, out_size, out_size, 3] in `dtype`;
    the resize runs in fp32 on the tensor's device."""
    return _resize_normalize(frames.float(), out_size, dtype)


def upsample_weights(in_size: int, out_size: int) -> np.ndarray:
    """float32 [out_size, in_size] bilinear weights for an enlargement, built
    as `jax.image.resize(method="bilinear")` builds them, in float32 at every
    step: sample positions (i + 0.5) / scale - 0.5 with scale = out / in and
    its inverse rounded to float32, the triangle kernel of the distance to
    each input pixel, each column divided by its sum (which clamps the
    edges). float64 weights put the samples of a factor other than 2 a few
    ulps elsewhere, enough to move a rounded RGB value by 1 level."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - dist)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32).T


def _upsample_bilinear(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """fp32 [T, h_in, w_in] -> [T, h, w], bilinear with half-pixel centres and
    clamped edges: what `jax.image.resize(method="bilinear")` computes when it
    enlarges (its antialiasing only acts on a reduction), with its float32
    weights. The factor need not be 2: an odd luma size has a chroma plane of
    (size + 1) // 2."""
    mh = torch.from_numpy(upsample_weights(plane.shape[1], h)).to(plane.device)
    mw = torch.from_numpy(upsample_weights(plane.shape[2], w)).to(plane.device)
    x = torch.einsum("oh,thw->tow", mh, plane)
    return torch.einsum("pw,tow->top", mw, x)


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Limited-range BT.601 YUV420 planes (uint8 y [T, H, W], u / v
    [T, (H+1)//2, (W+1)//2]) -> fp32 RGB [T, H, W, 3] of integral values in
    [0, 255]: chroma upsampled bilinearly to the luma size, the 3x3 colourspace
    affine, clip, and a round to integers, because the RGB path feeds
    uint8-quantised pixels into the resize."""
    _, h, w = y.shape
    yf = 1.164383 * (y.float() - 16.0)
    uf = _upsample_bilinear(u.float(), h, w) - 128.0
    vf = _upsample_bilinear(v.float(), h, w) - 128.0
    r = yf + 1.596027 * vf
    g = yf - 0.391762 * uf - 0.812968 * vf
    b = yf + 2.017232 * uf
    return torch.round(torch.stack([r, g, b], dim=-1).clamp_(0.0, 255.0))


def preprocess_frames_yuv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          out_size: int = 384,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """YUV420 uint8 planes -> normalized [T, out_size, out_size, 3] in `dtype`:
    the same result as `preprocess_frames` on the RGB-decoded pixels within
    colourspace rounding, from half the bytes."""
    return _resize_normalize(yuv420_to_rgb(y, u, v), out_size, dtype)
